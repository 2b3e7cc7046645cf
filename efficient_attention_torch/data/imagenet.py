"""Image data for the ViT CLI: the synthetic dataset and a batch iterator.

Counterpart of ``efficient_attention_tpu/data/imagenet.py``.  The synthetic
dataset gives the same image for the same index as the JAX one
(``data/imagenet.py:198-215``).  Real ImageNet/CIFAR loading, augmentation
and the prefetching loader are ROADMAP.md Queue 1, item 3.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np


class SyntheticImageDataset:
    """Deterministic random images (fairseq ``benchmark/dummy_*`` analogue)."""

    def __init__(self, num_samples: int = 1280, img_size: int = 224,
                 num_classes: int = 1000, train: bool = True):
        self.num_samples = num_samples
        self.img_size = img_size
        self.num_classes = num_classes
        self.classes = [str(i) for i in range(num_classes)]

    def __len__(self):
        return self.num_samples

    def load(self, idx: int) -> Tuple[np.ndarray, int]:
        r = np.random.default_rng(idx)
        img = r.standard_normal(
            (self.img_size, self.img_size, 3)).astype(np.float32)
        return img, int(idx % self.num_classes)


def batch_iterator(dataset, batch_size: int, indices: Sequence[int]
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Whole batches ``(images [b, H, W, 3] float32, labels [b] int64)``
    over ``indices`` in order; a last partial batch is dropped."""
    stop = len(indices) - len(indices) % batch_size
    for start in range(0, stop, batch_size):
        items = [dataset.load(int(i)) for i in indices[start:start + batch_size]]
        yield (np.stack([img for img, _ in items]),
               np.asarray([label for _, label in items], np.int64))

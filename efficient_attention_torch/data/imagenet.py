"""Image data for the ViT CLI: the synthetic dataset, the epoch sampler and
a batch iterator.

Counterpart of ``efficient_attention_tpu/data/imagenet.py``.  The synthetic
dataset gives the same image for the same index as the JAX one
(``data/imagenet.py:198-215``), for training and eval alike; the CLI sizes it
as JAX ``build_dataset`` does (16 batches to train on, 4 to score).  Real
ImageNet/CIFAR loading, augmentation, the RASampler and the prefetching
loader are ROADMAP.md Queue 1, item 3.
"""
from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
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


def shard_indices(n: int, epoch: int, seed: int = 0, num_replicas: int = 1,
                  rank: int = 0, shuffle: bool = True) -> np.ndarray:
    """One epoch's sample order for replica ``rank`` (torch
    ``DistributedSampler``; JAX ``data/imagenet.py:238-245``): a permutation
    seeded by ``seed + epoch``, padded to a multiple of the replicas."""
    rng = np.random.default_rng(seed + epoch)
    order = rng.permutation(n) if shuffle else np.arange(n)
    total = int(math.ceil(n / num_replicas)) * num_replicas
    order = np.concatenate([order, order[: total - n]])
    return order[rank::num_replicas]


def batch_iterator(dataset, batch_size: int, indices: Sequence[int],
                   num_threads: int = 0
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Whole batches ``(images [b, H, W, 3] float32, labels [b] int64)``
    over ``indices`` in order; a last partial batch is dropped.  With
    ``num_threads > 0`` the samples of a batch load on that many threads."""
    stop = len(indices) - len(indices) % batch_size
    pool = ThreadPoolExecutor(num_threads) if num_threads > 0 else None
    try:
        for start in range(0, stop, batch_size):
            idx = [int(i) for i in indices[start:start + batch_size]]
            items = (list(pool.map(dataset.load, idx)) if pool is not None
                     else [dataset.load(i) for i in idx])
            yield (np.stack([img for img, _ in items]),
                   np.asarray([label for _, label in items], np.int64))
    finally:
        if pool is not None:
            pool.shutdown()

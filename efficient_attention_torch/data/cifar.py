"""CIFAR-10 and CIFAR-100 from their python-pickle archives.

Counterpart of ``efficient_attention_tpu/data/cifar.py`` (reference
``vit/datasets.py:31-44``), no torchvision: ``cifar-10-batches-py/`` or
``cifar-100-python/`` under the data path.  Training at 32 px takes
RandomCrop(32, padding=4) and a flip (larger inputs are bicubic-resized
instead of cropped), then the optional augment; both splits are normalised
with the CIFAR statistics (``vit/constants.py:11-13``).  With the same
``np.random.Generator`` ``load`` returns the JAX package's array bit for
bit.
"""
from __future__ import annotations

import os
import pickle
from typing import List, Tuple

import numpy as np

from efficient_attention_torch.data.imagenet import _normalize

CIFAR_DEFAULT_MEAN = np.array([0.5071, 0.4867, 0.4408], np.float32)
CIFAR_DEFAULT_STD = np.array([0.2675, 0.2565, 0.2761], np.float32)


def _load_pickle(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


class CIFARDataset:
    """CIFAR-10 or CIFAR-100 (``num_classes``) with the reference's train
    and eval transforms; ``load(idx, rng) -> (array [S, S, 3], label)`` as
    the image folder's."""

    def __init__(self, root: str, num_classes: int = 10,
                 img_size: int = 32, train: bool = True, augment=None):
        self.img_size = img_size
        self.train = train
        self.augment = augment  # optional fn(PIL.Image, rng) -> PIL.Image
        if num_classes == 10:
            base = os.path.join(root, "cifar-10-batches-py")
            files = ([f"data_batch_{i}" for i in range(1, 6)] if train
                     else ["test_batch"])
            label_key = b"labels"
        elif num_classes == 100:
            base = os.path.join(root, "cifar-100-python")
            files = ["train" if train else "test"]
            label_key = b"fine_labels"
        else:
            raise ValueError(f"CIFAR num_classes must be 10/100, "
                             f"got {num_classes}")
        datas: List[np.ndarray] = []
        labels: List[int] = []
        for fname in files:
            d = _load_pickle(os.path.join(base, fname))
            datas.append(np.asarray(d[b"data"], np.uint8))
            labels.extend(int(x) for x in d[label_key])
        # [N, 3072] channel-major -> [N, 32, 32, 3]
        self.images = (np.concatenate(datas)
                       .reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        self.labels = np.asarray(labels, np.int64)
        self.classes = [str(i) for i in range(num_classes)]

    def __len__(self):
        return len(self.labels)

    def load(self, idx: int,
             rng: np.random.Generator) -> Tuple[np.ndarray, int]:
        from PIL import Image

        img = Image.fromarray(self.images[idx])
        s = self.img_size
        if self.train:
            if s == 32:  # RandomCrop(32, padding=4)
                arr = np.pad(np.asarray(img), ((4, 4), (4, 4), (0, 0)),
                             mode="constant")
                y0 = int(rng.integers(0, 9))
                x0 = int(rng.integers(0, 9))
                img = Image.fromarray(arr[y0:y0 + 32, x0:x0 + 32])
            else:
                img = img.resize((s, s), Image.BICUBIC)
            if rng.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if self.augment is not None:
                img = self.augment(img, rng)
        elif s != 32:
            img = img.resize((s, s), Image.BICUBIC)
        return _normalize(img, CIFAR_DEFAULT_MEAN, CIFAR_DEFAULT_STD), \
            int(self.labels[idx])

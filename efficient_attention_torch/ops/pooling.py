"""Adaptive average pooling as a fixed matrix product, and segment means.

PyTorch counterpart of ``efficient_attention_tpu/ops/pooling.py:20-64``.
``torch.nn.AdaptiveAvgPool2d`` semantics (segment ``i`` of an axis spans
``floor(i*H/o)`` to ``ceil((i+1)*H/o)``) written as one ``[o, H]`` averaging
matrix per axis, so the pool is two small products that give the JAX
package's numbers on any layout.  LARA's pooled landmark proposals
(``attention/lara.py``) take them.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


def adaptive_pool_matrix(in_size: int, out_size: int,
                         dtype=np.float32) -> np.ndarray:
    """``[out_size, in_size]`` row-stochastic averaging matrix."""
    mat = np.zeros((out_size, in_size), dtype=dtype)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = math.ceil((i + 1) * in_size / out_size)
        mat[i, start:end] = 1.0 / (end - start)
    return mat


@functools.lru_cache(maxsize=None)
def _pool_matrix(in_size: int, out_size: int, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """``adaptive_pool_matrix`` on ``device``, made once: a copy from host
    memory on every call would wait for the device each time."""
    return torch.from_numpy(adaptive_pool_matrix(in_size, out_size)).to(device, dtype)


def adaptive_avg_pool_2d(x: torch.Tensor, out_hw: int) -> torch.Tensor:
    """Adaptive 2-D average pool over the last two axes:
    ``[..., H, W] -> [..., o, o]``."""
    H, W = x.shape[-2], x.shape[-1]
    mh = _pool_matrix(H, out_hw, x.device, x.dtype)
    mw = _pool_matrix(W, out_hw, x.device, x.dtype)
    x = torch.einsum("oh,...hw->...ow", mh, x)
    return torch.einsum("pw,...ow->...op", mw, x)


def segment_mean_landmarks(x: torch.Tensor, landmarks: int) -> torch.Tensor:
    """1-D segment-mean landmarks, lengths that do not divide included
    (reference ``lara.py:104-127``): with ``segs = n // landmarks`` and
    ``num_k = (segs + 1) * landmarks - n``, the first ``num_k`` landmarks
    average ``segs`` tokens and the rest ``segs + 1``.

    ``x [b, h, n, d] -> [b, h, landmarks, d]`` (``x`` itself when
    ``n <= landmarks``)."""
    b, h, n, d = x.shape
    if n <= landmarks:
        return x
    if n % landmarks == 0:
        return x.reshape(b, h, landmarks, n // landmarks, d).mean(dim=-2)
    segs = n // landmarks
    num_k = (segs + 1) * landmarks - n
    first = x[:, :, :num_k * segs].reshape(b, h, num_k, segs, d).mean(dim=-2)
    last = x[:, :, num_k * segs:].reshape(
        b, h, landmarks - num_k, segs + 1, d).mean(dim=-2)
    return torch.cat([first, last], dim=-2)

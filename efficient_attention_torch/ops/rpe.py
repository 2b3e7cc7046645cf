"""Relative-position tables: T5 bucketing and 2-D local-window indices.

The tables are static for a given window, so they are built once with
numpy.  Reference constructions: T5 bucketing ``causal_eva.py:47-97``
(the scalar, head-shared bias of causal EVA), the 2-D window index
``local_attention.py:43-66``.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def t5_relative_position_bucket(relative_position: np.ndarray,
                                causal: bool = True, num_buckets: int = 32,
                                max_distance: int = 128) -> np.ndarray:
    """T5's bucket of each relative position (key minus query): exact below
    ``num_buckets // 2``, logarithmic up to ``max_distance``
    (``T5RelativePositionBias._relative_position_bucket``, ``eva.py:32-54``)."""
    ret = np.zeros_like(relative_position)
    n = -relative_position
    if not causal:
        num_buckets //= 2
        ret = ret + (n < 0).astype(np.int64) * num_buckets
        n = np.abs(n)
    else:
        n = np.maximum(n, 0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    # where max_distance <= max_exact every position is small and the
    # logarithmic branch is never taken; the guard keeps its log finite
    log_ratio = math.log(max(max_distance / max_exact, 1.0 + 1e-6))
    with np.errstate(divide="ignore"):
        val_if_large = max_exact + (
            np.log(np.maximum(n, 1).astype(np.float32) / max_exact)
            / log_ratio * (num_buckets - max_exact)).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large)


def t5_bucket_table(q_len: int, k_len: int, causal: bool, num_buckets: int,
                    max_distance: int, k_offset: int = 0) -> np.ndarray:
    """``[q_len, k_len]`` bucket ids of key position ``j + k_offset`` seen
    from query position ``i`` (``k_offset = -e`` for a backward halo of
    ``e``)."""
    rel = (np.arange(k_len)[None, :] + k_offset) - np.arange(q_len)[:, None]
    return t5_relative_position_bucket(rel, causal=causal,
                                       num_buckets=num_buckets,
                                       max_distance=max_distance)


def local_2d_rpe_index(window_size: int, ext_size: int) -> Tuple[np.ndarray, int]:
    """Pairwise relative-position index for 2-D local windows with halo.

    Returns ``(index [w*w, (w+2e)*(w+2e)], table_size)``.  The table size
    ``2(w+e-1)(2e+w+1)+1`` is the reference's (97 for ``w=7, e=0``), not
    Swin's ``(2w-1)**2``: recorded reference checkpoints store tables of
    this size.
    """
    w, e = window_size, ext_size
    table_size = 2 * (w + e - 1) * (2 * e + w + 1) + 1
    coords_h = np.arange(-e, e + w)
    coords_w = np.arange(-e, e + w)
    coords = np.stack(np.meshgrid(coords_h, coords_w, indexing="ij"))  # [2, 2e+w, 2e+w]
    coords = coords.reshape(2, (w + 2 * e) ** 2).T[None, :, :]  # [1, (2e+w)^2, 2]
    q_hw = np.arange(0, w)
    q_coords = np.stack(np.meshgrid(q_hw, q_hw, indexing="ij"))
    q_coords = q_coords.reshape(2, w**2).T[:, None, :]  # [w^2, 1, 2]
    relative = q_coords - coords  # [w^2, (2e+w)^2, 2]
    relative = relative + (e + w - 1)
    relative[:, :, 0] *= 2 * e + w
    return relative.sum(-1), table_size

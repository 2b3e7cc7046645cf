"""Relative-position index for 2-D local windows.

The index table is static for a given window, so it is built once with
numpy and registered on the module as a buffer.  Reference construction:
``local_attention.py:43-66``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


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

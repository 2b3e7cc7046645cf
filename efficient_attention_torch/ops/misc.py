"""Misc attention utilities (``attn_utils.py``).

Counterpart of ``efficient_attention_tpu/ops/misc.py``.  The reference's
``look_around`` and ``Merger`` (``attn_utils.py:33, 116``) are used by
nothing in the reference, so neither package has them; ``ops/windows.py``
makes the halos.
"""
from __future__ import annotations

import numpy as np


def future_mask(n: int) -> np.ndarray:
    """``[n, n]`` causal mask: -inf above the diagonal, 0 elsewhere
    (``attn_utils.fill_with_neg_inf`` + ``buffered_future_mask``; the shape
    is static, so nothing is buffered)."""
    mask = np.zeros((n, n), np.float32)
    mask[np.triu_indices(n, 1)] = -np.inf
    return mask

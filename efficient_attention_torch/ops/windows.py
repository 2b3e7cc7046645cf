"""Non-overlapping 2-D window partitioning for local attention.

Shapes follow the reference (``attn_utils.py:190-234``):
``[..., H, W, d] -> [..., gh*gw, w*w, d]`` and back.  Halo'd (overlapping)
windows are not ported yet (ROADMAP.md Queue 1, item 6).
"""
from __future__ import annotations

from typing import Tuple

import torch


def window_2d_partition(x: torch.Tensor, window_size: int,
                        ext_window_size: int = 0) -> torch.Tensor:
    """Swin-style 2-D windows: ``[..., H, W, d] -> [..., gh*gw, w*w, d]``."""
    if ext_window_size > 0:
        raise NotImplementedError(
            "halo'd 2-D windows (overlap_window) are not ported yet; "
            "see ROADMAP.md Queue 1, item 6")
    *lead, H, W, d = x.shape
    w = window_size
    if H % w or W % w:
        raise ValueError(f"H={H}, W={W} not divisible by window {w}")
    gh, gw = H // w, W // w
    out = x.reshape(*lead, gh, w, gw, w, d).transpose(-3, -4)
    return out.reshape(*lead, gh * gw, w * w, d)


def window_2d_merge(x: torch.Tensor, window_size: int,
                    hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`window_2d_partition`: ``[..., gh*gw, w*w, d] ->
    [..., H, W, d]``."""
    H, W = hw
    w = window_size
    gh, gw = H // w, W // w
    *lead, n_win, win_sq, d = x.shape
    if n_win != gh * gw or win_sq != w * w:
        raise ValueError(f"{tuple(x.shape)} is not a {w}x{w} partition of {hw}")
    out = x.reshape(*lead, gh, gw, w, w, d).transpose(-3, -4)
    return out.reshape(*lead, H, W, d)

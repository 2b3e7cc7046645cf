"""Window partitioning for local attention.

Shapes follow the reference (``attn_utils.py:155-234``):

* 2-D (Swin-style, ``attn_utils.py:190-234``): ``[..., H, W, d] ->
  [..., gh*gw, (w + 2e)**2, d]``, each window extended by a halo of ``e``
  rows and columns filled with ``pad_val`` outside the grid, and the
  halo-free merge back;
* 1-D (``attn_utils.py:155-166``): ``[..., n, d] -> [..., g, w + 2e, d]``,
  each window extended by a symmetric halo of ``e`` positions filled with
  ``pad_val`` outside the sequence;
* causal 1-D (``causal_eva.py:102-113``): a backward-only halo,
  ``[..., n, d] -> [..., g, e + w, d]``, and the plain merge back;
* right padding of a sequence to a multiple of the window, and its
  key-padding mask (``attn_utils.py:12-30``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = -2,
                    value: float = 0.0) -> torch.Tensor:
    """Right-pad ``axis`` with ``value`` to a multiple of ``multiple``."""
    n = x.shape[axis]
    remainder = (-n) % multiple
    if remainder == 0:
        return x
    axis = axis % x.dim()
    pad = [0, 0] * (x.dim() - axis - 1) + [0, remainder]
    return F.pad(x, pad, value=value)


def padding_mask_for(batch: int, orig_len: int, padded_len: int,
                     device=None) -> torch.Tensor:
    """Boolean key-padding mask (True = padding) ``[batch, padded_len]`` of a
    right-padded sequence."""
    mask = torch.arange(padded_len, device=device) >= orig_len
    return mask.expand(batch, padded_len)


def window_1d_partition(x: torch.Tensor, window_size: int,
                        ext_window_size: int = 0,
                        pad_val: float = 0.0) -> torch.Tensor:
    """``[..., n, d] -> [..., g, w + 2e, d]``: non-overlapping windows, each
    extended by ``e`` positions on both sides (filled with ``pad_val``
    outside the sequence)."""
    *lead, n, d = x.shape
    if n % window_size:
        raise ValueError(f"n={n} not divisible by window {window_size}")
    g = n // window_size
    if ext_window_size <= 0:
        return x.reshape(*lead, g, window_size, d)
    e = ext_window_size
    xp = F.pad(x, [0, 0, e, e], value=pad_val)
    idx = (torch.arange(g, device=x.device)[:, None] * window_size
           + torch.arange(window_size + 2 * e, device=x.device)[None, :]).reshape(-1)
    return xp.index_select(-2, idx).reshape(*lead, g, window_size + 2 * e, d)


def causal_window_1d_partition(x: torch.Tensor, window_size: int,
                               ext_window_size: int = 0,
                               pad_val: float = 0.0) -> torch.Tensor:
    """``[..., n, d] -> [..., g, e + w, d]``: non-overlapping windows, each
    extended by the ``e`` positions before it (filled with ``pad_val`` in
    front of the sequence)."""
    *lead, n, d = x.shape
    if n % window_size:
        raise ValueError(f"n={n} not divisible by window {window_size}")
    g = n // window_size
    if ext_window_size <= 0:
        return x.reshape(*lead, g, window_size, d)
    e = ext_window_size
    xp = F.pad(x, [0, 0, e, 0], value=pad_val)
    idx = (torch.arange(g, device=x.device)[:, None] * window_size
           + torch.arange(window_size + e, device=x.device)[None, :]).reshape(-1)
    return xp.index_select(-2, idx).reshape(*lead, g, window_size + e, d)


def window_1d_merge(x: torch.Tensor) -> torch.Tensor:
    """Inverse of the halo-free 1-D partition: ``[..., g, w, d] -> [...,
    g*w, d]``."""
    *lead, g, w, d = x.shape
    return x.reshape(*lead, g * w, d)


def window_2d_partition(x: torch.Tensor, window_size: int,
                        ext_window_size: int = 0,
                        pad_val: float = 0.0) -> torch.Tensor:
    """Swin-style 2-D windows: ``[..., H, W, d] -> [..., gh*gw, (w + 2e)**2,
    d]``, each ``w x w`` window extended by ``e`` rows and columns on every
    side (filled with ``pad_val``, which may be ``-inf``, outside the
    grid)."""
    *lead, H, W, d = x.shape
    w = window_size
    if H % w or W % w:
        raise ValueError(f"H={H}, W={W} not divisible by window {w}")
    gh, gw = H // w, W // w
    if ext_window_size <= 0:
        out = x.reshape(*lead, gh, w, gw, w, d).transpose(-3, -4)
        return out.reshape(*lead, gh * gw, w * w, d)
    e = ext_window_size
    total = w + 2 * e
    xp = F.pad(x, [0, 0, e, e, e, e], value=pad_val)
    row = (torch.arange(gh, device=x.device)[:, None] * w
           + torch.arange(total, device=x.device)[None, :]).reshape(-1)
    col = (torch.arange(gw, device=x.device)[:, None] * w
           + torch.arange(total, device=x.device)[None, :]).reshape(-1)
    out = xp.index_select(-3, row).index_select(-2, col)  # [..., gh*t, gw*t, d]
    out = out.reshape(*lead, gh, total, gw, total, d).transpose(-3, -4)
    return out.reshape(*lead, gh * gw, total * total, d)


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

"""Numerically stable log-space primitives, used by ScatterBrain's fusion
of the sparse and the low-rank terms.

Counterpart of ``efficient_attention_tpu/ops/log_ops.py`` (reference
``attn_utils.{log_add_exp,log_matmul_exp,log_avg_exp}``,
``efficient-attention/efficient_attention/attn_utils.py:44-113``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def log_add_exp(a: torch.Tensor, b: torch.Tensor,
                mask: Optional[Tuple[float, float]] = None,
                eps: float = 1e-5) -> torch.Tensor:
    """``log(m0 exp(a) + m1 exp(b) + eps)`` shifted by ``max(a, b)``;
    ``mask=(1, -1)`` is a stable log-subtract (``attn_utils.py:44-51``)."""
    if mask is None:
        mask = (1.0, 1.0)
    m = torch.maximum(a, b)
    return m + torch.log(torch.exp(a - m) * mask[0] + torch.exp(b - m) * mask[1]
                         + eps)


def log_matmul_exp(v1: torch.Tensor, v2: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Stable ``log(exp(v1) @ exp(v2))`` (``attn_utils.py:53-66``); the
    shifts carry no gradient."""
    m1 = v1.amax(dim=-1, keepdim=True).detach()
    m2 = v2.amax(dim=-2, keepdim=True).detach()
    return m1 + m2 + torch.log(torch.exp(v1 - m1) @ torch.exp(v2 - m2) + eps)


def log_avg_exp(t: torch.Tensor, mask: Optional[torch.Tensor] = None,
                axis: int = -1, eps: float = 1e-6,
                keepdims: bool = False) -> torch.Tensor:
    """Stable ``log(mean(exp(t)))`` over ``axis``, the mean over the
    entries where ``mask`` is True (``attn_utils.py:68-113``).

    NOTE: the reference divides by ``n`` *and* subtracts ``log n`` again
    (``attn_utils.py:104-110``), i.e. computes ``logsumexp - 2 log n``.  The
    function is unused by the attention zoo, so the single, mathematically
    correct normalisation is kept here, as in the JAX package.
    """
    if mask is not None:
        t = torch.where(mask, t, torch.full_like(t, -torch.finfo(t.dtype).max))
        n = mask.sum(dim=axis)
    else:
        n = t.shape[axis]
    max_t = t.amax(dim=axis).detach()
    t_exp = torch.exp(t - max_t.unsqueeze(axis))
    avg_exp = torch.clamp(t_exp.sum(dim=axis), min=eps) / n
    out = torch.log(avg_exp + eps) + max_t
    return out.unsqueeze(axis) if keepdims else out

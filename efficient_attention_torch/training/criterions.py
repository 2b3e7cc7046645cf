"""Criterions of the LM recipe: adaptive loss and (label-smoothed) cross
entropy.

Counterpart of ``efficient_attention_tpu/training/criterions.py`` (fairseq
``criterions/adaptive_loss.py`` and ``label_smoothed_cross_entropy.py``):
token sums with pad masking, fairseq's sample-size accounting.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def label_smoothed_nll_loss(logits: torch.Tensor, targets: torch.Tensor,
                            epsilon: float = 0.1, pad_idx: Optional[int] = 1
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(smoothed loss sum, nll sum, ntokens) of ``logits [B, T, V]``:
    ``(1-eps) nll + eps/(V-1) sum_{k != y} -lp_k``, written as
    ``(1-eps-eps_i) nll + eps_i sum_k -lp_k``."""
    lprobs = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lprobs, -1, targets[..., None])[..., 0]
    smooth = -lprobs.mean(dim=-1)
    mask = (torch.ones_like(nll) if pad_idx is None
            else (targets != pad_idx).float())
    V = logits.shape[-1]
    eps_i = epsilon / (V - 1)
    loss = (1.0 - epsilon - eps_i) * nll + eps_i * smooth * V
    return (loss * mask).sum(), (nll * mask).sum(), mask.sum()


def adaptive_loss(nll_per_token: torch.Tensor, targets: torch.Tensor,
                  pad_idx: Optional[int] = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll sum, ntokens) over non-pad targets."""
    mask = (torch.ones_like(nll_per_token) if pad_idx is None
            else (targets != pad_idx).float())
    return (nll_per_token * mask).sum(), mask.sum()

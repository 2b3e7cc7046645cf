"""Quantization noise (iPQ): structured block dropout of weight matrices.

Counterpart of ``efficient_attention_tpu/models/quant_noise.py`` (fairseq
``modules/quant_noise.py``): in training, whole ``block_size``-wide blocks of
a weight's input dimension are dropped with probability ``p``, each output
unit its own set, and the survivors rescaled by ``1/(1-p)``; eval uses the
clean weight.  The mask is drawn from the module's ``generator`` (set by the
train step, as for dropout).  A torch module reads ``self.training``, so the
JAX ``qn_call`` helper, which passed ``deterministic`` on, has no
counterpart here.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from efficient_attention_torch.ops.promote import Linear


class QuantNoiseDense(Linear):
    """``Linear`` with iPQ noise on its weight in training."""

    def __init__(self, in_features: int, out_features: int, p: float = 0.0,
                 block_size: int = 8, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        if in_features % block_size:
            raise ValueError(f"quant-noise block size {block_size} must divide "
                             f"in_features {in_features}")
        self.p = p
        self.block_size = block_size
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight
        if self.training and self.p > 0.0:
            nb = self.in_features // self.block_size
            drop = torch.rand((self.out_features, nb), generator=self.generator,
                              device=weight.device) < self.p
            mask = drop.repeat_interleave(self.block_size, dim=1)
            weight = weight.masked_fill(mask, 0.0) / (1.0 - self.p)
        dtype = torch.promote_types(x.dtype, weight.dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), weight.to(dtype), bias)


def dense(in_features: int, out_features: int, p: float = 0.0,
          block_size: int = 8, bias: bool = True) -> Linear:
    """:class:`~efficient_attention_torch.ops.promote.Linear` (which computes
    in the promoted dtype of input and weight, as flax's Dense) when ``p == 0``, else :class:`QuantNoiseDense`; both
    hold ``weight`` and ``bias``, so the noise never changes the parameter
    names."""
    if p <= 0.0:
        return Linear(in_features, out_features, bias=bias)
    return QuantNoiseDense(in_features, out_features, p=p,
                           block_size=block_size, bias=bias)

"""``Linear`` and ``LayerNorm`` that compute in the promoted dtype of their
input and parameters.

flax's ``Dense`` and ``LayerNorm`` promote as ``jnp`` does: a float32
activation meeting bfloat16 weights computes in float32 with the weights
cast up.  torch's modules refuse mixed dtypes instead.  The language model
takes these, so that under ``--bf16`` the float32 stream that its adaptive
input starts (JAX ``models/adaptive_softmax.py:277``) runs as in the JAX
program.  With one dtype throughout they are torch's own modules.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), _cast(self.bias, dtype))


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype if self.weight is None else torch.promote_types(
            x.dtype, self.weight.dtype)
        return F.layer_norm(x.to(dtype), self.normalized_shape,
                            _cast(self.weight, dtype), _cast(self.bias, dtype),
                            self.eps)

"""Exact softmax multi-head attention, the numerical baseline of the zoo.

PyTorch counterpart of ``efficient_attention_tpu/attention/base.py``
(reference ``abstract_attention.py:41-140``).  Call convention:
``forward(x, key_padding_mask=None)`` with ``x: [B, N, C]`` or
``[B, H, W, C]`` and ``key_padding_mask: [B, N]`` bool, True = padding.
Dropout follows ``module.training`` and draws from the ``generator`` that
``models.layers.set_generator`` hands it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# fp16/bf16-safe large-negative fill (``local_attention.py:141``)
MASK_VAL = -5e4


class Dropout(nn.Module):
    """Dropout whose keep mask comes from ``generator`` (None: torch's
    default one), active in training mode only (flax ``nn.Dropout``)."""

    def __init__(self, p: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.p == 0.0 or not self.training:
            return x
        keep = 1.0 - self.p
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class MultiheadAttention(nn.Module):
    """Exact softmax attention with a fused QKV projection
    (``abstract_attention.py:41-133``)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 fp32: bool = False):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.fp32 = fp32
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.attn_dropout = Dropout(attn_drop)
        self.proj_dropout = Dropout(proj_drop)
        # under tensor parallelism (parallel.mesh.shard_model) the module
        # computes only these heads of the whole model's: ``num_heads`` and
        # ``dim`` are then the local ones and ``head_dim`` stays the model's
        self.local_heads: Optional[slice] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def scale(self) -> float:
        return self.head_dim ** -0.5

    def proj_and_split_heads(self, x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``[B, *seq, C] -> 3 x [B, H, N, Dh]``."""
        B, C = x.shape[0], x.shape[-1]
        N = math.prod(x.shape[1:-1])
        qkv = self.qkv(x.reshape(B, N, C))
        qkv = qkv.reshape(B, N, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        return q, k, v

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B = x.shape[0]
        seq_shape = tuple(x.shape[1:-1])
        q, k, v = self.proj_and_split_heads(x)
        output = self._apply_attention(q, k, v, key_padding_mask)
        x = output.transpose(1, 2).reshape((B,) + seq_shape + (-1,))
        return self.proj_dropout(self.proj(x))

    def _apply_attention(self, q, k, v, key_padding_mask):
        """Scaled dot-product attention (``abstract_attention.py:91-133``)."""
        # logits accumulate in f32 either way; they stay f32 with ``fp32``,
        # else they are rounded to q's dtype, as the JAX package's
        # ``preferred_element_type=f32`` product followed by its cast
        if self.fp32:
            q, k = q.float(), k.float()
        attn = torch.einsum("bhnd,bhmd->bhnm", q, k) * self.scale
        if key_padding_mask is not None:
            attn = attn.masked_fill(
                key_padding_mask[:, None, None, :].bool(), MASK_VAL)
        attn = F.softmax(attn, dim=-1).to(q.dtype)
        attn = self.attn_dropout(attn)
        return torch.einsum("bhnm,bhmd->bhnd", attn, v)

    @staticmethod
    def add_attn_specific_args(parent_parser, struct_name="attn_args", prefix=""):
        from efficient_attention_torch.config import add_nested_argument

        parser = parent_parser.add_argument_group("Attention")
        p = prefix + "-" if len(prefix) > 1 else ""
        add_nested_argument(
            parser, f"--{p}fp32", struct_name=struct_name, prefix=prefix,
            default=False, action="store_true",
        )
        return parent_parser

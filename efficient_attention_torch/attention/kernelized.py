"""Kernelized (linear) attention: Performer/FAVOR+, RFA, DPFP, cosFormer.

PyTorch counterpart of ``efficient_attention_tpu/attention/kernelized.py``
(reference ``efficient-attention/efficient_attention/kernelized_attention.py``).
Training draws a fresh Gaussian projection per forward from
``self.generator`` (``kernelized_attention.py:312-324``); eval uses a fixed
orthogonal projection, the buffer ``random_proj [H, m, d]``, drawn once at
construction with head ``h`` seeded ``1000 h`` as in the reference
(``kernelized_attention.py:250-258``).  The JAX package derives its matrix
from ``PRNGKey(0)`` instead, and the two generators give different numbers:
to compute what the JAX module computes, copy its matrix into the buffer.

At eval with ``proj_method='favorp'``, no cos-weighting and no padding mask,
``impl='auto'`` takes the fused kernel K6 (``ops/kernels/performer_fused.py``)
for CUDA tensors where its geometry gate holds (the JAX ``_fused_ok``, with
no minimum sequence length: JAX's crossover was measured on another
accelerator, and none has been measured on this one yet); ``impl='fused'``
takes it for tensors on any device (the plain version on the CPU) and raises
where it cannot; ``impl='xla'`` keeps the eager composition.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from efficient_attention_torch.attention.base import MultiheadAttention
from efficient_attention_torch.ops.kernels.performer_fused import (
    performer_attention_fused,
    supports_performer_fused,
)
from efficient_attention_torch.ops.random_features import (
    cos_reweighted_linear_attention,
    create_proj_matrix,
    dpfp_projection,
    favorp_projection,
    fourier_projection,
    generalized_projection,
    linear_attention,
    nonlinear_map,
)

_RANDOM_PROJ_METHODS = ("favorp", "relu", "fourier")
IMPLS = ("auto", "fused", "xla")


def eval_projection(num_heads: int, proj_dim: int, head_dim: int) -> torch.Tensor:
    """The fixed eval projection ``[H, m, d]``: orthogonal Gaussian blocks,
    head ``h`` drawn from a generator seeded ``1000 h``."""
    return torch.cat([
        create_proj_matrix(1, proj_dim, head_dim, ortho=True,
                           generator=torch.Generator().manual_seed(1000 * h))
        for h in range(num_heads)])


class DeterministicLearnableFourierFeatures(nn.Module):
    """Learnable MLP on Fourier features (``kernelized_attention.py:
    159-183``)."""

    def __init__(self, num_heads: int, dim: int, fourier_dim: int,
                 std: float = 0.02):
        super().__init__()
        self.dim = dim
        gen = torch.Generator().manual_seed(0)
        self.random_proj = nn.Parameter(
            torch.randn(num_heads, fourier_dim // 2, dim, generator=gen) * std)
        self.dense = nn.Linear(fourier_dim, fourier_dim)

    def forward(self, x: torch.Tensor, is_query: bool = False) -> torch.Tensor:
        projected = torch.einsum("bn...d,njd->bn...j", x, self.random_proj)
        feat = torch.cat([torch.cos(projected), torch.sin(projected)], dim=-1)
        return F.relu(self.dense(feat * self.dim ** -0.5))


class KernelizedAttention(MultiheadAttention):
    """Linear attention with pluggable feature maps
    (``kernelized_attention.py:223-360``)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 fp32: bool = False, approx_attn_dim: int = 64,
                 proj_method: str = "favorp", cos_weighting: bool = False,
                 sample_scheme: str = "default", impl: str = "auto"):
        super().__init__(dim, num_heads, qkv_bias=qkv_bias,
                         attn_drop=attn_drop, proj_drop=proj_drop, fp32=fp32)
        if impl not in IMPLS:
            raise ValueError(f"unknown kernelized impl {impl!r}; use one of "
                             f"{IMPLS}")
        self.approx_attn_dim = approx_attn_dim
        self.proj_method = proj_method
        self.cos_weighting = cos_weighting
        self.sample_scheme = sample_scheme
        self.impl = impl
        self.generator: Optional[torch.Generator] = None
        m, d = approx_attn_dim, self.head_dim
        if proj_method == "dpfp":
            self._nu = (m // d) // 2
            if self._nu <= 0:
                raise ValueError("approx_attn_dim must be a multiple of 2*head_dim")
        elif proj_method == "mlp-fourier":
            self.feature_proj_module = DeterministicLearnableFourierFeatures(
                num_heads, d, m)
        elif self.use_random_proj:
            if sample_scheme == "learnable":
                self.random_proj = nn.Parameter(eval_projection(num_heads, m, d))
            elif sample_scheme in ("default", "fixed"):
                self.register_buffer("random_proj", eval_projection(num_heads, m, d))
            else:
                raise NotImplementedError(f"sample scheme {sample_scheme!r}")
        elif proj_method not in ("relu-only", "sigmoid-only"):
            raise NotImplementedError(f"proj_method {proj_method!r}")

    @property
    def use_random_proj(self) -> bool:
        return self.proj_method in _RANDOM_PROJ_METHODS

    def get_proj_matrix(self, like: torch.Tensor) -> Optional[torch.Tensor]:
        """Projection policy (``kernelized_attention.py:312-324``): the
        learned or fixed matrix, or at eval the buffer; a fresh Gaussian from
        ``self.generator`` in training."""
        if not self.use_random_proj:
            return None
        if self.sample_scheme in ("learnable", "fixed") or not self.training:
            return self.random_proj.to(like.dtype)
        return create_proj_matrix(self.num_heads, self.approx_attn_dim,
                                  self.head_dim, generator=self.generator,
                                  dtype=like.dtype, device=like.device)

    def q_k_projection(self, q, k, random_proj):
        """Feature-map dispatch (``kernelized_attention.py:280-296``)."""
        if self.proj_method == "favorp":
            fp = partial(favorp_projection, projection=random_proj)
        elif self.proj_method == "fourier":
            fp = partial(fourier_projection, projection=random_proj)
        elif self.proj_method == "relu":
            fp = partial(generalized_projection, projection=random_proj,
                         projection_fn=F.relu)
        elif self.proj_method == "dpfp":
            fp = partial(dpfp_projection, nu=self._nu)
        elif self.proj_method == "mlp-fourier":
            fp = self.feature_proj_module
        elif self.proj_method == "relu-only":
            fp = partial(nonlinear_map, mapping_fn=F.relu)
        else:  # sigmoid-only
            fp = partial(nonlinear_map, mapping_fn=torch.sigmoid)
        return fp(q, is_query=True), fp(k, is_query=False)

    def _fused_ok(self, B, N, x, key_padding_mask) -> bool:
        if self.impl == "xla":
            return False
        if self.impl == "auto" and x.device.type != "cuda":
            return False
        ok = (not self.training and self.proj_method == "favorp"
              and not self.cos_weighting
              and self.sample_scheme in ("default", "fixed", "learnable")
              and key_padding_mask is None
              and supports_performer_fused(B, N, 3 * self.dim, self.num_heads,
                                           self.approx_attn_dim,
                                           x.element_size()))
        if self.impl == "fused" and not ok:
            raise NotImplementedError(
                "impl='fused' requires eval-mode favorp without cos-weighting "
                "or a padding mask, and a geometry within "
                "supports_performer_fused")
        return ok

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        seq_shape = tuple(x.shape[1:-1])
        N = math.prod(seq_shape)
        if self._fused_ok(B, N, x, key_padding_mask):
            # the packed [B, N, 3HD] goes straight into the kernel; the
            # feature maps never reach device memory
            qkv = self.qkv(x.reshape(B, N, C))
            out = performer_attention_fused(qkv, self.get_proj_matrix(x),
                                            self.num_heads)
            return self.proj_dropout(self.proj(out.reshape((B,) + seq_shape + (C,))))
        return super().forward(x, key_padding_mask)

    def _apply_attention(self, q, k, v, key_padding_mask):
        q_prime, k_prime = self.q_k_projection(q, k, self.get_proj_matrix(q))
        if key_padding_mask is not None:
            k_prime = k_prime.masked_fill(
                key_padding_mask[:, None, :, None].bool(), 0.0)
        # linear attention runs in f32 (``kernelized_attention.py:345``)
        if self.cos_weighting:
            out = cos_reweighted_linear_attention(q_prime.float(), k_prime.float(),
                                                  v.float())
        else:
            out = linear_attention(q_prime.float(), k_prime.float(), v.float())
        return out.to(q.dtype)

    @staticmethod
    def add_attn_specific_args(parent_parser, struct_name="attn_args", prefix=""):
        from efficient_attention_torch.config import add_nested_argument

        parent_parser = MultiheadAttention.add_attn_specific_args(
            parent_parser, struct_name=struct_name, prefix=prefix
        )
        parser = parent_parser.add_argument_group("Attention")
        p = prefix + "-" if len(prefix) > 1 else ""
        add_nested_argument(parser, f"--{p}approx-attn-dim", struct_name=struct_name,
                            prefix=prefix, default=64, type=int,
                            help="number of random features")
        add_nested_argument(parser, f"--{p}proj-method", struct_name=struct_name,
                            prefix=prefix, default="favorp", type=str,
                            help="which random feature is used for RFA")
        add_nested_argument(parser, f"--{p}cos-weighting", struct_name=struct_name,
                            prefix=prefix, action="store_true", default=False)
        add_nested_argument(parser, f"--{p}sample-scheme", struct_name=struct_name,
                            prefix=prefix, default="default", type=str)
        return parent_parser

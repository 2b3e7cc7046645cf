"""LARA: linear randomized attention through multiple importance sampling.

PyTorch counterpart of ``efficient_attention_tpu/attention/lara.py``
(reference ``efficient-attention/efficient_attention/lara.py``, ICML 2022).
Landmark proposals (pooled or segment-mean, with an optional Linear+LN)
define a mixture of random-feature proposals; a self-normalised importance
sampling estimate combines per-landmark ``kv`` statistics with the balance
heuristic (``mis-bh``), its optimal-alpha refinement (``mis-opt``) or the
biased form (``mis-biased``).

At eval with ``mis-opt`` and no padding mask, ``impl='auto'`` takes the
fused kernel K5 (``ops/kernels/lara_fused.py``) for CUDA tensors where its
geometry gate holds (the JAX ``_fused_ok``, with the TPU's ``head_dim % 64``
lane rule replaced by the CUDA kernel's own gate); ``impl='fused'`` takes
it for tensors on any device (the plain version on the CPU) and raises where
it cannot; ``impl='xla'`` (the JAX package's name for the plain path) keeps
the eager composition.  Training draws the proposal samples from
``self.generator``, which the train step sets.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional

import torch
from torch import nn

from efficient_attention_torch.attention.base import MultiheadAttention
from efficient_attention_torch.ops.kernels.lara_fused import (
    lara_attention_fused,
    supports_lara_fused,
)
from efficient_attention_torch.ops.pooling import (
    adaptive_avg_pool_2d,
    segment_mean_landmarks,
)
from efficient_attention_torch.ops.random_features import prm_projection

IMPLS = ("auto", "fused", "xla")


def _bar_gen(channels: int) -> nn.Sequential:
    """Linear + LayerNorm, named ``2`` and ``3`` as in the reference, whose
    Sequential holds two parameter-free pooling steps first."""
    return nn.Sequential(OrderedDict([
        ("2", nn.Linear(channels, channels)),
        ("3", nn.LayerNorm(channels, eps=1e-6)),
    ]))


class LinearRA(MultiheadAttention):
    """LARA (``lara.py:14-251``).

    Proposal generators (``lara.py:41-79``): ``pool`` / ``no-param-pool``
    (adaptive average-pool landmarks, with or without Linear+LN) and
    ``adaptive-1d`` (segment means of Linear+LN'd tokens); the ``-mixed`` /
    ``-vmixed`` suffixes mix the key landmarks by a softmax over their Gram
    logits (``lara.py:157-174``).  MIS types (``lara.py:214-236``):
    ``mis-opt`` / ``mis-biased`` / ``mis-bh``.
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 fp32: bool = False, num_landmarks: int = 49,
                 kernel_size: Optional[int] = None, proposal_gen: str = "pool",
                 use_antithetics: bool = False, use_multisample: bool = False,
                 pool_module_type: str = "light", mis_type: str = "mis-opt",
                 alpha_coeff: float = 1.0, impl: str = "auto"):
        super().__init__(dim, num_heads, qkv_bias=qkv_bias,
                         attn_drop=attn_drop, proj_drop=proj_drop, fp32=fp32)
        if impl not in IMPLS:
            raise ValueError(f"unknown LARA impl {impl!r}; use one of {IMPLS}")
        if pool_module_type == "dense":
            channels = dim
        elif pool_module_type == "light":
            channels = self.head_dim
        else:
            raise NotImplementedError(f"pool_module_type {pool_module_type!r}")
        if mis_type not in ("mis-opt", "mis-biased", "mis-bh"):
            raise NotImplementedError(f"mis_type {mis_type!r}")
        self.num_landmarks = num_landmarks
        self.kernel_size = kernel_size
        self.proposal_gen = proposal_gen
        self.use_antithetics = use_antithetics
        self.use_multisample = use_multisample
        self.pool_module_type = pool_module_type
        self.mis_type = mis_type
        self.alpha_coeff = alpha_coeff
        self.impl = impl
        self.generator: Optional[torch.Generator] = None
        if proposal_gen.startswith(("pool", "adaptive-1d")):
            self.q_bar_gen = _bar_gen(channels)
            self.k_bar_gen = _bar_gen(channels)
        elif not proposal_gen.startswith("no-param-pool"):
            raise NotImplementedError(f"proposal_gen {proposal_gen!r}")

    @property
    def _has_bar_gen(self) -> bool:
        return not self.proposal_gen.startswith("no-param-pool")

    # ---- proposal generators ------------------------------------------------

    def _proposal_gen_1d(self, q, k, v, key_padding_mask):
        """Segment-mean landmarks over a 1-D sequence (``lara.py:84-127``).
        Padded tokens are zeroed before the segment means, and the zeroed
        q, k, v are what the SNIS stage uses."""
        if key_padding_mask is not None:
            keep = 1.0 - key_padding_mask.to(v.dtype)[:, None, :, None]
            q, k, v = q * keep, k * keep, v * keep
        if self.proposal_gen.startswith("adaptive-1d"):
            q2, k2 = self.q_bar_gen(q), self.k_bar_gen(k)
        else:
            q2, k2 = q, k
        return (segment_mean_landmarks(q2, self.num_landmarks),
                segment_mean_landmarks(k2, self.num_landmarks), q, k, v)

    def _proposal_gen_2d(self, x, q, k, v):
        """Pooled 2-D landmarks, dense or per-head light pools
        (``lara.py:129-175``)."""
        b, H, W, c = x.shape
        nh, d = self.num_heads, self.head_dim
        o = int(math.sqrt(self.num_landmarks))

        def pool_tokens(t):  # [b, h, H*W, d] -> [b, h, o*o, d]
            grid = t.reshape(b, nh, H, W, d).movedim(-1, 2)  # [b, h, d, H, W]
            pooled = adaptive_avg_pool_2d(grid, o).reshape(b, nh, d, o * o)
            return pooled.transpose(-1, -2)

        if self.pool_module_type == "dense":
            def pool_dense(t):  # [b, h, n, d] -> [b, o*o, c]
                grid = t.transpose(1, 2).reshape(b, H, W, c).movedim(-1, 1)
                return adaptive_avg_pool_2d(grid, o).reshape(b, c, o * o
                                                             ).transpose(-1, -2)

            q_pool, k_pool = pool_dense(q), pool_dense(k)
            if self._has_bar_gen:
                q_pool, k_pool = self.q_bar_gen(q_pool), self.k_bar_gen(k_pool)
            q_bar = q_pool.reshape(b, -1, nh, d).transpose(1, 2)
            k_bar = k_pool.reshape(b, -1, nh, d).transpose(1, 2)
        else:
            q_bar, k_bar = pool_tokens(q), pool_tokens(k)
            if self._has_bar_gen:
                q_bar, k_bar = self.q_bar_gen(q_bar), self.k_bar_gen(k_bar)

        if self.proposal_gen.endswith("mixed"):
            k_logits = torch.einsum("...pd,...cd->...pc", self.scale * k_bar, k_bar)
            if self.proposal_gen.endswith("-vmixed"):
                v_bar = pool_tokens(v)
                k_logits = k_logits + torch.log(
                    torch.linalg.vector_norm(v_bar, dim=-1) + 1e-4)[..., None, :]
            k_bar = torch.einsum("...pc,...cd->...pd",
                                 torch.softmax(k_logits, dim=-1), k_bar)
        return q_bar, k_bar

    # ---- forward ------------------------------------------------------------

    def _proposal_noise(self, shape, like: torch.Tensor) -> torch.Tensor:
        """Standard normal draws for the training-mode proposal samples
        (``lara.py:188-198``), from ``self.generator``."""
        return torch.randn(shape, generator=self.generator, dtype=like.dtype,
                           device=like.device)

    def _fused_ok(self, B, N, qkv_p, key_padding_mask) -> bool:
        if self.impl == "xla":
            return False
        if self.impl == "auto" and qkv_p.device.type != "cuda":
            return False
        ok = (not self.training and self.mis_type == "mis-opt"
              and key_padding_mask is None
              and supports_lara_fused(B, N, qkv_p.shape[-1], self.num_heads,
                                      self.num_landmarks, qkv_p.element_size()))
        if self.impl == "fused" and not ok:
            raise NotImplementedError(
                "impl='fused' requires eval mode, mis_type='mis-opt', no "
                "padding mask and a geometry within supports_lara_fused")
        return ok

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """LARA forward (``lara.py:177-246``) over ``[B, N, C]`` or a
        ``[B, H, W, C]`` grid; training mode samples the proposals."""
        B, C = x.shape[0], x.shape[-1]
        seq_shape = tuple(x.shape[1:-1])
        N = math.prod(seq_shape)
        nh, d = self.num_heads, self.head_dim
        qkv_p = self.qkv(x.reshape(B, N, C))
        q, k, v = qkv_p.reshape(B, N, 3, nh, d).permute(2, 0, 3, 1, 4).unbind(0)
        if len(seq_shape) == 2:
            q_bar, k_bar = self._proposal_gen_2d(x, q, k, v)
        else:
            q_bar, k_bar, q, k, v = self._proposal_gen_1d(q, k, v,
                                                          key_padding_mask)
        mu = q_bar + k_bar
        if self._fused_ok(B, N, qkv_p, key_padding_mask):
            return self._forward_fused(qkv_p, mu, q_bar, B, seq_shape, C)

        doubled = self.training and (self.use_multisample or self.use_antithetics)
        if not self.training:
            weights = mu
        elif self.use_multisample:
            b, h, c, _ = mu.shape
            weights = mu.repeat(1, 1, 2, 1) + self._proposal_noise((b, h, 2 * c, d), mu)
        elif self.use_antithetics:
            noise = self._proposal_noise(mu.shape, mu)
            weights = torch.cat([mu + noise, mu - noise], dim=-2)
        else:
            weights = mu + self._proposal_noise(mu.shape, mu)

        # SNIS estimate (``lara.py:201-246``)
        log_proj_q = prm_projection(q, weights, normalize=False)  # [b, h, c, n]
        log_proj_k = prm_projection(k, weights, normalize=False)
        if key_padding_mask is not None:
            log_proj_k = log_proj_k.masked_fill(
                key_padding_mask[:, None, None, :].bool(), -math.inf)
        kv_stats = torch.einsum("...cm,...md->...cd",
                                torch.softmax(log_proj_k, dim=-1), v)
        if self.mis_type == "mis-biased":
            log_proj_mu = prm_projection(mu, weights, normalize=False)
            log_alpha = torch.einsum("...cd,...nd->...cn", self.scale * mu, q)
            if doubled:
                log_alpha = log_alpha.repeat(1, 1, 2, 1)
            log_proposal = torch.logsumexp(log_proj_mu, dim=-1, keepdim=True)
        elif self.mis_type == "mis-opt":
            t_nc = torch.softmax(
                torch.einsum("...cd,...nd->...cn", self.scale * q_bar, q), dim=-1)
            if doubled:
                mu, t_nc = mu.repeat(1, 1, 2, 1), t_nc.repeat(1, 1, 2, 1)
            log_proj_mu = prm_projection(mu, weights, normalize=False)
            log_proposal = torch.diagonal(log_proj_mu, dim1=-2, dim2=-1)[..., None]
            balance = torch.exp(log_proposal - torch.logsumexp(
                log_proj_mu, dim=-1, keepdim=True))
            alpha_prev = balance + self.alpha_coeff * (
                t_nc - t_nc.mean(dim=-2, keepdim=True))
            log_alpha = torch.log(alpha_prev.clamp(min=1e-8))
        else:  # mis-bh
            log_proj_mu = prm_projection(mu, weights, normalize=False)
            log_alpha = 0.0
            log_proposal = torch.logsumexp(log_proj_mu, dim=-1, keepdim=True)

        log_true_prob = log_proj_q + torch.logsumexp(log_proj_k, dim=-1,
                                                     keepdim=True)
        sniw = torch.softmax(log_alpha + log_true_prob - log_proposal, dim=-2)
        output = torch.einsum("...cn,...cd->...nd", sniw, kv_stats)
        x = output.transpose(1, 2).reshape((B,) + seq_shape + (C,))
        return self.proj_dropout(self.proj(x))

    def _forward_fused(self, qkv_p, mu, q_bar, B, seq_shape, C):
        """The landmark-side terms in torch ops (a ``[c, c]`` Gram), then
        the fused kernel over the packed qkv (JAX ``lara.py:263-282``)."""
        # at eval the RF weights are the proposal means
        log_proj_mu = prm_projection(mu, mu, normalize=False)  # [b, h, c, c]
        log_proposal = torch.diagonal(log_proj_mu, dim1=-2, dim2=-1)
        balance = torch.exp(log_proposal - torch.logsumexp(log_proj_mu, dim=-1))
        out = lara_attention_fused(qkv_p, mu, q_bar, balance, log_proposal,
                                   self.scale, self.num_heads,
                                   alpha_coeff=self.alpha_coeff)
        x = self.proj(out.reshape((B,) + tuple(seq_shape) + (C,)))
        return self.proj_dropout(x)

    @staticmethod
    def add_attn_specific_args(parent_parser, struct_name="attn_args", prefix=""):
        from efficient_attention_torch.config import add_nested_argument

        parent_parser = MultiheadAttention.add_attn_specific_args(
            parent_parser, struct_name=struct_name, prefix=prefix
        )
        parser = parent_parser.add_argument_group("attention")
        p = prefix + "-" if len(prefix) > 1 else ""
        add_nested_argument(parser, f"--{p}num-landmarks", struct_name=struct_name,
                            prefix=prefix, default=49, type=int)
        add_nested_argument(parser, f"--{p}kernel-size", struct_name=struct_name,
                            prefix=prefix, default=None, type=int)
        add_nested_argument(parser, f"--{p}pool-module-type", struct_name=struct_name,
                            prefix=prefix, default="light", type=str)
        add_nested_argument(parser, f"--{p}mis-type", struct_name=struct_name,
                            prefix=prefix, default="mis-opt", type=str)
        add_nested_argument(parser, f"--{p}proposal-gen", struct_name=struct_name,
                            prefix=prefix, default="pool", type=str)
        add_nested_argument(parser, f"--{p}use-antithetics", struct_name=struct_name,
                            prefix=prefix, action="store_true", default=False)
        add_nested_argument(parser, f"--{p}use-multisample", struct_name=struct_name,
                            prefix=prefix, action="store_true", default=False)
        add_nested_argument(parser, f"--{p}alpha-coeff", struct_name=struct_name,
                            prefix=prefix, default=1.0, type=float)
        return parent_parser

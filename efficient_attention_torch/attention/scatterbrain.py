"""ScatterBrain: sparse (local window) plus low-rank (Performer) attention.

PyTorch counterpart of ``efficient_attention_tpu/attention/scatterbrain.py``
(reference ``scatterbrain_attention.py``, a re-implementation of the
NeurIPS 2021 paper).  The queries' and keys' FAVOR+ features stay in log
space; the non-local kv statistics are the global Performer statistics
minus each window's own, and the exact local logits and the low-rank
chunk's log-densities share one softmax.

The JAX class inherits from both ``KernelizedAttention`` and
``LocalAttention``; the port's ``ScatterBrain`` is a ``KernelizedAttention``
(its projection policy, ``random_proj`` and flags) that takes its windows,
halos and learned bias from ``LocalWindows``.  Training draws a fresh
projection from ``self.generator``, as Performer does; the eval projection
is the port's own (``attention/kernelized.py``), so the JAX matrix is
copied in to compute what the JAX module computes.  No kernel runs: the
features are log-space, which the fused Performer kernel K6 does not
compute (eager in JAX too).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from efficient_attention_torch.attention.kernelized import KernelizedAttention
from efficient_attention_torch.attention.local import LocalAttention, LocalWindows
from efficient_attention_torch.ops.log_ops import log_add_exp
from efficient_attention_torch.ops.random_features import log_favorp_projection


class ScatterBrain(LocalWindows, KernelizedAttention):
    """Sparse + low-rank attention (``scatterbrain_attention.py:50-180``)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 fp32: bool = False, approx_attn_dim: int = 64,
                 proj_method: str = "favorp", cos_weighting: bool = False,
                 sample_scheme: str = "default", use_rpe: bool = False,
                 window_size: int = 2, attn_2d: bool = False,
                 overlap_window: bool = False):
        if proj_method != "favorp":
            raise ValueError("ScatterBrain requires log-space favorp features, "
                             f"not proj_method={proj_method!r}")
        super().__init__(dim, num_heads, qkv_bias=qkv_bias,
                         attn_drop=attn_drop, proj_drop=proj_drop, fp32=fp32,
                         approx_attn_dim=approx_attn_dim,
                         proj_method=proj_method, cos_weighting=cos_weighting,
                         sample_scheme=sample_scheme, impl="xla")
        self._init_windows(use_rpe, window_size, attn_2d, overlap_window)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ScatterBrain forward (``scatterbrain_attention.py:72-168``) over
        a ``[B, H, W, C]`` grid (kept in grid shape) or a ``[B, N, C]``
        sequence, with an optional ``[B, N]`` key-padding mask."""
        B, C = x.shape[0], x.shape[-1]
        orig_n = math.prod(x.shape[1:-1])
        x, key_padding_mask, seq_shape = self._process_input(x, key_padding_mask)
        N = math.prod(seq_shape)
        q, k, v = self.proj_and_split_heads(x)
        if key_padding_mask is None:
            key_padding_mask = torch.zeros(B, N, dtype=torch.bool, device=x.device)
        kpm = key_padding_mask.bool()[:, None, :, None]  # [b, 1, n, 1]
        ext = self.ext_size
        part = self.window_partition

        # the low-rank branch, in log space
        projection = self.get_proj_matrix(q)
        log_q = log_favorp_projection(q, projection, is_query=True)
        log_k = log_favorp_projection(k, projection, is_query=False)
        log_k = log_k.masked_fill(kpm, float("-inf"))
        w_q = part(q, seq_shape)
        w_k = part(k, seq_shape, ext_window_size=ext)
        w_v = part(v, seq_shape, ext_window_size=ext)

        # the non-local kv statistics: global minus in-window (:92-99)
        w_log_q = part(log_q, seq_shape)
        w_log_k = part(log_k, seq_shape, ext_window_size=ext,
                       pad_val=float("-inf"))
        log_k_g = log_k[:, :, None]  # [b, h, 1, n, c]
        max_k = torch.maximum(log_k_g.amax(dim=-2, keepdim=True),
                              w_log_k.amax(dim=(-2, -3), keepdim=True)).detach()
        proj_k = torch.exp(log_k_g - max_k)    # [b, h, 1, n, c]
        w_proj_k = torch.exp(w_log_k - max_k)  # [b, h, g, w, c]
        kv_stats = (torch.einsum("bhtmc,bhmd->bhtcd", proj_k, v)
                    - torch.einsum("bhgwc,bhgwd->bhgcd", w_proj_k, w_v)) / torch.clamp(
            (proj_k.sum(dim=-2) - w_proj_k.sum(dim=-2))[..., None], min=1e-3)
        # the non-local log-normaliser (:100-105)
        log_sum_k = torch.logsumexp(log_k_g, dim=-2, keepdim=True)
        log_sum_k_local = torch.logsumexp(w_log_k, dim=-2, keepdim=True)
        log_sum_k_nonlocal = log_add_exp(log_sum_k, log_sum_k_local, mask=(1, -1))
        log_rfa_d = w_log_q + log_sum_k_nonlocal  # [b, h, g, w, c]

        # the local branch (:106-121): f32 logits rounded to the input's
        # type, then the bias, then the mask
        log_qk = (torch.einsum("bhwie,bhwje->bhwij", w_q.float(), w_k.float())
                  * self.scale).to(q.dtype)
        if self.rpe_enabled:
            log_qk = self.add_rel_pos_bias(log_qk)
        log_qk = log_qk.masked_fill(
            self.local_mask(key_padding_mask, seq_shape, q.dtype), float("-inf"))
        local_len = log_qk.shape[-1]

        # one softmax over [local | rfa] (:123-129)
        attn = F.softmax(torch.cat([log_qk, log_rfa_d], dim=-1), dim=-1)
        output = (torch.einsum("bhwij,bhwje->bhwie", attn[..., :local_len], w_v)
                  + torch.einsum("bhwic,bhwce->bhwie", attn[..., local_len:],
                                 kv_stats))
        x = self.window_merge(output, seq_shape).transpose(1, 2).reshape(B, N, C)
        x = self.proj(x)[:, :orig_n]
        if self.attn_2d:
            # a grid keeps its shape (``scatterbrain_attention.py:161``)
            x = x.reshape((B,) + tuple(seq_shape) + (C,))
        return self.proj_dropout(x)

    @staticmethod
    def add_attn_specific_args(parent_parser, struct_name="attn_args", prefix=""):
        from efficient_attention_torch.config import add_nested_argument

        parent_parser = LocalAttention.add_attn_specific_args(
            parent_parser, struct_name=struct_name, prefix=prefix
        )
        parser = parent_parser.add_argument_group("Attention")
        p = prefix + "-" if len(prefix) > 1 else ""
        add_nested_argument(parser, f"--{p}approx-attn-dim", struct_name=struct_name,
                            prefix=prefix, default=64, type=int)
        add_nested_argument(parser, f"--{p}proj-method", struct_name=struct_name,
                            prefix=prefix, default="favorp", type=str)
        add_nested_argument(parser, f"--{p}cos-weighting", struct_name=struct_name,
                            prefix=prefix, action="store_true", default=False)
        add_nested_argument(parser, f"--{p}sample-scheme", struct_name=struct_name,
                            prefix=prefix, default="default", type=str)
        return parent_parser

"""Causal EVA: the decoder-side EVA of the language and translation models.

PyTorch counterpart of ``efficient_attention_tpu/attention/causal_eva.py``
(reference ``efficient-attention/efficient_attention/causal_eva.py``), with
its two paths.  The parallel (training and full-sequence scoring) path,
batch-first ``[B, T, C]``: blocked local attention over windows of ``window_size``
tokens (with an optional backward halo), and a per-chunk random-feature
branch whose chunk summaries are seen only by strictly later chunks, fused
in one softmax.

Dispatch follows the JAX package (``_packed_ok``): where the geometry, the
mask and the dropout allow, the summaries are computed in the packed
``[B, T, H*D]`` layout and the joint softmax runs through ``causal_packed``
(K3), on the card for ``impl='auto'`` and wherever asked for
``impl='packed'`` (on CPU tensors its plain versions run, as the JAX package
runs the Pallas kernel in interpret mode); otherwise the eager tensor-op
path runs, which is the twin the kernel path is held against.
``impl='xla'`` (the JAX package's name for the plain path) never uses the
kernel, and ``impl='packed'`` raises ``ValueError`` outside the gate.  The
proposal noise is drawn from ``self.generator``, which the train step sets.

The incremental path decodes one token a step (``init_decode_state``,
``decode_step``, ``reorder_decode_state``; JAX ``causal_eva.py:61-81,
477-618``): block-wise local attention over the current window (and the
previous one with ``overlap_window``), and the summaries of the chunks
completed before the query's own chunk, so that it reproduces the parallel
path.  ``pos`` is a Python int; ``decode_step`` writes the state's buffers
in place (the beam search gathers new ones every step).  Sequence
parallelism is not ported yet (ROADMAP.md Queue 1, item 7) and raises.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from efficient_attention_torch.attention.base import MASK_VAL, Dropout
from efficient_attention_torch.ops import windows as W
from efficient_attention_torch.ops.kernels.causal_packed import (
    causal_eva_packed,
    causal_table,
    supports_causal_packed,
)
from efficient_attention_torch.ops.promote import LayerNorm, Linear
from efficient_attention_torch.ops.random_features import prm_projection
from efficient_attention_torch.ops.rpe import t5_bucket_table


class EvaDecodeState(NamedTuple):
    """Fixed-shape incremental state (JAX ``causal_eva.py:61-74``)."""

    pos: int                      # tokens already processed
    prev_window_k: torch.Tensor   # [b, h, w, d] previous block (overlap halo)
    prev_window_v: torch.Tensor
    cur_window_k: torch.Tensor    # [b, h, w, d] current block, slots < pos % w
    cur_window_v: torch.Tensor
    chunk_q: torch.Tensor         # [b, h, cs, d] current chunk accumulator
    chunk_k: torch.Tensor
    chunk_v: torch.Tensor
    rf_k_bar: torch.Tensor        # [b, h, max_chunks, d] completed chunks
    beta: torch.Tensor


def reorder_decode_state(state: EvaDecodeState,
                         order: torch.Tensor) -> EvaDecodeState:
    """Beam reordering (``causal_eva.py:835-849``): every buffer gathered
    along the batch, ``pos`` left alone."""
    return EvaDecodeState(state.pos, *(x.index_select(0, order)
                                       for x in state[1:]))


class T5RelativePositionBias(nn.Module):
    """A T5 bias table ``[num_buckets, num_heads]``, named as the reference
    stores it: causal EVA's is scalar (head-shared, ``causal_eva.py:47-97``),
    1-D EVA's has one column a head (``eva.py:15-65``)."""

    def __init__(self, num_buckets: int, num_heads: int = 1):
        super().__init__()
        self.relative_attention_bias = nn.Embedding(num_buckets, num_heads)


class CausalEVAttention(nn.Module):
    """Causal EVA attention (``causal_eva.py:297-914``), parallel path.

    ``forward(query, key=None, value=None, key_padding_mask=None)`` with
    ``[B, T, C]`` inputs and a ``[B, T]`` bool mask (True = padding);
    training mode draws the proposal noise and applies attention dropout.
    """

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = True, window_size: int = 4,
                 overlap_window: bool = False, causal: bool = True,
                 num_chunks: Optional[int] = None,
                 chunk_size: Optional[int] = None, adaptive_proj: str = "qk",
                 use_t5_rpe: bool = False, impl: str = "auto",
                 seq_axis: Optional[str] = None, q_noise: float = 0.0,
                 qn_block_size: int = 8):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        if chunk_size is None and num_chunks is None:
            raise ValueError("CausalEVAttention needs chunk_size or num_chunks "
                             "(e.g. --attn-chunk-size 8)")
        if chunk_size is not None and (window_size < chunk_size
                                       or window_size % chunk_size):
            raise ValueError("window_size must be a positive multiple of "
                             "chunk_size")
        if seq_axis is not None:
            raise NotImplementedError(
                "sequence-parallel causal EVA is not ported yet; see "
                "ROADMAP.md Queue 1, item 7")
        if impl not in ("auto", "packed", "xla"):
            raise ValueError(f"unknown causal EVA impl {impl!r}; use 'auto', "
                             "'packed' or 'xla'")
        if adaptive_proj not in ("qk", "no-ln"):
            raise NotImplementedError(f"adaptive_proj={adaptive_proj}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.overlap_window = overlap_window
        self.causal = causal
        self.num_chunks = num_chunks
        self.chunk_size = chunk_size
        self.adaptive_proj = adaptive_proj
        self.use_t5_rpe = use_t5_rpe
        self.impl = impl
        # imported here: models/ imports the attention package
        from efficient_attention_torch.models.quant_noise import dense

        self.generator: Optional[torch.Generator] = None
        self.dropout_module = Dropout(dropout)
        qn = (q_noise, qn_block_size)
        self.q_proj = dense(embed_dim, embed_dim, *qn, bias=bias)
        self.k_proj = dense(embed_dim, embed_dim, *qn, bias=bias)
        self.v_proj = dense(embed_dim, embed_dim, *qn, bias=bias)
        self.out_proj = dense(embed_dim, embed_dim, *qn, bias=bias)
        d = self.head_dim

        def mu_proj():
            layers = [Linear(d, d)]
            if adaptive_proj == "qk":
                layers.append(LayerNorm(d, eps=1e-6))
            return nn.Sequential(*layers)

        self.adaptive_mu_q = mu_proj()
        self.adaptive_mu_k = mu_proj()
        if use_t5_rpe and window_size > 0:
            span = window_size + self.ext_size
            num_buckets = max(min(span // 2, 64), 16)
            self.rel_pos_bias = T5RelativePositionBias(num_buckets)
            # bucket of each (window row, key slot), keys with no halo
            # offset (``causal_eva.py:88-97``); kept on the module's device
            self.register_buffer("t5_buckets", torch.from_numpy(t5_bucket_table(
                window_size, span, causal=causal, num_buckets=num_buckets,
                max_distance=span).astype(np.int64)), persistent=False)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def scaling(self) -> float:
        return self.head_dim ** -0.5

    @property
    def ext_size(self) -> int:
        # full-window backward halo when overlapping (``causal_eva.py:353-356``)
        return max(1, self.window_size) if self.overlap_window else 0

    def _t5_bias(self) -> Optional[torch.Tensor]:
        """The ``[w, w + ext]`` T5 bias of a window (key position minus
        query position, no halo offset), times ``scaling``."""
        if not (self.use_t5_rpe and self.window_size > 0):
            return None
        # gathered in f32 by index_select, whose backward is one index_add_
        # (advanced indexing's backward sorts the w*w duplicate indices)
        table = self.rel_pos_bias.relative_attention_bias.weight[:, 0].float()
        bias = table.index_select(0, self.t5_buckets.reshape(-1))
        return bias.reshape(self.t5_buckets.shape) * self.scaling

    def _proposal_noise(self, shape, like: torch.Tensor) -> torch.Tensor:
        """The proposal noise ``N(0, I)`` of a training forward, head-major
        ``[B, H, C, d]``, from ``self.generator``."""
        return torch.randn(shape, generator=self.generator, dtype=like.dtype,
                           device=like.device)

    def _packed_ok(self, B: int, N: int, tgt_len: int, had_mask: bool,
                   rf_chunk_size: int, x: torch.Tensor) -> bool:
        if self.impl == "xla":
            return False
        if self.impl == "auto" and x.device.type != "cuda":
            return False
        return (self.causal and self.ext_size == 0 and self.window_size > 0
                and self.window_size % rf_chunk_size == 0
                and N == tgt_len and not had_mask
                and (not self.training or self.dropout_module.p == 0.0)
                and self.head_dim % 64 == 0
                and supports_causal_packed(B, N, self.window_size,
                                           rf_chunk_size, self.num_heads,
                                           self.head_dim, x.element_size()))

    def _summaries_packed(self, qp, kp, vp, cs: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Chunk summaries ``(rf_k_bar, beta)``, each ``[B, C, H*D]``, in the
        packed layout (``causal_eva.py:255-288``): mu = mu_q(mean q) +
        mu_k(mean k), logp = <mu, k>/sqrt(d) - |k|^2/(2 sqrt(d)), beta =
        softmax over the chunk of logp, times v."""
        B, N, hd = qp.shape
        H, d = self.num_heads, self.head_dim
        C = N // cs
        q5, k5, v5 = (t.reshape(B, C, cs, H, d) for t in (qp, kp, vp))
        rf_k_bar = self.adaptive_mu_k(k5.mean(dim=2))  # [B, C, H, d]
        mu = self.adaptive_mu_q(q5.mean(dim=2)) + rf_k_bar
        if self.training:
            mu = mu + self._proposal_noise((B, H, C, d), mu).transpose(1, 2)
        dn = d ** -0.5
        dash = (mu[:, :, None] * (dn * k5)).sum(-1)  # [B, C, cs, H]
        norm = dn * k5.square().sum(-1) / 2.0
        p = torch.softmax(dash - norm, dim=2)
        beta = (p[..., None] * v5).sum(dim=2)
        return rf_k_bar.reshape(B, C, hd), beta.reshape(B, C, hd)

    def _forward_packed(self, qp, kp, vp, cs: int, tgt_len: int
                        ) -> torch.Tensor:
        """K3 path (``causal_eva.py:220-253``): packed summaries, the
        ``[w, w]`` table (causal triangle at ``MASK_VAL`` plus the T5 bias
        times ``scaling``), the kernel, the output projection."""
        rf_k_bar, beta = self._summaries_packed(qp, kp, vp, cs)
        w = self.window_size
        tab = causal_table(w, self._t5_bias(), device=qp.device)
        out = causal_eva_packed(qp, kp, vp, rf_k_bar, beta, self.scaling,
                                self.num_heads, w, cs, bias_tab=tab)
        return self.out_proj(out)[:, :tgt_len]

    def forward(self, query: torch.Tensor, key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Full-sequence (parallel) path (``causal_eva.py:666-788``)."""
        B, tgt_len, C = query.shape
        if C != self.embed_dim:
            raise ValueError(f"query width {C} != embed_dim {self.embed_dim}")
        had_mask = key_padding_mask is not None
        key = query if key is None else key
        value = query if value is None else value
        w = self.window_size
        if w > 0:
            query, key, value = (W.pad_to_multiple(t, w, axis=-2)
                                 for t in (query, key, value))
            N = query.shape[-2]
            if key_padding_mask is None:
                if N != tgt_len:
                    key_padding_mask = W.padding_mask_for(B, tgt_len, N,
                                                          query.device)
            else:
                key_padding_mask = W.pad_to_multiple(
                    key_padding_mask, w, axis=-1, value=True)
        N = query.shape[-2]
        qp, kp, vp = self.q_proj(query), self.k_proj(key), self.v_proj(value)
        cs = self.chunk_size if self.chunk_size is not None else int(
            N // self.num_chunks)
        cs = min(cs, N)
        if self._packed_ok(B, N, tgt_len, had_mask, cs, qp):
            return self._forward_packed(qp, kp, vp, cs, tgt_len)
        if self.impl == "packed":
            raise ValueError(
                "impl='packed' requires causal mode, no overlap halo, window a "
                "multiple of chunk_size dividing the sequence, no padding mask, "
                "head_dim a multiple of 64, zero attention dropout when "
                "training, and a geometry within the causal_packed kernel's "
                "gate (supports_causal_packed)")
        return self._forward_eager(qp, kp, vp, key_padding_mask, cs,
                                   tgt_len)[:, :tgt_len]

    def _forward_eager(self, qp, kp, vp, key_padding_mask, cs: int,
                       tgt_len: int) -> torch.Tensor:
        """Eager path (``causal_eva.py:349-474``), padding mask and halo
        included."""
        B, N, C = qp.shape
        H, d, w, ext = self.num_heads, self.head_dim, self.window_size, self.ext_size

        def split(t):  # [B, N, C] -> [B, H, N, d]
            return t.reshape(B, N, H, d).transpose(1, 2)

        q, k, v = split(qp), split(kp), split(vp)
        if key_padding_mask is None:
            key_padding_mask = torch.zeros((B, N), dtype=torch.bool,
                                           device=q.device)
        kpm = key_padding_mask.to(q.dtype)[:, None, :, None]  # [B, 1, N, 1]
        part = W.causal_window_1d_partition
        w_q, w_k, w_v = part(q, w, 0), part(k, w, ext), part(v, w, ext)
        rf_mask = part(kpm, cs, 0, pad_val=1.0).bool()  # [B, 1, c, cs, 1]
        rf_q, rf_k, rf_v = (part(t, cs, 0).masked_fill(rf_mask, 0.0)
                            for t in (q, k, v))
        rf_k_bar = self.adaptive_mu_k(rf_k.mean(dim=-2))  # [B, H, c, d]
        mu = self.adaptive_mu_q(rf_q.mean(dim=-2)) + rf_k_bar
        if self.training:
            mu = mu + self._proposal_noise(mu.shape, mu)
        log_proj = prm_projection(rf_k, mu[..., None, :],
                                  normalize=False)[..., 0, :]  # [B, H, c, cs]
        log_proj = log_proj.masked_fill(rf_mask[..., 0], MASK_VAL)
        beta = torch.einsum("...cj,...cjd->...cd",
                            torch.softmax(log_proj, dim=-1), rf_v)
        # [B, H, g, i, c]; query at position p sees chunk c iff c < p // cs
        approx_cv = torch.einsum("...wid,...cd->...wic", w_q,
                                 self.scaling * rf_k_bar)
        if self.causal:
            pos = torch.arange(N, device=q.device)[:, None]
            chunk_ids = torch.arange(approx_cv.shape[-1], device=q.device)[None]
            chunk_mask = (chunk_ids >= pos // cs).reshape(N // w, w, -1)
            approx_cv = approx_cv.masked_fill(chunk_mask, MASK_VAL)
        mask_q = part(kpm, w, 0, pad_val=1.0).bool()  # [B, 1, g, i, 1]
        mask_k = part(kpm, w, ext, pad_val=1.0).bool().transpose(-1, -2)
        log_qk = (torch.einsum("bhwie,bhwje->bhwij", w_q, w_k)
                  * self.scaling).to(q.dtype)
        bias = self._t5_bias()
        if bias is not None:
            log_qk = log_qk + bias.to(log_qk.dtype)
        log_qk = log_qk.masked_fill(mask_q | mask_k, MASK_VAL)
        if self.causal:
            i, j = log_qk.shape[-2:]
            tri = torch.ones((i, j), dtype=torch.bool,
                             device=q.device).triu(1 + ext)
            log_qk = log_qk.masked_fill(tri, MASK_VAL)
        local_len = log_qk.shape[-1]
        attn = torch.softmax(torch.cat([log_qk, approx_cv.to(log_qk.dtype)],
                                       dim=-1), dim=-1)
        attn = self.dropout_module(attn)
        out = (torch.einsum("bhwij,bhwjd->bhwid", attn[..., :local_len], w_v)
               + torch.einsum("bhwic,bhcd->bhwid", attn[..., local_len:],
                              beta.to(attn.dtype)))
        x = W.window_1d_merge(out).transpose(1, 2).reshape(B, N, C)
        return self.out_proj(x)

    def init_decode_state(self, batch_size: int, max_len: int,
                          dtype: torch.dtype = torch.float32,
                          device=None) -> EvaDecodeState:
        """Zeroed decode buffers for up to ``max_len`` tokens."""
        if self.chunk_size is None:
            raise ValueError("decoding requires a fixed chunk_size")
        b, h, d = batch_size, self.num_heads, self.head_dim
        w, cs = self.window_size, self.chunk_size
        max_chunks = max(1, max_len // cs)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        return EvaDecodeState(0, zeros(b, h, w, d), zeros(b, h, w, d),
                              zeros(b, h, w, d), zeros(b, h, w, d),
                              zeros(b, h, cs, d), zeros(b, h, cs, d),
                              zeros(b, h, cs, d), zeros(b, h, max_chunks, d),
                              zeros(b, h, max_chunks, d))

    def decode_step(self, state: EvaDecodeState, query: torch.Tensor,
                    key: Optional[torch.Tensor] = None,
                    value: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, EvaDecodeState]:
        """One token ``[B, 1, C]`` -> ``(output [B, 1, C], new state)``
        (``causal_eva.py:499-618``): ``mu = q_bar + k_bar``; the query sees
        the chunks before ``t // cs``; at ``t % w == 0`` the current block
        becomes the previous one; a chunk's accumulators are reset once it is
        summarised."""
        B, one, C = query.shape
        if one != 1:
            raise ValueError(f"decode_step takes one token, got {one}")
        key = query if key is None else key
        value = query if value is None else value
        w, cs, H, d = self.window_size, self.chunk_size, self.num_heads, self.head_dim
        t = state.pos

        def split(x):  # [B, 1, C] -> [B, H, 1, d]
            return x.reshape(B, 1, H, d).transpose(1, 2)

        q, k, v = split(self.q_proj(query)), split(self.k_proj(key)), split(self.v_proj(value))
        i, c_fill = t % w, t % cs
        prev_k, prev_v = state.prev_window_k, state.prev_window_v
        cur_k, cur_v = state.cur_window_k, state.cur_window_v
        if i == 0:  # the finished block becomes the halo; its buffer is reused
            prev_k, prev_v, cur_k, cur_v = cur_k, cur_v, prev_k, prev_v
        cur_k[:, :, i] = k[:, :, 0]
        cur_v[:, :, i] = v[:, :, 0]
        chunk_q, chunk_k, chunk_v = state.chunk_q, state.chunk_k, state.chunk_v
        chunk_q[:, :, c_fill] = q[:, :, 0]
        chunk_k[:, :, c_fill] = k[:, :, 0]
        chunk_v[:, :, c_fill] = v[:, :, 0]
        rf_k_bar, beta = state.rf_k_bar, state.beta
        if c_fill == cs - 1:  # the chunk is complete: summarise it
            cur_rf_k_bar = self.adaptive_mu_k(chunk_k.mean(dim=-2, keepdim=True))
            mu = self.adaptive_mu_q(chunk_q.mean(dim=-2, keepdim=True)) + cur_rf_k_bar
            log_proj = prm_projection(chunk_k, mu, normalize=False)  # [b, h, 1, cs]
            rf_k_bar[:, :, t // cs] = cur_rf_k_bar[:, :, 0]
            beta[:, :, t // cs] = torch.einsum(
                "...nj,...jd->...nd", torch.softmax(log_proj, dim=-1), chunk_v)[:, :, 0]
        # local keys: [previous block (halo) | current block]
        if self.ext_size > 0:
            keys, vals = torch.cat([prev_k, cur_k], dim=2), torch.cat([prev_v, cur_v], dim=2)
            slot = torch.arange(-w, w, device=q.device)
        else:
            keys, vals = cur_k, cur_v
            slot = torch.arange(0, w, device=q.device)
        global_pos = t - i + slot
        valid = (global_pos >= 0) & (global_pos <= t)
        local = (torch.einsum("bhod,bhjd->bhoj", q, keys) * self.scaling).to(q.dtype)
        bias = self._t5_bias()
        if bias is not None:
            local = local + bias[i].to(local.dtype)
        local = local.masked_fill(~valid, MASK_VAL)
        chunk = torch.einsum("bhod,bhcd->bhoc", q, self.scaling * rf_k_bar)
        chunk_valid = torch.arange(chunk.shape[-1], device=q.device) < t // cs
        chunk = chunk.masked_fill(~chunk_valid, MASK_VAL)
        attn = torch.softmax(torch.cat([local, chunk.to(local.dtype)], dim=-1), dim=-1)
        J = local.shape[-1]
        out = (torch.einsum("bhoj,bhjd->bhod", attn[..., :J], vals)
               + torch.einsum("bhoc,bhcd->bhod", attn[..., J:], beta))
        x = self.out_proj(out.transpose(1, 2).reshape(B, 1, C))
        if c_fill == cs - 1:  # reset the accumulators once dumped
            for acc in (chunk_q, chunk_k, chunk_v):
                acc.zero_()
        return x, EvaDecodeState(t + 1, prev_k, prev_v, cur_k, cur_v, chunk_q,
                                 chunk_k, chunk_v, rf_k_bar, beta)

    @staticmethod
    def add_attn_specific_args(parent_parser, struct_name="attn_args", prefix=""):
        from efficient_attention_torch.config import add_nested_argument

        parser = parent_parser.add_argument_group("attention")
        p = prefix + "-" if len(prefix) > 1 else ""
        add_nested_argument(parser, f"--{p}adaptive-proj", struct_name=struct_name,
                            prefix=prefix, default="qk", type=str)
        add_nested_argument(parser, f"--{p}num-chunks", struct_name=struct_name,
                            prefix=prefix, default=None, type=int)
        add_nested_argument(parser, f"--{p}chunk-size", struct_name=struct_name,
                            prefix=prefix, default=None, type=int)
        add_nested_argument(parser, f"--{p}causal", action="store_true",
                            struct_name=struct_name, prefix=prefix, default=False)
        add_nested_argument(parser, f"--{p}use-t5-rpe", action="store_true",
                            struct_name=struct_name, prefix=prefix, default=False)
        add_nested_argument(parser, f"--{p}window-size", struct_name=struct_name,
                            prefix=prefix, default=4, type=int)
        add_nested_argument(parser, f"--{p}overlap-window", action="store_true",
                            struct_name=struct_name, prefix=prefix, default=False)
        add_nested_argument(parser, f"--{p}impl", struct_name=struct_name,
                            prefix=prefix, default="auto", type=str,
                            choices=["auto", "xla", "packed"])
        return parent_parser

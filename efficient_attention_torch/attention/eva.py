"""EVA: control-variate fusion of exact local attention and RF global attention.

PyTorch counterpart of ``efficient_attention_tpu/attention/eva.py``
(reference ``efficient-attention/efficient_attention/eva.py``, ICLR 2023):

  1. blocked local attention over 2-D windows with learned RPE,
  2. chunked random-feature global attention: per-chunk adaptive proposal
     ``mu = (mu_q(mean q) + mu_k(mean k)) / 2``, one RF sample
     ``w ~ N(mu, I)`` in training (its mean at eval), and a per-chunk SNIS
     value summary ``beta``,
  3. one softmax over ``[local logits | chunk logits]`` (``eva.py:222-227``).

The 2-D forward without halo or padding mask follows the JAX dispatch
order (``eva.py:542-593``), in training and eval, with JAX's four eval
toggles (``eva.py:88-122``).  In eval, ``impl='auto'`` (or ``'packed'``)
takes, in this order, where each route's gate holds:

1. with ``use_single_kernel`` (default True), the single-pass
   ``eva_single`` kernel (K2);
2. with ``use_megakernel``, the two ``eva_mega`` kernels (K10), which read
   the tokens and project qkv inside (``_forward_mega``).  K2 is tried first,
   so ``use_megakernel`` alone still runs K2 where K2's gate holds;
3. the packed path: the chunk summaries by the ``eva_summaries`` kernel (K8)
   with ``use_pallas_summaries``, else by tensor ops; then, with
   ``fuse_output_proj``, the ``eva_packed_out`` kernel (K9, the output
   projection inside), else ``eva_packed`` (K1) and the projection;
4. the eager tensor-op path.

In training every toggle is ignored, as in JAX: K1 where its gate holds.
Where the packed path does not engage (or ``impl`` is ``'pallas'`` or
``'rowmajor'``), the route goes on as JAX's does (``eva.py:595-793``): the
projection, the natural-layout chunk summaries, then the joint softmax by
the ``eva_rowmajor`` kernel (K12) on the token-order q, k, v with
``impl='rowmajor'`` where its gate holds, else by the ``eva_kernel`` kernel
(K11) on the partitioned windows for ``impl`` in ``auto``, ``pallas`` and
``rowmajor`` where attention dropout is 0 and its gate holds, in training
and at eval alike, else by the eager tensor ops.  ``impl='xla'`` (the JAX
package's name for the plain path) forces the eager path;
``impl='packed'`` raises ``ValueError`` where K1's gate fails, and
``impl='pallas'`` before any compute where K11 cannot run.  The RF noise is
drawn from ``self.generator``, which the train step sets.  A T5 bias
(``use_t5_rpe``) takes the learned table's place in every route.

A 2-D grid with a halo (``overlap_window``) or a key-padding mask runs
eager, as in JAX, whose kernel gates all require ``padding_free`` and no
halo (``eva.py:543-549, 595-606``): the chunk summaries over chunks halo'd
like the windows, their padded and out-of-grid slots zeroed and masked
(``eva.py:649-688``), then the joint softmax with the masked local logits
replaced by ``MASK_VAL`` (``eva.py:804-834``); ``impl='packed'`` and
``impl='pallas'`` raise ``ValueError`` there.

The 1-D forward (the WMT encoder's) is ported too: the sequence is padded to
a window multiple, the chunk summaries come from chunks halo'd by ``ext`` on
both sides with their padded slots zeroed (``eva.py:649-688``), the local
windows carry the same halo, a key-padding mask and a T5 (non-causal,
``T5RelativePositionBias``) or learned bias.  In eval, ``impl='auto'`` (or
``'packed'``) takes the ``eva_1d`` kernel (K4) where its gate holds,
whatever ``attn_drop`` is (attention dropout is off at eval; the JAX gate's
``attn_drop == 0`` test keeps the WMT recipe's encoder off its kernel,
ROADMAP.md Queue 3); ``impl='packed'`` raises ``ValueError`` where that gate
fails.  Otherwise K11 takes the windows, for ``impl`` in ``auto``,
``pallas`` and ``rowmajor``, where the input is free of padding (no mask
given and no padding to a window multiple), there is no halo, attention
dropout is 0 and its gate holds (``impl='pallas'`` raises where not); else
the eager twin runs.  Sequence parallelism is not ported yet and raises
``NotImplementedError`` naming ROADMAP.md Queue 1, item 7.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from efficient_attention_torch.attention.base import MASK_VAL
from efficient_attention_torch.attention.causal_eva import T5RelativePositionBias
from efficient_attention_torch.attention.local import LocalAttention
from efficient_attention_torch.ops.kernels.eva_1d import eva_attention_1d, supports_1d
from efficient_attention_torch.ops.kernels.eva_kernel import (
    eva_attention_fused,
    supports_fused,
)
from efficient_attention_torch.ops.kernels.eva_mega import (
    eva_attention_from_x,
    eva_summaries_from_x,
    supports_mega,
)
from efficient_attention_torch.ops.kernels.eva_packed import (
    eva_attention_packed,
    eva_attention_packed_out,
    supports_packed,
    supports_packed_out,
)
from efficient_attention_torch.ops.kernels.eva_rowmajor import (
    eva_attention_rowmajor,
    supports_rowmajor,
)
from efficient_attention_torch.ops.kernels.eva_single import (
    eva_attention_single,
    supports_single,
)
from efficient_attention_torch.ops.kernels.eva_summaries import (
    eva_summaries_packed,
    supports_summaries,
)
from efficient_attention_torch.ops.random_features import prm_projection
from efficient_attention_torch.ops.rpe import t5_bucket_table

IMPLS = ("auto", "packed", "pallas", "rowmajor", "xla")


def _adaptive_proj(head_dim: int, with_ln: bool) -> nn.Sequential:
    layers = [nn.Linear(head_dim, head_dim)]
    if with_ln:
        layers.append(nn.LayerNorm(head_dim, eps=1e-6))
    return nn.Sequential(*layers)


class EVA(LocalAttention):
    """EVA attention (``eva.py:68-243``).

    Extra args over :class:`LocalAttention`:
      * ``adaptive_proj``: ``default`` (Linear+LN) / ``no-ln`` / ``none``
      * ``num_landmarks``: number of global RF chunks
      * ``use_t5_rpe``: the T5-style local bias instead of the learned
        table
      * ``impl``: ``auto`` (the kernels where their gates allow, else
        eager), ``packed`` (the kernels, raising where the gate of K1, or
        in 1-D of K4, fails), ``pallas`` (K11, raising where it cannot
        run), ``rowmajor`` (2-D: K12, else as ``pallas`` without raising)
        or ``xla`` (eager)
      * the 2-D eval routes, JAX's defaults (``eva.py:88-122``):
        ``use_single_kernel`` (True: K2), ``use_megakernel`` (K10),
        ``use_pallas_summaries`` (K8), ``fuse_output_proj`` (K9)

    ``generator`` (None: torch's default one) draws the RF noise in
    training.
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 fp32: bool = False, use_rpe: bool = False,
                 window_size: int = 2, attn_2d: bool = False,
                 overlap_window: bool = False, adaptive_proj: str = "default",
                 num_landmarks: int = 49, use_t5_rpe: bool = False,
                 impl: str = "auto", seq_axis: Optional[str] = None,
                 use_pallas_summaries: bool = False,
                 fuse_output_proj: bool = False, use_megakernel: bool = False,
                 use_single_kernel: bool = True):
        super().__init__(dim, num_heads, qkv_bias=qkv_bias,
                         attn_drop=attn_drop, proj_drop=proj_drop, fp32=fp32,
                         use_rpe=use_rpe, window_size=window_size,
                         attn_2d=attn_2d, overlap_window=overlap_window)
        if use_rpe and use_t5_rpe:
            raise NotImplementedError(
                "Default RPE and T5-style RPE cannot be enabled simultaneously.")
        if seq_axis is not None:
            raise NotImplementedError(
                "sequence-parallel EVA is not ported yet; see ROADMAP.md "
                "Queue 1, item 7")
        if impl not in IMPLS:
            raise ValueError(f"unknown EVA impl {impl!r}; use one of {IMPLS}")
        self.adaptive_proj = adaptive_proj
        self.num_landmarks = num_landmarks
        self.use_t5_rpe = use_t5_rpe
        self.impl = impl
        self.use_pallas_summaries = use_pallas_summaries
        self.fuse_output_proj = fuse_output_proj
        self.use_megakernel = use_megakernel
        self.use_single_kernel = use_single_kernel
        self.generator: Optional[torch.Generator] = None
        d = self.head_dim
        if adaptive_proj in ("default", "no-ln"):
            self.adaptive_mu_q = _adaptive_proj(d, adaptive_proj == "default")
            self.adaptive_mu_k = _adaptive_proj(d, adaptive_proj == "default")
        elif adaptive_proj == "none":
            self.adaptive_mu_k = _adaptive_proj(d, True)
        else:
            raise NotImplementedError(f"adaptive_proj={adaptive_proj}")
        if use_t5_rpe:
            span = window_size + self.ext_size
            num_buckets = max(min(span // 2, 64), 16)
            self.rel_pos_bias = T5RelativePositionBias(num_buckets, num_heads)
            # bidirectional buckets of each (window row, halo'd key slot),
            # not shifted by the halo, over the slots' flat indices in 2-D
            # too (``eva.py:398-400, 753-755, 805-806``)
            w, e = window_size, self.ext_size
            rows, keys = (w * w, (w + 2 * e) ** 2) if attn_2d else (w, w + 2 * e)
            self.register_buffer("t5_buckets", torch.from_numpy(t5_bucket_table(
                rows, keys, causal=False, num_buckets=num_buckets,
                max_distance=span).astype(np.int64)), persistent=False)

    def window_bias(self) -> Optional[torch.Tensor]:
        """The local bias of a window (the T5 table times ``scale``, or the
        learned table), or None: in 1-D ``[H, ws, ws + 2*ext]``, in 2-D
        ``[H, ws*ws, (ws + 2*ext)**2]``."""
        if not self.use_t5_rpe:
            return super().window_bias()
        table = self.rel_pos_bias.relative_attention_bias.weight
        return self.heads_of(table[self.t5_buckets].permute(2, 0, 1)) * self.scale

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """EVA forward (``eva.py:490-840``) over a ``[B, H, W, C]`` token grid
        or, in 1-D, a ``[B, N, C]`` sequence, with an optional ``[B, N]``
        key-padding mask (True = pad); training mode samples the RF
        weights."""
        if not self.attn_2d:
            return self._forward_1d(x, key_padding_mask)
        if x.dim() != 4:
            raise ValueError(f"2-D EVA takes [B, H, W, C], got {tuple(x.shape)}")
        B, gh, gw, C = x.shape
        ws = self.window_size
        if ws <= 0 or gh % ws or gw % ws:
            raise ValueError(f"grid {gh}x{gw} is not divisible by window {ws}")
        N = gh * gw
        j = int(math.sqrt(N // self.num_landmarks))
        if j == 0:
            raise ValueError(
                f"num_landmarks={self.num_landmarks} exceeds the sequence "
                f"length {N}; the RF chunk size would be 0")
        if gh % j or gw % j:
            raise ValueError(f"grid {gh}x{gw} is not divisible by chunk {j}")
        if key_padding_mask is not None or self.ext_size:
            return self._forward_masked_2d(x, key_padding_mask, j)
        kernels = self.impl in ("auto", "packed")
        chunk_ok = j * j * self.num_landmarks == N
        at_eval = kernels and chunk_ok and not self.training
        if (at_eval and self.use_single_kernel
                and supports_single(B, gh, gw, ws, j, self.adaptive_proj,
                                    3 * C, self.num_heads, x.element_size())):
            return self._forward_single(x, j)
        if (at_eval and self.use_megakernel and self.local_heads is None
                and supports_mega(B, gh, gw, ws, j, self.num_landmarks,
                                  self.adaptive_proj, C, self.num_heads,
                                  x.element_size())):
            return self._forward_mega(x, j)
        if (kernels and chunk_ok and self.attn_dropout.p == 0.0
                and supports_packed(B, N, gw, ws, self.num_landmarks,
                                    self.head_dim, x.element_size(),
                                    self.num_heads)):
            return self._forward_packed(x, j)
        if self.impl == "packed":
            raise ValueError(
                "impl='packed' requires square windows and chunks dividing "
                "the grid, attn_drop=0 and a geometry within the eva_packed "
                "kernel's gate (supports_packed)")
        S = ws * ws
        fused = self.impl != "xla" and self._fused_ok(
            B, N // S, S, (gh // j) * (gw // j), x.element_size())
        if self.impl == "pallas" and not fused:
            raise ValueError(
                "impl='pallas' requires attn_drop=0 and a geometry within the "
                "eva_kernel kernel's gate (supports_fused)")
        return self._forward_windows(x, j, fused)

    def _fused_ok(self, B: int, G: int, S: int, C: int, itemsize: int) -> bool:
        """Whether K11 can take G windows of S tokens and C chunks: no
        attention dropout and the kernel's gate (``eva.py:696-703, 773``)."""
        return self.attn_dropout.p == 0.0 and supports_fused(
            B, G, S, C, self.head_dim, itemsize, self.num_heads)

    def _forward_single(self, x: torch.Tensor, j: int) -> torch.Tensor:
        """Single-pass eval path: one ``eva_single`` launch computes the
        chunk summaries and the joint softmax from the packed qkv."""
        B, gh, gw, C = x.shape
        qkv = self.qkv(x.reshape(B, gh * gw, C))  # [B, N, 3*H*D]
        out = eva_attention_single(
            qkv, *self._adaptive_weights(), self.scale, self.num_heads, gw,
            self.window_size, j, self.adaptive_proj == "default",
            bias=self.window_bias())
        return self.proj_dropout(self.proj(out.reshape(B, gh, gw, -1)))

    def _adaptive_weights(self):
        """``(wq, bq, wk, bk, lnq_scale, lnq_bias, lnk_scale, lnk_bias)`` of
        the adaptive Dense (``[in, out]``, JAX's layout) and LN, as the eval
        kernels take them; the LN four None for ``adaptive_proj='no-ln'``."""
        mq, mk = self.adaptive_mu_q, self.adaptive_mu_k
        use_ln = self.adaptive_proj == "default"
        return (mq[0].weight.t(), mq[0].bias, mk[0].weight.t(), mk[0].bias,
                mq[1].weight if use_ln else None, mq[1].bias if use_ln else None,
                mk[1].weight if use_ln else None, mk[1].bias if use_ln else None)

    def _forward_mega(self, x: torch.Tensor, j: int) -> torch.Tensor:
        """Megakernel eval path (``eva.py:298-331``): the summaries and the
        attention (with the output projection) both read the tokens and
        project qkv inside the two ``eva_mega`` kernels; qkv never reaches
        device memory."""
        B, gh, gw, C = x.shape
        xf = x.reshape(B, gh * gw, C)
        w_qkv, b_qkv = self.qkv.weight.t(), self.qkv.bias
        if b_qkv is None:  # qkv_bias=False: a zero bias (eva.py:312-314)
            b_qkv = torch.zeros(w_qkv.shape[1], dtype=torch.float32,
                                device=x.device)
        rf_k_bar, beta = eva_summaries_from_x(
            xf, w_qkv, b_qkv, *self._adaptive_weights(), self.num_heads, gw, j,
            self.adaptive_proj == "default")
        out = eva_attention_from_x(
            xf, w_qkv, b_qkv, rf_k_bar, beta, self.proj.weight.t(),
            self.proj.bias, self.scale, self.num_heads, gw, self.window_size,
            bias=self.window_bias())
        return self.proj_dropout(out.reshape(B, gh, gw, C))

    def _sample_weights(self, mu: torch.Tensor) -> torch.Tensor:
        """One RF sample ``w ~ N(mu, I)`` in training, drawn from
        ``self.generator``; ``mu`` itself at eval (``eva.py:411-416``)."""
        if not self.training:
            return mu
        return mu + torch.randn(mu.shape, generator=self.generator,
                                dtype=mu.dtype, device=mu.device)

    def _forward_packed(self, x: torch.Tensor, j: int) -> torch.Tensor:
        """Packed path (``eva.py:359-393``): the fused qkv projection, the
        chunk summaries read from its packed output, the ``eva_packed``
        kernel, the output projection; no head transpose or window
        partition in between.  At eval with ``fuse_output_proj`` the
        ``eva_packed_out`` kernel does the last two where its gate holds."""
        B, gh, gw, C = x.shape
        qkv = self.qkv(x.reshape(B, gh * gw, C))  # [B, N, 3*H*D]
        rf_k_bar, beta = self._summaries_dispatch(qkv, (gh, gw), j)
        if (not self.training and self.fuse_output_proj
                and self.local_heads is None
                and supports_packed_out(B, gh * gw, gw, self.window_size,
                                        self.num_landmarks, self.head_dim,
                                        x.element_size(), self.num_heads)):
            out = eva_attention_packed_out(
                qkv, rf_k_bar, beta, self.proj.weight.t(), self.proj.bias,
                self.scale, self.num_heads, gw, self.window_size,
                bias=self.window_bias())
            return self.proj_dropout(out.reshape(B, gh, gw, C))
        out = eva_attention_packed(qkv, rf_k_bar, beta, self.scale,
                                   self.num_heads, gw, self.window_size,
                                   bias=self.window_bias())
        return self.proj_dropout(self.proj(out.reshape(B, gh, gw, -1)))

    def _summaries_dispatch(self, qkv: torch.Tensor, seq_shape: Tuple[int, int],
                            j: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The packed chunk summaries (``eva.py:159-194``): at eval with
        ``use_pallas_summaries`` the ``eva_summaries`` kernel where its gate
        holds, else ``_chunk_summaries_packed``."""
        gh, gw = seq_shape
        if (not self.training and self.use_pallas_summaries
                and supports_summaries(qkv.shape[0], gh, gw, j,
                                       self.adaptive_proj, qkv.shape[-1],
                                       self.num_heads, qkv.element_size())):
            return eva_summaries_packed(qkv, *self._adaptive_weights(),
                                        self.num_heads, gw, j,
                                        self.adaptive_proj == "default")
        return self._chunk_summaries_packed(qkv, seq_shape, j)

    def _chunk_summaries_packed(self, qkv: torch.Tensor,
                                seq_shape: Tuple[int, int], j: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Chunk summaries ``(rf_k_bar, beta)``, each packed ``[B, C, H*D]``,
        read from the packed ``[B, N, 3*H*D]`` projection output by the
        training form of ``eva.py:196-296``: every chunk reduction is a
        product with the 0/1 chunk-membership matrix ``P [C, N]``, and the
        per-chunk softmax of ``<w, k>/sqrt(d) - |k|^2/(2 sqrt(d))`` over the
        chunk's members is shifted by its true maximum.  At eval ``w = mu``,
        which is the same function as the JAX eval form."""
        nh, d = self.num_heads, self.head_dim
        hd = nh * d
        B, N, _ = qkv.shape
        gh, gw = seq_shape
        hc, wc = gh // j, gw // j
        c = hc * wc
        # static chunk membership [C, N]: token (y, x) -> chunk (y//j, x//j)
        t = torch.arange(N, device=qkv.device)
        chunk_of = (t // (gw * j)) * wc + (t % gw) // j
        P = (chunk_of[None, :] == torch.arange(c, device=qkv.device)[:, None]
             ).to(qkv.dtype)
        P_mean = P / float(j * j)
        qf, kf, vf = qkv.split(hd, dim=-1)
        k_mean = (P_mean @ kf).reshape(B, c, nh, d)
        if self.adaptive_proj in ("default", "no-ln"):
            q_mean = (P_mean @ qf).reshape(B, c, nh, d)
            rf_k_bar = self.adaptive_mu_k(k_mean)
            mu = 0.5 * (self.adaptive_mu_q(q_mean) + rf_k_bar)
        else:
            rf_k_bar = self.adaptive_mu_k(k_mean)
            mu = torch.zeros_like(rf_k_bar)
        weights = self._sample_weights(mu)  # [B, C, nh, d]
        # log phi(k)[n] = <w_chunk(n), k_n>/sqrt(d) - |k_n|^2/(2 sqrt(d))
        dn = d ** -0.5
        w_tok = P.t() @ weights.reshape(B, c, hd).to(P.dtype)  # [B, N, HD]
        k4 = kf.reshape(B, N, nh, d).float()
        dash = dn * (k4 * w_tok.reshape(B, N, nh, d).float()).sum(-1)
        logp = dash - (0.5 * dn) * k4.square().sum(-1)  # [B, N, nh]
        Pf = P.float()
        m_c = logp.reshape(B, hc, j, wc, j, nh).amax(dim=(2, 4))
        p = torch.exp(logp - Pf.t() @ m_c.reshape(B, c, nh))
        denom = Pf @ p  # [B, C, nh]
        pv = (p[..., None].to(qkv.dtype)
              * vf.reshape(B, N, nh, d)).reshape(B, N, hd)
        beta = (P @ pv).reshape(B, c, nh, d) / denom[..., None]
        return rf_k_bar.reshape(B, c, hd), beta.to(qkv.dtype).reshape(B, c, hd)

    def _chunk_summaries_natural(self, q, k, v, seq_shape: Tuple[int, int],
                                 j: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Chunk summaries ``(rf_k_bar, beta)``, each ``[b, h, c, d]``, from
        ``[b, h, n, d]`` q/k/v (``eva.py:150-196`` with no padding)."""
        nh, d = self.num_heads, self.head_dim
        B = q.shape[0]
        gh, gw = seq_shape
        hc, wc = gh // j, gw // j
        c = hc * wc

        def chunked(t):
            return t.reshape(B, nh, hc, j, wc, j, d)

        k6 = chunked(k)
        k_mean = k6.mean(dim=(3, 5)).reshape(B, nh, c, d)
        if self.adaptive_proj in ("default", "no-ln"):
            q_mean = chunked(q).mean(dim=(3, 5)).reshape(B, nh, c, d)
            rf_q_bar = self.adaptive_mu_q(q_mean)
            rf_k_bar = self.adaptive_mu_k(k_mean)
            mu = 0.5 * (rf_q_bar + rf_k_bar)
        else:
            rf_k_bar = self.adaptive_mu_k(k_mean)
            mu = torch.zeros_like(rf_k_bar)
        w6 = self._sample_weights(mu).reshape(B, nh, hc, wc, d).float()
        # log phi(k)[c, j] = <w_c, k_j>/sqrt(d) - |k_j|^2/(2 sqrt(d)),
        # softmax-normalised over each chunk's members with the true max
        dn = d ** -0.5
        k6f = k6.float()
        dash = dn * torch.einsum("bhaicjd,bhacd->bhaicj", k6f, w6)
        norm = (0.5 * dn) * k6f.square().sum(-1)
        logp = dash - norm  # [b, h, hc, j, wc, j]
        p = torch.exp(logp - logp.amax(dim=(3, 5), keepdim=True))
        p = p / p.sum(dim=(3, 5), keepdim=True)
        beta = torch.einsum("bhaicj,bhaicjd->bhacd", p.to(v.dtype),
                            chunked(v)).reshape(B, nh, c, d)
        return rf_k_bar, beta

    def _forward_windows(self, x: torch.Tensor, j: int, fused: bool
                         ) -> torch.Tensor:
        """The route after the packed path (``eva.py:612-840``): natural-
        layout summaries, then the joint softmax over ``[window keys | chunk
        keys]``: with ``impl='rowmajor'`` by K12 on the token-order q, k, v
        where its gate holds, else by K11 on the partitioned windows where
        ``fused``, else by the eager tensor ops."""
        B, gh, gw, C = x.shape
        seq_shape = (gh, gw)
        ws = self.window_size
        q, k, v = self.proj_and_split_heads(x)
        rf_k_bar, beta = self._chunk_summaries_natural(q, k, v, seq_shape, j)
        if (self.impl == "rowmajor" and self.attn_dropout.p == 0.0
                and supports_rowmajor(B, gh * gw, gw, ws, rf_k_bar.shape[2],
                                      self.head_dim, x.element_size(),
                                      self.num_heads)):
            output = eva_attention_rowmajor(q, k, v, rf_k_bar, beta, self.scale,
                                            gw, ws, bias=self.window_bias())
        else:
            w_q, w_k, w_v = (self.window_partition(t, seq_shape) for t in (q, k, v))
            if fused:
                output = eva_attention_fused(w_q, w_k, w_v, rf_k_bar, beta,
                                             self.scale, self.window_bias())
            else:
                output = self._joint_eager(w_q, w_k, w_v, rf_k_bar, beta)
            output = self.window_merge(output, seq_shape)
        x = output.transpose(1, 2).reshape(B, gh, gw, -1)
        return self.proj_dropout(self.proj(x))

    def _joint_eager(self, w_q, w_k, w_v, rf_k_bar, beta) -> torch.Tensor:
        """The eager 2-D joint softmax over ``[window keys | chunk keys]``
        (``eva.py:795-834``), ``[B, H, G, S, D]``."""
        rfa_chunk = torch.einsum("bhwid,bhcd->bhwic", w_q,
                                 (self.scale * rf_k_bar).to(w_q.dtype))
        local = (torch.einsum("bhwie,bhwje->bhwij", w_q, w_k)
                 * self.scale).to(w_q.dtype)
        if self.rpe_enabled or self.use_t5_rpe:
            local = self.add_rel_pos_bias(local)
        local_len = local.shape[-1]
        attn = F.softmax(torch.cat([local, rfa_chunk.to(local.dtype)], dim=-1),
                         dim=-1).to(w_v.dtype)
        return (torch.einsum("bhwij,bhwjd->bhwid", attn[..., :local_len], w_v)
                + torch.einsum("bhwic,bhcd->bhwid", attn[..., local_len:],
                               beta.to(w_v.dtype)))

    def _forward_1d(self, x: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """1-D forward of a ``[B, N, C]`` sequence: padded to a window
        multiple with its mask (``eva.py:506-520``), chunk summaries over
        halo'd, masked chunks, then K4 at eval where its gate holds, else K11
        on padding-free input without halo where its gate holds, else the
        eager twin."""
        B, orig_n, C = x.shape
        ws, ext = self.window_size, self.ext_size
        if ws <= 0:
            raise ValueError("1-D EVA needs a window_size > 0")
        mask_given = key_padding_mask is not None
        # an all-False mask where there was none: the same function as the
        # JAX module's mask-free forms (eva.py:469-488, 809)
        x, key_padding_mask, (N,) = self._process_input(x, key_padding_mask)
        j = N // self.num_landmarks
        if j == 0:
            raise ValueError(
                f"num_landmarks={self.num_landmarks} exceeds the (padded) "
                f"sequence length {N}; the RF chunk size would be 0")
        # JAX's padding_free: no mask given and none made by the padding to
        # a window multiple (eva.py:506-523)
        padding_free = not mask_given and N == orig_n
        fused = (self.impl in ("auto", "pallas", "rowmajor") and padding_free
                 and ext == 0
                 and self._fused_ok(B, N // ws, ws, N // j, x.element_size()))
        if self.impl == "pallas" and not fused:
            raise ValueError(
                "impl='pallas' requires no halo, no padding mask, a sequence "
                "that needs no padding to a window multiple, attn_drop=0 and a "
                "geometry within the eva_kernel kernel's gate (supports_fused)")
        H, d = self.num_heads, self.head_dim
        qkv = self.qkv(x)  # [B, N, 3*H*D]
        q, k, v = qkv.reshape(B, N, 3, H, d).permute(2, 0, 3, 1, 4).unbind(0)
        rf_k_bar, beta = self._chunk_summaries_masked(q, k, v, key_padding_mask,
                                                      (N,), j)
        if (self.impl in ("auto", "packed") and not self.training
                and supports_1d(B, N, ws, ext, rf_k_bar.shape[2], H, d,
                                x.element_size())):
            def pack(t):  # [B, H, n, d] -> [B, n, H*d]
                return t.transpose(1, 2).reshape(B, -1, H * d)

            out = eva_attention_1d(qkv, pack(rf_k_bar), pack(beta),
                                   key_padding_mask, self.scale, H, ws, ext,
                                   bias=self.window_bias())
            return self.proj_dropout(self.proj(out)[:, :orig_n])
        if self.impl == "packed":
            raise ValueError(
                "impl='packed' requires eval mode and a geometry within the "
                "eva_1d kernel's gate (supports_1d)")
        if fused:
            w_q, w_k, w_v = (self.window_partition(t, None) for t in (q, k, v))
            out = eva_attention_fused(w_q, w_k, w_v, rf_k_bar, beta, self.scale,
                                      self.window_bias())
            out = self.window_merge(out, None).transpose(1, 2).reshape(B, N, H * d)
            return self.proj_dropout(self.proj(out))
        return self._forward_eager_masked(q, k, v, rf_k_bar, beta,
                                          key_padding_mask, (N,), orig_n)

    def _forward_masked_2d(self, x: torch.Tensor,
                           key_padding_mask: Optional[torch.Tensor],
                           j: int) -> torch.Tensor:
        """The eager 2-D forward with a halo or a key-padding mask
        (``eva.py:643-688, 767-840``): no kernel gate admits either."""
        if self.impl in ("packed", "pallas"):
            raise ValueError(
                f"impl={self.impl!r} requires no halo and no padding mask in 2-D")
        B, gh, gw, C = x.shape
        q, k, v = self.proj_and_split_heads(x)
        if key_padding_mask is None:
            key_padding_mask = torch.zeros(B, gh * gw, dtype=torch.bool,
                                           device=x.device)
        rf_k_bar, beta = self._chunk_summaries_masked(q, k, v, key_padding_mask,
                                                      (gh, gw), j)
        out = self._forward_eager_masked(q, k, v, rf_k_bar, beta,
                                         key_padding_mask, (gh, gw), gh * gw)
        return out.reshape(B, gh, gw, C)

    def _chunk_summaries_masked(self, q, k, v, key_padding_mask, seq_shape,
                                j: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Chunk summaries ``(rf_k_bar, beta)``, each ``[B, H, C, d]``, of
        chunks of ``j`` tokens (``j x j`` in 2-D) halo'd by ``ext`` on every
        side (``eva.py:649-688``): padded and out-of-range slots are zeroed
        but still count in the means' denominators, and their prm
        log-densities are ``MASK_VAL`` before the softmax."""
        part = functools.partial(self.window_partition, shape=seq_shape,
                                 window_size=j, ext_window_size=self.ext_size)
        kpm = key_padding_mask.to(q.dtype)[:, None, :, None]
        mask = part(kpm, pad_val=1.0).bool()  # [B, 1, C, slots, 1]
        rf_q, rf_k, rf_v = (part(t).masked_fill(mask, 0.0)  # [B, H, C, slots, d]
                            for t in (q, k, v))
        rf_k_bar = self.adaptive_mu_k(rf_k.mean(dim=-2))
        if self.adaptive_proj in ("default", "no-ln"):
            mu = 0.5 * (self.adaptive_mu_q(rf_q.mean(dim=-2)) + rf_k_bar)
        else:
            mu = torch.zeros_like(rf_k_bar)
        weights = self._sample_weights(mu)
        log_proj = prm_projection(rf_k, weights[..., None, :],
                                  normalize=False)[..., 0, :]  # [B, H, C, slots]
        log_proj = log_proj.masked_fill(mask[..., 0], MASK_VAL)
        beta = torch.einsum("...cj,...cjd->...cd", torch.softmax(log_proj, dim=-1),
                            rf_v)
        return rf_k_bar, beta

    def _forward_eager_masked(self, q, k, v, rf_k_bar, beta, key_padding_mask,
                              seq_shape, orig_n: int) -> torch.Tensor:
        """Eager path (``eva.py:767-840``): the joint softmax over
        ``[halo'd window keys | chunk keys]``, masked local logits replaced
        by ``MASK_VAL``; ``[B, orig_n, C]``."""
        B, H, N, d = q.shape
        ext = self.ext_size
        w_q = self.window_partition(q, seq_shape)
        w_k = self.window_partition(k, seq_shape, ext_window_size=ext)
        w_v = self.window_partition(v, seq_shape, ext_window_size=ext)
        rfa_chunk = torch.einsum("bhwid,bhcd->bhwic", w_q,
                                 (self.scale * rf_k_bar).to(w_q.dtype))
        local = (torch.einsum("bhwie,bhwje->bhwij", w_q, w_k)
                 * self.scale).to(q.dtype)
        bias = self.window_bias()
        if bias is not None:
            local = local + bias.to(local.dtype)[None, :, None]
        local = local.masked_fill(
            self.local_mask(key_padding_mask, seq_shape, q.dtype), MASK_VAL)
        local_len = local.shape[-1]
        attn = F.softmax(torch.cat([local, rfa_chunk.to(local.dtype)], dim=-1),
                         dim=-1).to(w_v.dtype)
        output = (torch.einsum("bhwij,bhwjd->bhwid", attn[..., :local_len], w_v)
                  + torch.einsum("bhwic,bhcd->bhwid", attn[..., local_len:],
                                 beta.to(w_v.dtype)))
        x = self.window_merge(output, seq_shape).transpose(1, 2).reshape(B, N, H * d)
        return self.proj_dropout(self.proj(x)[:, :orig_n])

    @staticmethod
    def add_attn_specific_args(parent_parser, struct_name="attn_args", prefix=""):
        from efficient_attention_torch.config import add_nested_argument

        parent_parser = LocalAttention.add_attn_specific_args(
            parent_parser, struct_name=struct_name, prefix=prefix
        )
        parser = parent_parser.add_argument_group("attention")
        p = prefix + "-" if len(prefix) > 1 else ""
        add_nested_argument(parser, f"--{p}adaptive-proj", struct_name=struct_name,
                            prefix=prefix, default="default", type=str)
        add_nested_argument(parser, f"--{p}num-landmarks", struct_name=struct_name,
                            prefix=prefix, default=49, type=int)
        add_nested_argument(parser, f"--{p}use-t5-rpe", action="store_true",
                            struct_name=struct_name, prefix=prefix, default=False)
        return parent_parser

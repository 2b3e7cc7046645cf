"""Blocked local (window) attention, 1-D and 2-D, with halos and a learned
relative-position bias.

PyTorch counterpart of ``efficient_attention_tpu/attention/local.py``
(reference ``local_attention.py:25-182``): windows of ``window_size``
tokens (``w x w`` in 2-D), the keys of each extended by a halo of
``ext_size`` positions on every side with ``overlap_window``, a learned
table of ``[H, w, w + 2*ext]`` in 1-D or a 2-D index into a shared table
(``local_2d_rpe_index``), and a key-padding mask.  A 1-D sequence is
padded to a window multiple, its padding masked, and the output cut back to
its length (JAX ``local.py:109-131, 172-228``).  Without a padding mask,
halo or attention dropout, ``impl='auto'`` takes the packed window kernel
K7 (``ops/kernels/local_packed.py``) on a 2-D grid where its geometry gate
holds, in training too (JAX ``local.py:134-170``, there on the TPU only;
here the CPU takes the kernel's plain version); ``impl='xla'`` keeps the
eager windowed einsums.

``LocalWindows`` holds the window and bias machinery apart from the
attention itself, so that ScatterBrain shares it with its Performer base.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from efficient_attention_torch.attention.base import MASK_VAL, MultiheadAttention
from efficient_attention_torch.ops import windows as W
from efficient_attention_torch.ops.kernels.local_packed import (
    local_attention_packed,
    supports_packed,
)
from efficient_attention_torch.ops.rpe import local_2d_rpe_index


class LocalWindows:
    """Windows, halos and the learned local bias of a ``MultiheadAttention``
    (``local_attention.py:25-131``); ``_init_windows`` is called from the
    module's ``__init__``."""

    def _init_windows(self, use_rpe: bool, window_size: int, attn_2d: bool,
                      overlap_window: bool) -> None:
        self.use_rpe = use_rpe
        self.window_size = window_size
        self.attn_2d = attn_2d
        self.overlap_window = overlap_window
        if not self.rpe_enabled:
            return
        w, e = window_size, self.ext_size
        if attn_2d:
            index, table_size = local_2d_rpe_index(w, e)
            self.register_buffer("relative_position_index",
                                 torch.from_numpy(index).long())
            shape = (table_size, self.num_heads)
        else:
            shape = (self.num_heads, w, w + 2 * e)
        self.local_relative_position_bias_table = nn.Parameter(torch.zeros(shape))
        nn.init.trunc_normal_(self.local_relative_position_bias_table, std=0.02)

    @property
    def ext_size(self) -> int:
        # ``local_attention.py:38-41``
        return max(1, self.window_size // 2) if self.overlap_window else 0

    @property
    def rpe_enabled(self) -> bool:
        return self.use_rpe and self.window_size > 0

    def window_bias(self) -> Optional[torch.Tensor]:
        """Per-window additive bias, or None: ``[H, w*w, (w + 2e)**2]`` in
        2-D, the learned table ``[H, w, w + 2e]`` itself in 1-D; only the
        ``local_heads`` under tensor parallelism."""
        if not self.rpe_enabled:
            return None
        table = self.local_relative_position_bias_table
        if not self.attn_2d:
            return self.heads_of(table)
        w, e = self.window_size, self.ext_size
        bias = table[self.relative_position_index.reshape(-1)]
        return self.heads_of(bias.reshape(w * w, (w + 2 * e) ** 2,
                                          table.shape[-1]).permute(2, 0, 1))

    def heads_of(self, bias: torch.Tensor) -> torch.Tensor:
        """The ``local_heads`` of a per-head ``[H, ...]`` bias (all of them
        outside tensor parallelism)."""
        return bias if self.local_heads is None else bias[self.local_heads]

    def add_rel_pos_bias(self, local_dots: torch.Tensor) -> torch.Tensor:
        """``local_dots [b, h, g, i, j]`` plus the learned bias
        (``local_attention.py:70-79``)."""
        return local_dots + self.window_bias()[None, :, None]

    def window_partition(self, x: torch.Tensor, shape: Sequence[int],
                         ext_window_size: int = 0, pad_val: float = 0.0,
                         window_size: Optional[int] = None) -> torch.Tensor:
        """``[..., n, d] -> [..., g, (w + 2e)**2, d]`` over the ``(H, W)``
        grid in 2-D, ``[..., g, w + 2e, d]`` in 1-D
        (``local_attention.py:81-107``)."""
        window_size = self.window_size if window_size is None else window_size
        if not self.attn_2d:
            return W.window_1d_partition(x, window_size, ext_window_size, pad_val)
        H, W_ = shape
        *lead, n, d = x.shape
        return W.window_2d_partition(x.reshape(*lead, H, W_, d), window_size,
                                     ext_window_size, pad_val)

    def window_merge(self, x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
        if not self.attn_2d:
            return W.window_1d_merge(x)
        out = W.window_2d_merge(x, self.window_size, tuple(shape))
        *lead, H, W_, d = out.shape
        return out.reshape(*lead, H * W_, d)

    def local_mask(self, key_padding_mask: torch.Tensor, shape: Sequence[int],
                   dtype: torch.dtype) -> torch.Tensor:
        """``[b, 1, g, 1, (halo'd) window]`` True where a window's key is
        padding or lies in the halo outside the sequence or grid."""
        kpm = key_padding_mask.to(dtype)[:, None, :, None]
        return self.window_partition(kpm, shape, ext_window_size=self.ext_size,
                                     pad_val=1.0).bool().transpose(-1, -2)

    def _process_input(self, x: torch.Tensor,
                       key_padding_mask: Optional[torch.Tensor]):
        """``(x [B, N, C], key_padding_mask, seq_shape)``: a 1-D sequence
        right-padded to a window multiple, with its mask (built where there
        was none, padded with True where there was one); a 2-D grid
        flattened (``local_attention.py:109-131``)."""
        B, C = x.shape[0], x.shape[-1]
        seq_shape = tuple(x.shape[1:-1])
        N = math.prod(seq_shape)
        x = x.reshape(B, N, C)
        ws = self.window_size
        if self.attn_2d:
            if ws > 0 and (seq_shape[0] % ws or seq_shape[1] % ws):
                raise ValueError(f"grid {seq_shape} is not divisible by window {ws}")
        elif ws > 0:
            x = W.pad_to_multiple(x, ws, axis=-2)
            if key_padding_mask is None:
                key_padding_mask = W.padding_mask_for(B, N, x.shape[-2], x.device)
            else:
                key_padding_mask = W.pad_to_multiple(key_padding_mask, ws,
                                                     axis=-1, value=True)
            seq_shape = (x.shape[-2],)
        return x, key_padding_mask, seq_shape


class LocalAttention(LocalWindows, MultiheadAttention):
    """Window attention with an optional halo and learned RPE
    (``local_attention.py:25-182``)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 fp32: bool = False, use_rpe: bool = False,
                 window_size: int = 2, attn_2d: bool = False,
                 overlap_window: bool = False, impl: str = "auto"):
        super().__init__(dim, num_heads, qkv_bias=qkv_bias,
                         attn_drop=attn_drop, proj_drop=proj_drop, fp32=fp32)
        if impl not in ("auto", "xla"):
            raise ValueError(f"unknown local impl {impl!r}; use 'auto' or 'xla'")
        self.impl = impl
        self._init_windows(use_rpe, window_size, attn_2d, overlap_window)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The packed K7 route for a ``[B, H, W, C]`` grid without padding
        mask, halo or attention dropout (JAX ``local.py:134-170``), else
        the windowed einsums."""
        if (self.impl == "auto" and self.attn_2d and key_padding_mask is None
                and self.ext_size == 0 and self.attn_dropout.p == 0.0
                and x.dim() == 4):
            B, gh, gw, C = x.shape
            ws = self.window_size
            if (ws > 0 and gh % ws == 0 and gw % ws == 0
                    and supports_packed(B, gh * gw, gw, ws, self.head_dim,
                                        x.element_size(), self.num_heads)):
                qkv = self.qkv(x.reshape(B, gh * gw, C))
                out = local_attention_packed(qkv, self.scale, self.num_heads,
                                             gw, ws, bias=self.window_bias())
                return self.proj_dropout(self.proj(out.reshape(B, gh, gw, -1)))
        return super().forward(x, key_padding_mask)

    def _apply_attention(self, q, k, v, key_padding_mask):
        """Windowed attention core (``local_attention.py:134-182``): a
        square grid in 2-D; in 1-D the sequence padded to a window multiple
        with its padding masked, and the output cut back to its length."""
        b, h, n, d = q.shape
        orig_n = n
        if self.attn_2d:
            side = math.isqrt(n)
            if side * side != n:
                raise ValueError(f"2-D local attention needs a square grid, got n={n}")
            shape = (side, side)
        else:
            ws = self.window_size
            q, k, v = (W.pad_to_multiple(t, ws, axis=-2) for t in (q, k, v))
            n = q.shape[-2]
            if key_padding_mask is None:
                key_padding_mask = W.padding_mask_for(b, orig_n, n, q.device)
            else:
                key_padding_mask = W.pad_to_multiple(key_padding_mask, ws,
                                                     axis=-1, value=True)
            shape = (n,)
        ext = self.ext_size
        w_q = self.window_partition(q, shape)
        w_k = self.window_partition(k, shape, ext_window_size=ext)
        w_v = self.window_partition(v, shape, ext_window_size=ext)
        local_dots = (torch.einsum("bhwie,bhwje->bhwij", w_q, w_k)
                      * self.scale).to(q.dtype)
        if self.rpe_enabled:
            local_dots = self.add_rel_pos_bias(local_dots)
        if key_padding_mask is not None or ext:
            if key_padding_mask is None:
                key_padding_mask = torch.zeros(b, n, dtype=torch.bool,
                                               device=q.device)
            local_dots = local_dots.masked_fill(
                self.local_mask(key_padding_mask, shape, q.dtype), MASK_VAL)
        local_attn = self.attn_dropout(F.softmax(local_dots, dim=-1))
        output = torch.einsum("bhwij,bhwje->bhwie", local_attn.to(w_v.dtype), w_v)
        return self.window_merge(output, shape)[..., :orig_n, :]

    @staticmethod
    def add_attn_specific_args(parent_parser, struct_name="attn_args", prefix=""):
        from efficient_attention_torch.config import add_nested_argument

        parent_parser = MultiheadAttention.add_attn_specific_args(
            parent_parser, struct_name=struct_name, prefix=prefix
        )
        parser = parent_parser.add_argument_group("Attention")
        p = prefix + "-" if len(prefix) > 1 else ""
        add_nested_argument(parser, f"--{p}use-rpe", action="store_true",
                            struct_name=struct_name, prefix=prefix, default=False)
        add_nested_argument(parser, f"--{p}window-size", struct_name=struct_name,
                            prefix=prefix, default=4, type=int)
        add_nested_argument(parser, f"--{p}attn-2d", action="store_true",
                            struct_name=struct_name, prefix=prefix, default=False)
        add_nested_argument(parser, f"--{p}overlap-window", action="store_true",
                            struct_name=struct_name, prefix=prefix, default=False)
        return parent_parser

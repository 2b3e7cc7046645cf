"""Transformer encoder-decoder (MT) and decoder-only LM, batch-first.

PyTorch counterpart of ``efficient_attention_tpu/models/transformer.py``
(fairseq ``models/transformer/*`` and ``models/transformer_lm.py`` with the
fork's factory-built encoder attention, ``transformer_layer.py:86-95``, and
``causal_eva`` | ``softmax`` decoder self-attention,
``transformer_layer.py:295-321``; cross-attention is exact softmax).
Parameter names follow fairseq's (``encoder.layers.{i}.self_attn.attn.qkv
.weight``, ``decoder.layers.{i}.encoder_attn.q_proj.weight``,
``decoder.embed_tokens.embeddings.{i}.0.weight``, ...), so reference state
dicts load into the port (``interop.mt_state_dict_from_fairseq``,
``interop.lm_state_dict_from_fairseq``).

Ported: ``TransformerLM`` (pre-LN, sinusoidal or learned positions,
adaptive input and (tied) adaptive softmax, ``dense_tokens``, quant noise)
and ``TransformerModel`` (post-LN encoder and decoder, shared embeddings),
with incremental decoding: ``KVCache`` for softmax self-attention,
``EvaDecodeState`` for causal EVA, and cross-attention K/V projected once a
sentence and carried in the decode state (fairseq ``static_kv``).  Every
layer runs through ``_run_layer``: layerdrop and
``--checkpoint-activations`` in training.  Not ported yet, each raising
``NotImplementedError`` with its ROADMAP.md item: ``forward_with_alignment``,
sequence parallelism and BASE layers.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from efficient_attention_torch.attention.base import MASK_VAL, Dropout
from efficient_attention_torch.attention.causal_eva import CausalEVAttention
from efficient_attention_torch.models.adaptive_softmax import (
    AdaptiveInput,
    AdaptiveSoftmax,
    TiedAdaptiveSoftmax,
)
from efficient_attention_torch.models.quant_noise import dense
from efficient_attention_torch.ops.promote import LayerNorm, Linear

_CAUSAL_EVA_KEYS = ("window_size", "overlap_window", "num_chunks",
                    "chunk_size", "adaptive_proj", "use_t5_rpe", "impl")


def sinusoidal_positions(max_len: int, dim: int, offset: int = 2) -> np.ndarray:
    """fairseq sinusoidal embeddings of positions ``offset..`` (pad offset)."""
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    freqs = np.exp(np.arange(half) * -emb)
    pos = np.arange(offset, max_len + offset)[:, None] * freqs[None, :]
    out = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if dim % 2 == 1:
        out = np.concatenate([out, np.zeros((max_len, 1))], axis=1)
    return out.astype(np.float32)


def get_activation_fn(name: str):
    """fairseq ``--activation-fn``: relu, gelu (exact), gelu_fast and
    gelu_accurate (tanh approximation), relu_squared, tanh, linear."""
    table = {
        "relu": F.relu,
        "gelu": F.gelu,
        "gelu_fast": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_accurate": lambda x: F.gelu(x, approximate="tanh"),
        "relu_squared": lambda x: F.relu(x).square(),
        "tanh": torch.tanh,
        "linear": lambda x: x,
    }
    if name not in table:
        raise ValueError(f"unknown activation {name!r} (choices: {sorted(table)})")
    return table[name]


def _run_layer(layer: nn.Module, args, *, remat: bool, layerdrop: float,
               generator: Optional[torch.Generator], training: bool):
    """``layer(*args)`` through the training-time wrappers (JAX
    ``transformer.py:66-97``).

    * ``layerdrop`` (fairseq ``LayerDropModuleList``): in training, one
      uniform draw from ``generator`` per layer and forward; below
      ``layerdrop`` the layer is the identity on ``args[0]``.
    * ``remat`` (``--checkpoint-activations``): in training,
      ``torch.utils.checkpoint`` recomputes the layer in the backward instead
      of storing its activations.  The recompute runs after the forward has
      returned, so it is handed what the forward read that the checkpoint
      does not restore: the layer's parameters as they were then (under
      ``--bf16`` the bfloat16 copies of ``train_state.cast_modules``, whose
      block has closed), and the state of ``generator``, which the layer's
      dropout and noise draw from (the checkpoint restores torch's global
      RNGs only).  The state the recompute found is put back after it, so
      later draws do not repeat the forward's."""
    if training and layerdrop > 0.0:
        u = torch.rand((), generator=generator, device=args[0].device)
        if float(u) < layerdrop:
            return args[0]
    if not (remat and training and torch.is_grad_enabled()):
        return layer(*args)
    read = [(mod, name, p) for mod in layer.modules()
            for name, p in mod._parameters.items() if p is not None]
    start = None if generator is None else generator.get_state()
    ran = []

    def run(*xs):
        if not ran:  # the forward
            ran.append(True)
            return layer(*xs)
        # the recompute, in the backward
        now = [mod._parameters[name] for mod, name, _ in read]
        found = None if generator is None else generator.get_state()
        for mod, name, p in read:
            mod._parameters[name] = p
        if generator is not None:
            generator.set_state(start)
        try:
            return layer(*xs)
        finally:
            for (mod, name, _), p in zip(read, now):
                mod._parameters[name] = p
            if generator is not None:
                generator.set_state(found)

    return checkpoint(run, *args, use_reentrant=False)


def _unported(checks) -> None:
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet; see ROADMAP.md {item}")


def _attend(q, k, v, mask, scale, dtype, dropout=None):
    """Softmax attention of split heads ``[B, H, T, d]`` over ``[B, H, S, d]``
    keys: f32 logits (the JAX package's ``preferred_element_type=f32``), set
    to ``MASK_VAL`` where ``mask`` (broadcast to ``[B, H, T, S]``) is True,
    probabilities in ``dtype``."""
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(mask, MASK_VAL)
    attn = torch.softmax(logits, dim=-1).to(dtype)
    if dropout is not None:
        attn = dropout(attn)
    return torch.einsum("bhts,bhsd->bhtd", attn, v)


class KVCache(NamedTuple):
    """Fixed-capacity decoder KV cache (JAX ``transformer.py:183-188``)."""

    k: torch.Tensor  # [B, H, L, D]
    v: torch.Tensor
    pos: int


class CausalSelfAttention(nn.Module):
    """Exact softmax causal self-attention, the decoder baseline (fairseq
    ``MultiheadAttention`` semantics), with a fixed-shape decode cache
    (``decode_step`` writes the cache's slot in place)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 q_noise: float = 0.0, qn_block_size: int = 8):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        qn = (q_noise, qn_block_size)
        self.q_proj = dense(embed_dim, embed_dim, *qn)
        self.k_proj = dense(embed_dim, embed_dim, *qn)
        self.v_proj = dense(embed_dim, embed_dim, *qn)
        self.out_proj = dense(embed_dim, embed_dim, *qn)
        self.attn_dropout = Dropout(dropout)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, C = x.shape

        def split(t):
            return t.reshape(B, T, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        hidden = torch.ones((T, T), dtype=torch.bool, device=x.device).triu(1)
        if key_padding_mask is not None:
            hidden = hidden | key_padding_mask[:, None, None, :].bool()
        out = _attend(q, k, v, hidden, self.head_dim ** -0.5, x.dtype,
                      self.attn_dropout)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, C))

    def init_decode_state(self, batch_size: int, max_len: int,
                          dtype: torch.dtype = torch.float32,
                          device=None) -> KVCache:
        shape = (batch_size, self.num_heads, max_len, self.head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device), 0)

    def decode_step(self, state: KVCache, x: torch.Tensor):
        """One token ``[B, 1, C]``: its k/v written at slot ``pos``, attention
        over slots ``<= pos``."""
        B, _, C = x.shape

        def split(t):
            return t.reshape(B, 1, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        state.k[:, :, state.pos] = k[:, :, 0]
        state.v[:, :, state.pos] = v[:, :, 0]
        hidden = torch.arange(state.k.shape[2], device=x.device) > state.pos
        out = _attend(q, state.k, state.v, hidden, self.head_dim ** -0.5, x.dtype)
        return (self.out_proj(out.transpose(1, 2).reshape(B, 1, C)),
                KVCache(state.k, state.v, state.pos + 1))


class CrossAttention(nn.Module):
    """Exact softmax encoder-decoder attention (fairseq ``encoder_attn``),
    with the encoder K/V projected once for decoding (``precompute_kv``,
    JAX ``transformer.py:100-180``)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 q_noise: float = 0.0, qn_block_size: int = 8):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        qn = (q_noise, qn_block_size)
        self.q_proj = dense(embed_dim, embed_dim, *qn)
        self.k_proj = dense(embed_dim, embed_dim, *qn)
        self.v_proj = dense(embed_dim, embed_dim, *qn)
        self.out_proj = dense(embed_dim, embed_dim, *qn)
        self.attn_dropout = Dropout(dropout)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(t.shape[0], -1, self.num_heads, self.head_dim).transpose(1, 2)

    def _out(self, out: torch.Tensor) -> torch.Tensor:
        B = out.shape[0]
        return self.out_proj(out.transpose(1, 2).reshape(B, -1, self.embed_dim))

    def forward(self, x: torch.Tensor, enc_out: torch.Tensor,
                enc_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        k, v = self.precompute_kv(enc_out)
        return self._out(self._core(self._split(self.q_proj(x)), k, v,
                                    enc_padding_mask, x.dtype, self.attn_dropout))

    def _core(self, q, k, v, enc_padding_mask, dtype, dropout=None):
        mask = None if enc_padding_mask is None else enc_padding_mask[:, None, None, :].bool()
        return _attend(q, k, v, mask, self.head_dim ** -0.5, dtype, dropout)

    def precompute_kv(self, enc_out: torch.Tensor):
        """Encoder states projected to split-head K/V ``[B, H, S, D]``."""
        return self._split(self.k_proj(enc_out)), self._split(self.v_proj(enc_out))

    def decode_step(self, x: torch.Tensor, cached_k: torch.Tensor,
                    cached_v: torch.Tensor,
                    enc_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token's cross-attention on the precomputed K/V: only the query
        projection runs."""
        return self._out(self._core(self._split(self.q_proj(x)), cached_k,
                                    cached_v, enc_padding_mask, x.dtype))


class EfficientAttention(nn.Module):
    """The fork's bridge (``fairseq/modules/efficient_attention.py:54-131``)
    holding the factory-built encoder attention as ``attn``."""

    def __init__(self, attn: nn.Module):
        super().__init__()
        self.attn = attn

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.attn(x, key_padding_mask=key_padding_mask)


class _Sublayers(nn.Module):
    """Residual sublayers with their LayerNorm before (pre-LN) or after
    (post-LN, fairseq's default) and dropout on each sublayer's output."""

    def _pre(self, x: torch.Tensor, norm: nn.Module) -> torch.Tensor:
        return norm(x) if self.normalize_before else x

    def _post(self, residual: torch.Tensor, h: torch.Tensor,
              norm: nn.Module) -> torch.Tensor:
        x = residual + self.drop(h)
        return x if self.normalize_before else norm(x)

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act_drop(self.activation(self.fc1(x))))


class EncoderLayer(_Sublayers):
    """Post-LN (or pre-LN) encoder layer with factory-built self-attention
    (JAX ``transformer.py:268-328``); attention dropout is ``dropout``, as
    the JAX layer passes it."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 attn_name: str = "softmax",
                 attn_args: Optional[Dict[str, Any]] = None,
                 dropout: float = 0.1, activation_dropout: float = 0.0,
                 normalize_before: bool = False, activation_fn: str = "relu",
                 quant_noise_pq: float = 0.0, quant_noise_pq_block_size: int = 8):
        super().__init__()
        from efficient_attention_torch import AttentionFactory

        qn = (quant_noise_pq, quant_noise_pq_block_size)
        self.self_attn = EfficientAttention(AttentionFactory.build_attention(
            attn_name, {**(attn_args or {}), "dim": embed_dim,
                        "num_heads": num_heads, "attn_drop": dropout,
                        "proj_drop": 0.0}))
        self.normalize_before = normalize_before
        self.activation = get_activation_fn(activation_fn)
        self.self_attn_layer_norm = LayerNorm(embed_dim, eps=1e-5)
        self.fc1 = dense(embed_dim, ffn_dim, *qn)
        self.fc2 = dense(ffn_dim, embed_dim, *qn)
        self.final_layer_norm = LayerNorm(embed_dim, eps=1e-5)
        self.drop = Dropout(dropout)
        self.act_drop = Dropout(activation_dropout)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        ln1, ln2 = self.self_attn_layer_norm, self.final_layer_norm
        x = self._post(x, self.self_attn(self._pre(x, ln1), key_padding_mask), ln1)
        return self._post(x, self._ffn(self._pre(x, ln2)), ln2)


class DecoderLayer(_Sublayers):
    """Decoder layer with {causal_eva | softmax} self-attention and, with
    ``has_cross``, softmax cross-attention (``transformer_layer.py:295-331``,
    JAX ``transformer.py:331-493``)."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 attn_name: str = "softmax",
                 attn_args: Optional[Dict[str, Any]] = None,
                 dropout: float = 0.1, activation_dropout: float = 0.0,
                 normalize_before: bool = False, has_cross: bool = False,
                 activation_fn: str = "relu", quant_noise_pq: float = 0.0,
                 quant_noise_pq_block_size: int = 8):
        super().__init__()
        qn = (quant_noise_pq, quant_noise_pq_block_size)
        attn_args = attn_args or {}
        if attn_name == "causal_eva":
            self.self_attn = CausalEVAttention(
                embed_dim, num_heads, dropout=dropout, causal=True,
                q_noise=qn[0], qn_block_size=qn[1],
                **{k: v for k, v in attn_args.items() if k in _CAUSAL_EVA_KEYS})
        elif attn_name == "softmax":
            self.self_attn = CausalSelfAttention(
                embed_dim, num_heads, dropout=dropout, q_noise=qn[0],
                qn_block_size=qn[1])
        else:
            raise NotImplementedError(
                f"decoder attention {attn_name} (the reference supports "
                "causal_eva and softmax, transformer_layer.py:295-321)")
        self.normalize_before = normalize_before
        self.has_cross = has_cross
        self.activation = get_activation_fn(activation_fn)
        self.self_attn_layer_norm = LayerNorm(embed_dim, eps=1e-5)
        if has_cross:
            self.encoder_attn = CrossAttention(embed_dim, num_heads, dropout=dropout,
                                               q_noise=qn[0], qn_block_size=qn[1])
            self.encoder_attn_layer_norm = LayerNorm(embed_dim, eps=1e-5)
        self.fc1 = dense(embed_dim, ffn_dim, *qn)
        self.fc2 = dense(ffn_dim, embed_dim, *qn)
        self.final_layer_norm = LayerNorm(embed_dim, eps=1e-5)
        self.drop = Dropout(dropout)
        self.act_drop = Dropout(activation_dropout)

    def forward(self, x: torch.Tensor,
                self_padding_mask: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None,
                enc_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        ln1, ln3 = self.self_attn_layer_norm, self.final_layer_norm
        x = self._post(x, self.self_attn(self._pre(x, ln1),
                                         key_padding_mask=self_padding_mask), ln1)
        if self.has_cross and enc_out is not None:
            ln2 = self.encoder_attn_layer_norm
            x = self._post(x, self.encoder_attn(self._pre(x, ln2), enc_out,
                                                enc_padding_mask), ln2)
        return self._post(x, self._ffn(self._pre(x, ln3)), ln3)

    def init_decode_state(self, batch_size: int, max_len: int,
                          dtype: torch.dtype = torch.float32, device=None,
                          enc_out: Optional[torch.Tensor] = None):
        """The self-attention's decode state, paired (with ``enc_out``) with
        the cross-attention K/V projected once here (fairseq ``static_kv``,
        ``transformer_layer.py:435-450``)."""
        state = self.self_attn.init_decode_state(batch_size, max_len, dtype, device)
        if enc_out is None or not self.has_cross:
            return state
        return (state, self.encoder_attn.precompute_kv(enc_out))

    def decode_step(self, state, x: torch.Tensor,
                    enc_out: Optional[torch.Tensor] = None,
                    enc_padding_mask: Optional[torch.Tensor] = None):
        """One token ``[B, 1, C]`` -> ``(out, new state)``.  The
        cross-attention reads the K/V carried in the state, or projects
        ``enc_out`` where the state carries none."""
        cross_kv = None
        if isinstance(state, tuple) and not hasattr(state, "_fields"):
            state, cross_kv = state
        ln1, ln3 = self.self_attn_layer_norm, self.final_layer_norm
        h, state = self.self_attn.decode_step(state, self._pre(x, ln1))
        x = self._post(x, h, ln1)
        if self.has_cross and (cross_kv is not None or enc_out is not None):
            ln2 = self.encoder_attn_layer_norm
            kv = cross_kv if cross_kv is not None else self.encoder_attn.precompute_kv(enc_out)
            x = self._post(x, self.encoder_attn.decode_step(
                self._pre(x, ln2), *kv, enc_padding_mask), ln2)
        x = self._post(x, self._ffn(self._pre(x, ln3)), ln3)
        return x, (state if cross_kv is None else (state, cross_kv))


class _Embedded(nn.Module):
    """Token embedding times sqrt(dim) plus positions, shared by the encoder
    and the decoder: sinusoidal (a buffer), or fairseq's learned
    ``LearnedPositionalEmbedding`` (padding-aware positions, rows
    ``0..pad_idx`` reserved)."""

    def _setup_embedding(self, embed_tokens: nn.Module, embed_dim: int,
                         max_len: int, pad_idx: int, learned_pos: bool) -> None:
        self.pad_idx = pad_idx
        self.learned_pos = learned_pos
        self.embed_scale = math.sqrt(embed_dim)
        self.embed_tokens = embed_tokens
        if learned_pos:
            self.embed_positions = nn.Embedding(max_len + pad_idx + 1, embed_dim)
        else:
            self.register_buffer(
                "positions", torch.from_numpy(sinusoidal_positions(max_len, embed_dim)),
                persistent=False)

    def _embed(self, tokens: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
        """``pos_offset`` is the count of tokens already decoded."""
        x = self.embed_tokens(tokens) * self.embed_scale
        if self.learned_pos:
            keep = (tokens != self.pad_idx).long()
            positions = (torch.cumsum(keep, dim=1) + pos_offset) * keep + self.pad_idx
            return x + self.embed_positions(positions).to(x.dtype)
        # keep the activation dtype (the f32 table would promote bf16)
        return x + self.positions[pos_offset:pos_offset + tokens.shape[1]].to(x.dtype)


class TransformerEncoder(_Embedded):
    """Embed, layers, optional final LayerNorm (fairseq
    ``TransformerEncoder``, JAX ``transformer.py:496-587``); the padding
    mask of the source is every layer's key-padding mask."""

    def __init__(self, vocab_size: int, embed_dim: int = 512,
                 ffn_dim: int = 2048, num_layers: int = 6, num_heads: int = 8,
                 attn_name: str = "softmax",
                 attn_args: Optional[Dict[str, Any]] = None,
                 dropout: float = 0.1, max_len: int = 1024,
                 normalize_before: bool = False, pad_idx: int = 1,
                 learned_pos: bool = False, activation_fn: str = "relu",
                 embed_tokens: Optional[nn.Module] = None,
                 quant_noise_pq: float = 0.0,
                 quant_noise_pq_block_size: int = 8,
                 checkpoint_activations: bool = False, layerdrop: float = 0.0):
        super().__init__()
        self._setup_embedding(embed_tokens or nn.Embedding(vocab_size, embed_dim),
                              embed_dim, max_len, pad_idx, learned_pos)
        self.checkpoint_activations = checkpoint_activations
        self.layerdrop = layerdrop
        self.generator: Optional[torch.Generator] = None  # set_generator's
        self.embed_dropout = Dropout(dropout)
        self.layers = nn.ModuleList(
            EncoderLayer(embed_dim, ffn_dim, num_heads, attn_name=attn_name,
                         attn_args=attn_args, dropout=dropout,
                         normalize_before=normalize_before,
                         activation_fn=activation_fn,
                         quant_noise_pq=quant_noise_pq,
                         quant_noise_pq_block_size=quant_noise_pq_block_size)
            for _ in range(num_layers))
        self.layer_norm = LayerNorm(embed_dim, eps=1e-5) if normalize_before else None

    def forward(self, src_tokens: torch.Tensor):
        """``(states [B, S, D], padding mask [B, S])`` of ``src_tokens``."""
        padding_mask = src_tokens == self.pad_idx
        x = self.embed_dropout(self._embed(src_tokens))
        for layer in self.layers:
            x = _run_layer(layer, (x, padding_mask),
                           remat=self.checkpoint_activations,
                           layerdrop=self.layerdrop, generator=self.generator,
                           training=self.training)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return x, padding_mask


class TransformerDecoder(_Embedded):
    """The decoder: token embedding (plain, shared with the encoder, or
    adaptive input), positions, layers (with cross-attention when
    ``has_cross``), optional final LayerNorm, and the output layer (tied
    embedding, its own projection, or the adaptive softmax, held here as
    fairseq does)."""

    def __init__(self, vocab_size: int, embed_dim: int = 512,
                 ffn_dim: int = 2048, num_layers: int = 6, num_heads: int = 8,
                 attn_name: str = "softmax",
                 attn_args: Optional[Dict[str, Any]] = None,
                 dropout: float = 0.1, max_len: int = 1024,
                 normalize_before: bool = False, pad_idx: int = 1,
                 share_input_output_embed: bool = True,
                 dense_tokens: bool = False,
                 adaptive_input_cutoffs: Optional[Sequence[int]] = None,
                 adaptive_softmax_cutoffs: Optional[Sequence[int]] = None,
                 tie_adaptive: bool = True, final_norm: bool = True,
                 quant_noise_pq: float = 0.0,
                 quant_noise_pq_block_size: int = 8,
                 learned_pos: bool = False, activation_fn: str = "relu",
                 has_cross: bool = False,
                 embed_tokens: Optional[nn.Module] = None,
                 checkpoint_activations: bool = False, layerdrop: float = 0.0):
        super().__init__()
        self.dense_tokens = dense_tokens
        self.checkpoint_activations = checkpoint_activations
        self.layerdrop = layerdrop
        self.generator: Optional[torch.Generator] = None  # set_generator's
        self.share_input_output_embed = share_input_output_embed
        if embed_tokens is None:
            embed_tokens = (AdaptiveInput(vocab_size, embed_dim, adaptive_input_cutoffs)
                            if adaptive_input_cutoffs is not None
                            else nn.Embedding(vocab_size, embed_dim))
        self._setup_embedding(embed_tokens, embed_dim, max_len, pad_idx, learned_pos)
        self.embed_dropout = Dropout(dropout)
        self.layers = nn.ModuleList(
            DecoderLayer(embed_dim, ffn_dim, num_heads, attn_name=attn_name,
                         attn_args=attn_args, dropout=dropout,
                         normalize_before=normalize_before, has_cross=has_cross,
                         activation_fn=activation_fn,
                         quant_noise_pq=quant_noise_pq,
                         quant_noise_pq_block_size=quant_noise_pq_block_size)
            for _ in range(num_layers))
        self.layer_norm = (LayerNorm(embed_dim, eps=1e-5)
                           if normalize_before and final_norm else None)
        self.adaptive_softmax = None
        if adaptive_softmax_cutoffs:
            if adaptive_input_cutoffs is not None and tie_adaptive:
                self.adaptive_softmax = TiedAdaptiveSoftmax(
                    vocab_size, embed_dim, adaptive_softmax_cutoffs)
            else:
                self.adaptive_softmax = AdaptiveSoftmax(
                    vocab_size, embed_dim, adaptive_softmax_cutoffs)
        elif not share_input_output_embed and adaptive_input_cutoffs is None:
            self.output_projection = Linear(embed_dim, vocab_size, bias=False)

    def forward(self, tokens: torch.Tensor, enc_out: Optional[torch.Tensor] = None,
                enc_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Features ``[B, T, D]`` of ``tokens [B, T]`` (attending to
        ``enc_out`` where the layers have cross-attention)."""
        # the dense TokenBlock pipeline promises no pads: no mask, which is
        # what lets causal EVA take the K3 kernel
        padding_mask = None if self.dense_tokens else tokens == self.pad_idx
        x = self.embed_dropout(self._embed(tokens))
        for layer in self.layers:
            x = _run_layer(layer, (x, padding_mask, enc_out, enc_padding_mask),
                           remat=self.checkpoint_activations,
                           layerdrop=self.layerdrop, generator=self.generator,
                           training=self.training)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return x

    def init_decode_state(self, batch_size: int, max_len: int,
                          dtype: torch.dtype = torch.float32, device=None,
                          enc_out: Optional[torch.Tensor] = None) -> List[Any]:
        """One decode state a layer; with ``enc_out`` each carries its
        cross-attention K/V, projected once here."""
        return [layer.init_decode_state(batch_size, max_len, dtype, device, enc_out)
                for layer in self.layers]

    def decode_step(self, states: List[Any], tokens: torch.Tensor, pos: int,
                    enc_out: Optional[torch.Tensor] = None,
                    enc_padding_mask: Optional[torch.Tensor] = None,
                    features_only: bool = False):
        """One step: ``tokens [B, 1]`` at position ``pos`` -> ``(logits
        [B, 1, V] (or features), new states)``."""
        x = self._embed(tokens, pos_offset=pos)
        new_states = []
        for layer, st in zip(self.layers, states):
            x, st = layer.decode_step(st, x, enc_out, enc_padding_mask)
            new_states.append(st)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return (x if features_only else self.output_layer(x)), new_states

    def output_layer(self, x: torch.Tensor) -> torch.Tensor:
        """Full-vocabulary logits of features (not for the adaptive
        softmax)."""
        if (self.adaptive_softmax is not None
                or isinstance(self.embed_tokens, AdaptiveInput)):
            raise ValueError("adaptive-input decoders emit features; their "
                             "output layer is the adaptive softmax "
                             "(TransformerLM.log_prob)")
        if hasattr(self, "output_projection"):
            return self.output_projection(x)
        return x @ self.embed_tokens.weight.t()


class TransformerModel(nn.Module):
    """Encoder-decoder MT model (``transformer_wmt_en_de``: 6 + 6 layers,
    d=512, ffn 2048, 8 heads, post-LN; JAX ``transformer.py:820-919``).
    With ``share_all_embeddings`` one table is the encoder's and decoder's
    input embedding and the output projection; the decoder's output layer is
    its tied input embedding either way, as in the JAX model."""

    def __init__(self, src_vocab_size: int, tgt_vocab_size: int,
                 embed_dim: int = 512, ffn_dim: int = 2048, num_layers: int = 6,
                 num_decoder_layers: Optional[int] = None, num_heads: int = 8,
                 attn_name_encoder: str = "softmax",
                 attn_args_encoder: Optional[Dict[str, Any]] = None,
                 attn_name_decoder: str = "softmax",
                 attn_args_decoder: Optional[Dict[str, Any]] = None,
                 dropout: float = 0.1, max_len: int = 1024, pad_idx: int = 1,
                 share_all_embeddings: bool = False,
                 checkpoint_activations: bool = False,
                 encoder_layerdrop: float = 0.0, decoder_layerdrop: float = 0.0,
                 quant_noise_pq: float = 0.0, quant_noise_pq_block_size: int = 8,
                 activation_fn: str = "relu", encoder_learned_pos: bool = False,
                 decoder_learned_pos: bool = False):
        super().__init__()
        shared = None
        if share_all_embeddings:
            if src_vocab_size != tgt_vocab_size:
                raise ValueError("--share-all-embeddings requires a joint vocabulary")
            shared = nn.Embedding(src_vocab_size, embed_dim)
        qn = dict(quant_noise_pq=quant_noise_pq,
                  quant_noise_pq_block_size=quant_noise_pq_block_size)
        self.encoder = TransformerEncoder(
            src_vocab_size, embed_dim=embed_dim, ffn_dim=ffn_dim,
            num_layers=num_layers, num_heads=num_heads,
            attn_name=attn_name_encoder, attn_args=attn_args_encoder,
            dropout=dropout, max_len=max_len, pad_idx=pad_idx,
            learned_pos=encoder_learned_pos, activation_fn=activation_fn,
            embed_tokens=shared, checkpoint_activations=checkpoint_activations,
            layerdrop=encoder_layerdrop, **qn)
        self.decoder = TransformerDecoder(
            tgt_vocab_size, embed_dim=embed_dim, ffn_dim=ffn_dim,
            num_layers=num_layers if num_decoder_layers is None else num_decoder_layers,
            num_heads=num_heads, attn_name=attn_name_decoder,
            attn_args=attn_args_decoder, dropout=dropout, max_len=max_len,
            pad_idx=pad_idx, learned_pos=decoder_learned_pos,
            activation_fn=activation_fn, has_cross=True, embed_tokens=shared,
            checkpoint_activations=checkpoint_activations,
            layerdrop=decoder_layerdrop, **qn)

    def forward(self, src_tokens: torch.Tensor,
                prev_output_tokens: torch.Tensor) -> torch.Tensor:
        """Logits ``[B, T, V]`` of teacher-forced ``prev_output_tokens``."""
        enc_out, enc_padding = self.encoder(src_tokens)
        return self.decoder.output_layer(
            self.decoder(prev_output_tokens, enc_out, enc_padding))

    def encode(self, src_tokens: torch.Tensor):
        """``(encoder states, source padding mask)``."""
        return self.encoder(src_tokens)

    def init_decode_state(self, batch_size: int, max_len: int,
                          dtype: torch.dtype = torch.float32, device=None,
                          enc_out: Optional[torch.Tensor] = None) -> List[Any]:
        return self.decoder.init_decode_state(batch_size, max_len, dtype, device,
                                              enc_out)

    def decode_step(self, states: List[Any], tokens: torch.Tensor, pos: int,
                    enc_out: Optional[torch.Tensor],
                    enc_padding_mask: Optional[torch.Tensor]):
        """``enc_out`` may be None where the states carry the cross-attention
        K/V (``init_decode_state(..., enc_out=...)``)."""
        return self.decoder.decode_step(states, tokens, pos, enc_out,
                                        enc_padding_mask)

    def forward_with_alignment(self, src_tokens, prev_output_tokens):
        raise NotImplementedError(
            "forward_with_alignment (generate --print-alignment) is not ported "
            "yet; see ROADMAP.md Queue 1, item 6")


class TransformerLM(nn.Module):
    """Decoder-only LM (``transformer_lm_wiki103``: 16 layers, d=1024,
    ffn=4096, 8 heads, adaptive input and tied adaptive softmax, no final
    LayerNorm)."""

    def __init__(self, vocab_size: int, embed_dim: int = 1024,
                 ffn_dim: int = 4096, num_layers: int = 16, num_heads: int = 8,
                 attn_name: str = "softmax",
                 attn_args: Optional[Dict[str, Any]] = None,
                 dropout: float = 0.1, max_len: int = 3072, pad_idx: int = 1,
                 adaptive_cutoffs: Optional[Sequence[int]] = None,
                 adaptive_input: bool = False, tie_adaptive: bool = True,
                 final_norm: bool = True, seq_axis: Optional[str] = None,
                 base_layers: int = 0, checkpoint_activations: bool = False,
                 layerdrop: float = 0.0, quant_noise_pq: float = 0.0,
                 quant_noise_pq_block_size: int = 8,
                 activation_fn: str = "relu", learned_pos: bool = False,
                 dense_tokens: bool = False):
        super().__init__()
        _unported([
            (seq_axis is not None, "sequence parallelism", "Queue 1, item 7"),
            (base_layers, "BASE layers", "Queue 1, item 7"),
        ])
        cutoffs = tuple(adaptive_cutoffs) if adaptive_cutoffs else None
        self.decoder = TransformerDecoder(
            vocab_size, embed_dim=embed_dim, ffn_dim=ffn_dim,
            num_layers=num_layers, num_heads=num_heads, attn_name=attn_name,
            attn_args=attn_args, dropout=dropout, max_len=max_len,
            normalize_before=True, pad_idx=pad_idx, dense_tokens=dense_tokens,
            adaptive_input_cutoffs=cutoffs if adaptive_input else None,
            adaptive_softmax_cutoffs=cutoffs, tie_adaptive=tie_adaptive,
            final_norm=final_norm, quant_noise_pq=quant_noise_pq,
            quant_noise_pq_block_size=quant_noise_pq_block_size,
            learned_pos=learned_pos, activation_fn=activation_fn,
            checkpoint_activations=checkpoint_activations, layerdrop=layerdrop)

    @property
    def _tied(self) -> bool:
        return isinstance(self.decoder.adaptive_softmax, TiedAdaptiveSoftmax)

    def log_prob(self, feats: torch.Tensor) -> torch.Tensor:
        """Log-probabilities ``[..., V]`` (f32) of features."""
        soft = self.decoder.adaptive_softmax
        if soft is None:
            return F.log_softmax(self.decoder.output_layer(feats).float(), -1)
        if self._tied:
            return soft.log_prob(feats, *self.decoder.embed_tokens.band_weights())
        return soft.log_prob(feats)

    def forward(self, tokens: torch.Tensor,
                targets: Optional[torch.Tensor] = None,
                features_only: bool = False) -> torch.Tensor:
        """With ``targets``, the token NLL ``[B, T]`` (the JAX ``loss``);
        else features, or log-probabilities with an adaptive softmax, else
        logits (the JAX ``__call__``)."""
        feats = self.decoder(tokens)
        if targets is not None:
            return self.nll_from_features(feats, targets)
        if features_only:
            return feats
        if self.decoder.adaptive_softmax is not None:
            return self.log_prob(feats)
        return self.decoder.output_layer(feats)

    def nll_from_features(self, feats: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
        """Token NLL ``[...]`` (f32) from decoder features."""
        soft = self.decoder.adaptive_softmax
        if soft is None:
            logits = self.decoder.output_layer(feats).float()
            return -torch.gather(F.log_softmax(logits, -1), -1,
                                 targets[..., None])[..., 0]
        if self._tied:
            return soft.nll(feats, targets,
                            *self.decoder.embed_tokens.band_weights())
        return soft.nll(feats, targets)

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Token-level NLL ``[B, T]`` (adaptive or full softmax)."""
        return self(tokens, targets)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter from ``generator`` as the JAX package
    initialises the LM and the MT model: decoder self-attention q/k/v
    projections and the adaptive mu projections ``variance_scaling(0.5,
    fan_avg, uniform)``; cross-attention projections, output projections,
    adaptive-input projections and cluster heads Xavier uniform; the
    factory-built encoder attention's Linears and learned RPE table
    ``truncated_normal(0.02)``; feed-forward and output Linears LeCun
    normal; embeddings normal(dim^-0.5), T5 tables normal(1), zero biases,
    unit LayerNorms.  Draws on the CPU, so one seed gives the same weights
    on every device."""
    lecun = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]
    for name, module in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        for pname, param in module.named_parameters(recurse=False):
            cpu = torch.empty(param.shape, dtype=torch.float32)
            if isinstance(module, nn.LayerNorm):
                cpu.fill_(1.0 if pname == "weight" else 0.0)
            elif pname == "bias":
                cpu.zero_()
            elif isinstance(module, nn.Embedding):
                std = (1.0 if leaf == "relative_attention_bias"
                       else 0.02 if leaf == "embed_positions"
                       else param.shape[1] ** -0.5)
                cpu.normal_(0.0, std, generator=generator)
            elif "encoder_attn" in name:
                nn.init.xavier_uniform_(cpu, generator=generator)
            elif ".self_attn.attn" in name:
                nn.init.trunc_normal_(cpu, std=0.02, a=-0.04, b=0.04,
                                      generator=generator)
            elif leaf in ("q_proj", "k_proj", "v_proj") or "adaptive_mu" in name:
                nn.init.xavier_uniform_(cpu, gain=math.sqrt(0.5),
                                        generator=generator)
            elif (leaf == "out_proj" or "embed_tokens" in name
                  or "adaptive_softmax" in name):
                nn.init.xavier_uniform_(cpu, generator=generator)
            else:
                std = math.sqrt(1.0 / param.shape[1]) / lecun
                nn.init.trunc_normal_(cpu, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
            param.copy_(cpu)
    return model

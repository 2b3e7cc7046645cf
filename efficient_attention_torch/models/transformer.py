"""Decoder-only transformer LM, batch-first.

PyTorch counterpart of the LM part of
``efficient_attention_tpu/models/transformer.py`` (fairseq
``models/transformer_lm.py`` with the fork's ``causal_eva`` | ``softmax``
decoder self-attention, ``transformer_layer.py:295-321``).  Parameter names
follow fairseq's (``decoder.layers.{i}.self_attn.q_proj.weight``,
``decoder.embed_tokens.embeddings.{i}.0.weight``,
``decoder.adaptive_softmax.head.class_proj.weight``, ...), so reference state
dicts load into the port (``interop.lm_state_dict_from_fairseq``).

Ported: ``TransformerLM`` with ``has_cross=False`` decoder layers, pre-LN,
sinusoidal or learned positions, adaptive input and (tied) adaptive softmax,
``dense_tokens``, quant noise.  Not ported yet, each raising
``NotImplementedError`` with its ROADMAP.md item: the encoder and
cross-attention (MT), incremental decoding, sequence parallelism, BASE
layers, layerdrop and ``--checkpoint-activations``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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


class CausalSelfAttention(nn.Module):
    """Exact softmax causal self-attention, the decoder baseline (fairseq
    ``MultiheadAttention`` semantics).  Incremental decoding is not ported
    yet (ROADMAP.md Queue 1, item 5)."""

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
        # logits in f32 (the JAX package's preferred_element_type=f32)
        logits = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
        logits = logits * self.head_dim ** -0.5
        causal = torch.ones((T, T), dtype=torch.bool, device=x.device).triu(1)
        logits = logits.masked_fill(causal, MASK_VAL)
        if key_padding_mask is not None:
            logits = logits.masked_fill(
                key_padding_mask[:, None, None, :].bool(), MASK_VAL)
        attn = self.attn_dropout(torch.softmax(logits, dim=-1).to(x.dtype))
        out = torch.einsum("bhts,bhsd->bhtd", attn, v)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, C))


class DecoderLayer(nn.Module):
    """Decoder layer with {causal_eva | softmax} self-attention
    (``transformer_layer.py:295-331``), without cross-attention."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 attn_name: str = "softmax",
                 attn_args: Optional[Dict[str, Any]] = None,
                 dropout: float = 0.1, activation_dropout: float = 0.0,
                 normalize_before: bool = False, has_cross: bool = False,
                 activation_fn: str = "relu", quant_noise_pq: float = 0.0,
                 quant_noise_pq_block_size: int = 8):
        super().__init__()
        if has_cross:
            raise NotImplementedError(
                "decoder cross-attention (the MT model) is not ported yet; see "
                "ROADMAP.md Queue 1, item 6")
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
        self.activation = get_activation_fn(activation_fn)
        self.self_attn_layer_norm = LayerNorm(embed_dim, eps=1e-5)
        self.fc1 = dense(embed_dim, ffn_dim, *qn)
        self.fc2 = dense(ffn_dim, embed_dim, *qn)
        self.final_layer_norm = LayerNorm(embed_dim, eps=1e-5)
        self.drop = Dropout(dropout)
        self.act_drop = Dropout(activation_dropout)

    def forward(self, x: torch.Tensor,
                self_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual = x
        if self.normalize_before:
            x = self.self_attn_layer_norm(x)
        x = residual + self.drop(self.self_attn(
            x, key_padding_mask=self_padding_mask))
        if not self.normalize_before:
            x = self.self_attn_layer_norm(x)
        residual = x
        if self.normalize_before:
            x = self.final_layer_norm(x)
        x = self.fc2(self.act_drop(self.activation(self.fc1(x))))
        x = residual + self.drop(x)
        if not self.normalize_before:
            x = self.final_layer_norm(x)
        return x


class TransformerDecoder(nn.Module):
    """The LM decoder: token embedding (plain or adaptive input), positions,
    layers, optional final LayerNorm, and the output layer (tied embedding,
    its own projection, or the adaptive softmax, held here as fairseq
    does)."""

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
                 learned_pos: bool = False, activation_fn: str = "relu"):
        super().__init__()
        self.pad_idx = pad_idx
        self.dense_tokens = dense_tokens
        self.learned_pos = learned_pos
        self.share_input_output_embed = share_input_output_embed
        self.embed_scale = math.sqrt(embed_dim)
        if adaptive_input_cutoffs is not None:
            self.embed_tokens = AdaptiveInput(vocab_size, embed_dim,
                                              adaptive_input_cutoffs)
        else:
            self.embed_tokens = nn.Embedding(vocab_size, embed_dim)
        if learned_pos:
            # fairseq LearnedPositionalEmbedding: padding-aware positions,
            # rows 0..pad_idx reserved
            self.embed_positions = nn.Embedding(max_len + pad_idx + 1, embed_dim)
        else:
            self.register_buffer(
                "positions", torch.from_numpy(sinusoidal_positions(max_len, embed_dim)),
                persistent=False)
        self.embed_dropout = Dropout(dropout)
        self.layers = nn.ModuleList(
            DecoderLayer(embed_dim, ffn_dim, num_heads, attn_name=attn_name,
                         attn_args=attn_args, dropout=dropout,
                         normalize_before=normalize_before,
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

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed_tokens(tokens) * self.embed_scale
        if self.learned_pos:
            keep = (tokens != self.pad_idx).long()
            positions = torch.cumsum(keep, dim=1) * keep + self.pad_idx
            return x + self.embed_positions(positions).to(x.dtype)
        # keep the activation dtype (the f32 table would promote bf16)
        return x + self.positions[:tokens.shape[1]].to(x.dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Features ``[B, T, D]`` of ``tokens [B, T]``."""
        # the dense TokenBlock pipeline promises no pads: no mask, which is
        # what lets causal EVA take the K3 kernel
        padding_mask = None if self.dense_tokens else tokens == self.pad_idx
        x = self.embed_dropout(self._embed(tokens))
        for layer in self.layers:
            x = layer(x, padding_mask)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return x

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
        unported = [
            (seq_axis is not None, "sequence parallelism", "Queue 1, item 7"),
            (base_layers, "BASE layers", "Queue 1, item 7"),
            (checkpoint_activations, "--checkpoint-activations",
             "Queue 1, item 5"),
            (layerdrop > 0.0, "--decoder-layerdrop", "Queue 1, item 5"),
        ]
        for bad, what, item in unported:
            if bad:
                raise NotImplementedError(
                    f"{what} is not ported yet; see ROADMAP.md {item}")
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
            learned_pos=learned_pos, activation_fn=activation_fn)

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
def init_lm_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter from ``generator`` as the JAX package
    initialises the LM: attention q/k/v projections and the adaptive mu
    projections ``variance_scaling(0.5, fan_avg, uniform)``, output
    projections, adaptive-input projections and cluster heads Xavier
    uniform, feed-forward and output Linears LeCun normal, embeddings
    normal(dim^-0.5), the T5 table normal(1), zero biases, unit LayerNorms.
    Draws on the CPU, so one seed gives the same weights on every device."""
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

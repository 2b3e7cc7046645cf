"""Carry the JAX package's flax parameters into the port's modules.

``state_dict_from_jax`` walks a flax param tree (nested dicts of numpy
arrays, as ``flax.linen.Module.init`` returns them after ``np.asarray``) and
names every leaf as the reference PyTorch model does, with the port's own
copy of the flax -> reference name rules of
``efficient_attention_tpu/interop.py:56-105``.  Layouts follow: Dense
``[in, out]`` becomes Linear ``[out, in]``, conv HWIO becomes OIHW, LayerNorm
``scale`` becomes ``weight``.  ``load_jax_params`` loads the result into a
module and accepts as missing only the buffers the port derives itself.
Performer's eval projection, which the JAX package recomputes on every call
and keeps out of its params, is the port's ``random_proj`` buffer:
``load_jax_params`` takes the JAX matrix for it as a numpy array.

The language models take ``lm_state_dict_from_jax`` (flax ``TransformerLM``
params, by the rules of ``interop.py:140-269`` there) and
``lm_state_dict_from_fairseq`` (a reference checkpoint); both give a state
dict that ``TransformerLM.load_state_dict(strict=True)`` takes.  The
translation model takes ``mt_state_dict_from_jax`` (flax
``TransformerModel`` params) and ``mt_state_dict_from_fairseq`` (a
reference ``transformer`` checkpoint), for
``TransformerModel.load_state_dict(strict=True)``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

# attention classes appear in flax paths by class name (factory-built inside
# Block); the reference names the submodule 'attn' (efficient_vit.py:112)
_ATTN_CLASSES = (
    "EVA", "LocalAttention", "MultiheadAttention", "KernelizedAttention",
    "RandomizedAttention", "LinearRA", "ScatterBrain", "CausalEVAttention",
)

# flax path component -> reference component
_COMPONENT_MAP = {
    "GatedMlp_0": "mlp",
    "MlpWithDepthwiseConv_0": "mlp",
    "Dense_0": "fc1",
    "Dense_1": "fc2",
    "Conv_0": "dwconv.dwconv",
    "LayerNorm_0": "norm1",
    "LayerNorm_1": "norm2",
    "layers_0": "0",
    "layers_1": "1",
}

# (parent, flax child) -> reference child, where the child's name depends on
# its parent: LARA's landmark generators hold Linear+LayerNorm as items 2
# and 3 of a Sequential (the reference's items 0 and 1 are parameter-free
# pooling steps), and the learned Fourier features' Dense is ``dense``
_CHILD_MAP = {
    ("q_bar_gen", "layers_0"): "2", ("q_bar_gen", "layers_1"): "3",
    ("k_bar_gen", "layers_0"): "2", ("k_bar_gen", "layers_1"): "3",
    ("feature_proj_module", "Dense_0"): "dense",
}

# buffers the port derives from its configuration
DERIVED_BUFFERS = ("relative_position_index",)

_PVT_BLOCK = re.compile(r"block(\d+)_(\d+)")


def flax_path_to_torch_key(parts, conv_stems=()) -> str:
    """``['blocks_0', 'EVA_0', 'qkv', 'kernel'] -> 'blocks.0.attn.qkv.weight'``
    (PVT paths as well: ``block1_0`` -> ``block1.0.attn.attn_fn``).  In the
    ``patch_embed*`` named in ``conv_stems`` (PVT's ``use_conv_patchify``
    stem, the ViT's ``conv`` and ``hmlp`` stems), ``Conv_i`` and
    ``GroupNorm_i`` are items ``3i`` and ``3i + 1`` of the port's ``proj``
    Sequential."""
    pvt = any(_PVT_BLOCK.fullmatch(p) for p in parts)
    body, out = parts[:-1], []
    i = 0
    while i < len(body):
        p = body[i]
        m = _PVT_BLOCK.fullmatch(p)
        if p.startswith("blocks_"):
            out.append("blocks." + p[len("blocks_"):])
        elif m:
            out.append(f"block{m.group(1)}.{m.group(2)}")
        elif any(p == f"{c}_0" for c in _ATTN_CLASSES):
            out.append("attn.attn_fn" if pvt else "attn")
        elif p.startswith("patch_embed"):
            child = body[i + 1] if i + 1 < len(body) else ""
            if p in conv_stems and child != "LayerNorm_0":
                kind, n = child.rsplit("_", 1)
                out.append(f"{p}.proj.{3 * int(n) + (kind == 'GroupNorm')}")
            else:
                out.append(p + (".norm" if child == "LayerNorm_0" else ".proj"))
            i += 2
            continue
        elif i > 0 and (body[i - 1], p) in _CHILD_MAP:
            out.append(_CHILD_MAP[(body[i - 1], p)])
        elif p in _COMPONENT_MAP:
            out.append(_COMPONENT_MAP[p])
        else:
            out.append(p)
        i += 1
    leaf = parts[-1]
    if leaf in ("kernel", "scale"):
        out.append("weight")
    elif leaf == "relative_attention_bias":  # the T5 table, an Embedding
        out.append("relative_attention_bias.weight")
    else:
        out.append(leaf)  # bias and named tables
    return ".".join(out)


def _to_torch_layout(value: np.ndarray, leaf: str) -> np.ndarray:
    v = np.asarray(value, np.float32)
    if leaf == "kernel":
        if v.ndim == 2:
            return v.T
        if v.ndim == 4:  # conv HWIO -> OIHW
            return v.transpose(3, 2, 0, 1)
    return v


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax param tree (with or without its ``params`` collection
    key) onto the reference's parameter names, in PyTorch layouts."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    conv_stems = {k for k, v in params.items()
                  if k.startswith("patch_embed") and "GroupNorm_0" in v}
    out: Dict[str, torch.Tensor] = {}
    for parts, val in _flatten(params):
        key = flax_path_to_torch_key(list(parts), conv_stems)
        if key in out:
            raise ValueError(f"two flax leaves map to {key!r}")
        out[key] = torch.from_numpy(
            np.ascontiguousarray(_to_torch_layout(val, parts[-1])))
    return out


# ---------------------------------------------------------------- language --

# flax LM/MT component -> fairseq component (the JAX package's
# ``_LM_COMPONENT_MAP``, plus the untied adaptive softmax's tails)
_LM_COMPONENT_MAP = {
    "ln_self": "self_attn_layer_norm",
    "ln_cross": "encoder_attn_layer_norm",
    "ln_ffn": "final_layer_norm",
    "cross_attn": "encoder_attn",
    "final_ln": "layer_norm",
    "class_proj": "head.class_proj",
    "shared_embed": "encoder.embed_tokens",
    "layers_0": "0",
    "layers_1": "1",
    "layers_2": "2",
}
# the MT encoder layer's components, which flax auto-names (``@nn.compact``)
_ENCODER_COMPONENT_MAP = {
    "LayerNorm_0": "self_attn_layer_norm",
    "LayerNorm_1": "final_layer_norm",
    "Dense_0": "fc1",
    "Dense_1": "fc2",
}
_LM_PREFIXED = re.compile(r"(layer|emb|proj|tail)_(\d+)")
_LM_PREFIX_NAME = {"layer": "layers.{}", "emb": "embeddings.{}.0",
                   "proj": "embeddings.{}.1", "tail": "tail.{}"}
# raw flax params whose fairseq home is an Embedding's weight
_LM_TABLES = {"rel_pos_bias": "rel_pos_bias.relative_attention_bias.weight",
              "embed_positions": "embed_positions.weight"}


def lang_flax_path_to_torch_key(parts) -> str:
    """``['decoder', 'layer_0', 'self_attn', 'q_proj', 'kernel'] ->
    'decoder.layers.0.self_attn.q_proj.weight'``; the adaptive softmax,
    beside the decoder in flax, sits inside it in fairseq; the MT encoder's
    factory-built attention (``['encoder', 'layer_0', 'EVA_0', ...]``) sits
    behind the fork's ``EfficientAttention`` bridge as
    ``self_attn.attn``."""
    out = ["decoder"] if parts[0] == "adaptive_softmax" else []
    cmap = dict(_LM_COMPONENT_MAP)
    if parts[0] == "encoder":
        cmap.update(_ENCODER_COMPONENT_MAP)
    for p in parts[:-1]:
        m = _LM_PREFIXED.fullmatch(p)
        if m:
            out.append(_LM_PREFIX_NAME[m.group(1)].format(m.group(2)))
        elif any(p == f"{c}_0" for c in _ATTN_CLASSES):
            out.append("self_attn.attn")
        else:
            out.append(cmap.get(p, p))
    leaf = parts[-1]
    if leaf in _LM_TABLES:
        out.append(_LM_TABLES[leaf])
    elif leaf == "relative_attention_bias":  # 1-D EVA's T5 table
        out.append("relative_attention_bias.weight")
    else:
        out.append("weight" if leaf in ("kernel", "scale", "embedding") else leaf)
    return ".".join(out)


def lm_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``TransformerLM`` state dict from the JAX package's flax
    params (the direction of JAX ``interop.convert_lang_state_dict``
    reversed): fairseq names, Dense kernels transposed to Linear layout."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for parts, val in _flatten(params):
        key = lang_flax_path_to_torch_key(list(parts))
        if key in out:
            raise ValueError(f"two flax leaves map to {key!r}")
        out[key] = torch.from_numpy(
            np.ascontiguousarray(_to_torch_layout(val, parts[-1])))
    return out


# fairseq buffers the port derives itself
_FAIRSEQ_BUFFERS = ("._float_tensor", ".version")
_TIED_TAIL = re.compile(r"adaptive_softmax\.tail\.(\d+)\.(\d+)\.weight$")


def lm_state_dict_from_fairseq(state_dict: Mapping[str, Any],
                               tied: bool = True) -> Dict[str, torch.Tensor]:
    """A fairseq ``transformer_lm`` state dict for the port's
    ``TransformerLM``: the buffers the port derives are dropped, and with
    ``tied`` (``--tie-adaptive-weights --tie-adaptive-proj``) the adaptive
    softmax's word and tail tensors, which fairseq stores as second names
    of the adaptive-input bands, are checked to mirror those bands and
    dropped."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()}
    out = {}
    for k, v in sd.items():
        if k.endswith(_FAIRSEQ_BUFFERS):
            continue
        band = None
        if tied and k.endswith("adaptive_softmax.head.word_proj.weight"):
            band = k.split("adaptive_softmax")[0] + "embed_tokens.embeddings.0.0.weight"
        elif tied and _TIED_TAIL.search(k):
            i, j = (int(x) for x in _TIED_TAIL.search(k).groups())
            # tail i's first Linear is band i+1's projection, its last the
            # band's embedding
            band = (k.split("adaptive_softmax")[0]
                    + f"embed_tokens.embeddings.{i + 1}.{1 if j == 0 else 0}.weight")
        if band is not None:
            if band not in sd or not torch.equal(sd[band], v):
                raise ValueError(f"{k!r} does not mirror {band!r}: the adaptive "
                                 "softmax is not tied to the adaptive input")
            continue
        out[k] = v
    return out


# ------------------------------------------------------------- translation --
def mt_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``TransformerModel`` state dict from the JAX package's
    flax params (the names of ``lm_state_dict_from_jax``); a shared
    embedding table (``share_all_embeddings``) under both the encoder's and
    the decoder's name."""
    out = lm_state_dict_from_jax(params)
    if "encoder.embed_tokens.weight" in out and "decoder.embed_tokens.weight" not in out:
        out["decoder.embed_tokens.weight"] = out["encoder.embed_tokens.weight"]
    return out


def mt_state_dict_from_fairseq(state_dict: Mapping[str, Any],
                               share_all_embeddings: bool = True
                               ) -> Dict[str, torch.Tensor]:
    """A fairseq ``transformer`` state dict for the port's
    ``TransformerModel``: the buffers the port derives are dropped, and so
    is ``decoder.output_projection.weight``, which the port ties to the
    decoder's input embedding (as the JAX model does) and which must mirror
    it; with ``share_all_embeddings`` the decoder's embedding must mirror
    the encoder's."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()}
    mirrors = {"decoder.output_projection.weight": "decoder.embed_tokens.weight"}
    if share_all_embeddings:
        mirrors["decoder.embed_tokens.weight"] = "encoder.embed_tokens.weight"
    for tied, source in mirrors.items():
        if tied in sd and (source not in sd or not torch.equal(sd[tied], sd[source])):
            raise ValueError(f"{tied!r} does not mirror {source!r}: the "
                             "checkpoint's embeddings are not tied")
    return {k: v for k, v in sd.items()
            if not k.endswith(_FAIRSEQ_BUFFERS)
            and k != "decoder.output_projection.weight"}


def load_jax_params(module: nn.Module, params: Mapping[str, Any],
                    random_proj: Optional[np.ndarray] = None) -> nn.Module:
    """Load flax params into ``module`` with ``load_state_dict(strict=True)``.
    The buffers the port derives are kept as the module made them.  Every
    ``random_proj`` buffer (Performer's eval projection ``[H, m, d]``, which
    the JAX package recomputes on every call instead of storing) takes
    ``random_proj``, the JAX matrix as a numpy array; a module that has such
    a buffer needs it."""
    sd = state_dict_from_jax(params)
    own = module.state_dict()
    for name, value in own.items():
        if name in sd:
            continue
        if name.endswith(DERIVED_BUFFERS):
            sd[name] = value
        elif name.endswith("random_proj") and random_proj is not None:
            sd[name] = torch.from_numpy(np.array(random_proj, np.float32))
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise ValueError(f"flax params do not fit the module: missing "
                         f"{missing}, unexpected {unexpected}")
    module.load_state_dict(sd, strict=True)
    return module

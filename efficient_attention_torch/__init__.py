"""efficient_attention_torch: the PyTorch/CUDA port of efficient_attention_tpu.

A second package beside the JAX one, which stays the reference.  Plain tensor
code is PyTorch; every TPU kernel on a ported path is a kernel written by
hand for Hopper (``csrc/``), with a plain PyTorch version beside it.  The
public surface mirrors the reference factory
(``efficient-attention/efficient_attention/__init__.py:43-79``):

    AttentionFactory.build_attention(name, attn_args_dict) -> nn.Module
    AttentionFactory.add_attn_specific_args(parser, name, struct_name, prefix)
    NestedNamespace / add_nested_argument / remove_argument

ROADMAP.md lists what is ported and what is still to come.
"""
import inspect
import logging
from typing import Any, Dict

from efficient_attention_torch.attention import EVA, LocalAttention, MultiheadAttention
from efficient_attention_torch.attention.causal_eva import CausalEVAttention
from efficient_attention_torch.attention.kernelized import KernelizedAttention
from efficient_attention_torch.attention.lara import LinearRA
from efficient_attention_torch.config import (
    NestedNamespace,
    add_nested_argument,
    namespace_to_dict,
    remove_argument,
)

__version__ = "0.1.0"

# names the JAX package registers whose modules are not ported yet
_NOT_PORTED = {
    "ra": "ROADMAP.md Queue 1, item 4",
    "scatterbrain": "ROADMAP.md Queue 1, item 4",
}


class AttentionFactory:
    """Name -> module registry (reference ``__init__.py:52-79``)."""

    attn_dict = {
        "softmax": MultiheadAttention,
        "local": LocalAttention,
        "eva": EVA,
        "causal_eva": CausalEVAttention,
        "performer": KernelizedAttention,
        "lara": LinearRA,
    }

    @classmethod
    def _lookup(cls, attn_name: str):
        if attn_name in cls.attn_dict:
            return cls.attn_dict[attn_name]
        if attn_name in _NOT_PORTED:
            raise KeyError(f"attention {attn_name!r} is not ported yet; see "
                           f"{_NOT_PORTED[attn_name]}")
        raise KeyError(f"unknown attention {attn_name!r}; available: "
                       f"{sorted(cls.attn_dict)}")

    @classmethod
    def build_attention(cls, attn_name: str, attn_args: Dict[str, Any]):
        attn_cls = cls._lookup(attn_name)
        # tolerate reference-CLI keys that are not constructor arguments
        valid = set(inspect.signature(attn_cls.__init__).parameters) - {"self"}
        kwargs = {k: v for k, v in attn_args.items() if k in valid}
        dropped = set(attn_args) - set(kwargs)
        if dropped:
            logging.getLogger(__name__).debug(
                "AttentionFactory: dropping unknown args %s for %s",
                sorted(dropped), attn_name)
        return attn_cls(**kwargs)

    @classmethod
    def add_attn_specific_args(
        cls, parent_parser, attn_name, struct_name="attn_args", prefix=""
    ):
        return cls._lookup(attn_name).add_attn_specific_args(
            parent_parser, struct_name=struct_name, prefix=prefix)


__all__ = [
    "AttentionFactory",
    "NestedNamespace",
    "add_nested_argument",
    "remove_argument",
    "namespace_to_dict",
    "MultiheadAttention",
    "LocalAttention",
    "EVA",
    "CausalEVAttention",
    "KernelizedAttention",
    "LinearRA",
]

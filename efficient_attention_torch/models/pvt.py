"""PVTv2: the 4-stage pyramid vision transformer.

PyTorch counterpart of ``efficient_attention_tpu/models/pvt.py`` (reference
``vit/models/pvt_legacy.py``).  Stage ``i`` uses the factory attention when
its ``sr_ratio > 1`` (the 3136/784/196-token stages at 224 px) and exact
softmax for the last, 49-token stage (``pvt_legacy.py:78-87``).  Tokens stay
``[B, H, W, C]`` grids between stages.  Parameter names are the
reference's (``patch_embed{i}.{proj,norm}``, ``block{i}.{j}.attn.attn_fn``,
``mlp.dwconv.dwconv``, ``norm{i}``, ``head``), so its ``state_dict``s load
with ``load_state_dict``.  Registered archs mirror ``pvt_legacy.py:322-471``:
``pvt_{nano,tiny,small,medium,base,large}`` and the head-doubled ``*2``
variants.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from efficient_attention_torch import AttentionFactory
from efficient_attention_torch.models.layers import (
    DropPath,
    MlpWithDepthwiseConv,
    OverlapPatchEmbed,
)
from efficient_attention_torch.models.registry import register_model


class PVTBlock(nn.Module):
    """PVT block over ``[B, H, W, C]`` grids (``pvt_legacy.py:95-132``):
    pre-LN attention and depthwise-conv MLP, each with stochastic depth.  The
    attention sits in ``attn.attn_fn``, as behind the reference's shim."""

    def __init__(self, attn_name: str, attn_args: Dict[str, Any], dim: int,
                 num_heads: int, mlp_ratio: float, sr_ratio: int,
                 qkv_bias: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 linear: bool = False):
        super().__init__()
        base_args = {"dim": dim, "num_heads": num_heads, "qkv_bias": qkv_bias,
                     "attn_drop": attn_drop, "proj_drop": drop}
        if sr_ratio > 1:
            args = {**attn_args, **base_args}
            if args.get("kernel_size") is not None:
                args["kernel_size"] = sr_ratio
            attn = AttentionFactory.build_attention(attn_name, args)
        else:
            attn = AttentionFactory.build_attention("softmax", base_args)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = nn.ModuleDict({"attn_fn": attn})
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MlpWithDepthwiseConv(dim, int(dim * mlp_ratio), drop=drop,
                                        linear=linear)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path(self.attn.attn_fn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PyramidVisionTransformerV2(nn.Module):
    """4-stage PVTv2 (``pvt_legacy.py:192-282``); images ``[B, H, W, 3]``."""

    def __init__(self, attn_name: str = "softmax",
                 attn_args: Optional[Dict[str, Any]] = None,
                 img_size: int = 224, in_chans: int = 3, num_classes: int = 1000,
                 embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 mlp_ratios: Sequence[float] = (8, 8, 4, 4),
                 depths: Sequence[int] = (2, 2, 2, 2),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.1,
                 linear: bool = False, use_conv_patchify: bool = False,
                 checkpoint_activations: bool = False):
        super().__init__()
        if checkpoint_activations:
            raise NotImplementedError(
                "--checkpoint-activations (rematerialised blocks) is not "
                "ported yet; see ROADMAP.md Queue 1, item 3")
        self.num_classes = num_classes
        # stochastic depth grows linearly over all blocks (pvt.py:103)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        cur = 0
        for i in range(4):
            setattr(self, f"patch_embed{i + 1}", OverlapPatchEmbed(
                patch_size=7 if i == 0 else 3, stride=4 if i == 0 else 2,
                in_chans=in_chans if i == 0 else embed_dims[i - 1],
                embed_dim=embed_dims[i],
                use_conv_patchify=use_conv_patchify and i == 0))
            setattr(self, f"block{i + 1}", nn.ModuleList([
                PVTBlock(attn_name, dict(attn_args or {}), embed_dims[i],
                         num_heads[i], mlp_ratios[i], sr_ratios[i],
                         qkv_bias=qkv_bias, drop=drop_rate,
                         attn_drop=attn_drop_rate, drop_path=dpr[cur + j],
                         linear=linear)
                for j in range(depths[i])]))
            setattr(self, f"norm{i + 1}", nn.LayerNorm(embed_dims[i], eps=1e-6))
            cur += depths[i]
        if num_classes > 0:
            self.head = nn.Linear(embed_dims[3], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            x = getattr(self, f"patch_embed{i}")(x)
            for blk in getattr(self, f"block{i}"):
                x = blk(x)
            x = getattr(self, f"norm{i}")(x)
        x = x.mean(dim=(1, 2))
        if self.num_classes > 0:
            x = self.head(x)
        return x

    @staticmethod
    def add_model_specific_args(parent_parser):
        parser = parent_parser.add_argument_group("PVT")
        parser.add_argument("--use-conv-patchify", action="store_true",
                            default=False)
        return parent_parser


def _pvt(depths, num_heads=(1, 2, 5, 8), embed_dims=(64, 128, 320, 512),
         mlp_ratios=(8, 8, 4, 4), **kw):
    kw.setdefault("drop_path_rate", 0.1)
    kw.pop("num_heads_override", None)
    return PyramidVisionTransformerV2(
        depths=depths, num_heads=num_heads, embed_dims=embed_dims,
        mlp_ratios=mlp_ratios, **kw)


@register_model
def pvt_nano(**kw):
    return _pvt((2, 2, 2, 2), embed_dims=(32, 64, 160, 256), **kw)


@register_model
def pvt_tiny(**kw):
    return _pvt((2, 2, 2, 2), **kw)


@register_model
def pvt_small(**kw):
    return _pvt((3, 4, 6, 3), **kw)


@register_model
def pvt_medium(**kw):
    return _pvt((3, 4, 18, 3), **kw)


@register_model
def pvt_base(**kw):
    return _pvt((3, 8, 27, 3), **kw)


@register_model
def pvt_large(**kw):
    return _pvt((3, 6, 40, 3), mlp_ratios=(4, 4, 4, 4), **kw)


@register_model
def pvt_tiny2(**kw):
    return _pvt((2, 2, 2, 2), num_heads=(2, 4, 10, 16), **kw)


@register_model
def pvt_small2(**kw):
    return _pvt((3, 4, 6, 3), num_heads=(2, 4, 10, 16), **kw)


@register_model
def pvt_medium2(**kw):
    return _pvt((3, 4, 18, 3), num_heads=(2, 4, 10, 16), **kw)


@register_model
def pvt_base2(**kw):
    return _pvt((3, 8, 27, 3), num_heads=(2, 4, 10, 16), **kw)


@register_model
def pvt_large2(**kw):
    return _pvt((3, 6, 40, 3), num_heads=(2, 4, 10, 16),
                mlp_ratios=(4, 4, 4, 4), **kw)

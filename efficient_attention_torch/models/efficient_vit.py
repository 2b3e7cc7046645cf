"""DeiT-style EfficientTransformer keeping tokens as a ``[B, H, W, C]`` grid.

PyTorch counterpart of ``efficient_attention_tpu/models/efficient_vit.py``
(reference ``vit/models/efficient_vit.py``): pre-LN blocks with
factory-built attention, GatedMlp and stochastic depth, a learned 2-D
positional embedding, no CLS token (mean-pool head), and with
``checkpoint_activations`` each block recomputed in the backward in
training.  Parameter names are
the reference's, so its ``state_dict``s load with ``load_state_dict``.
Registered architectures: ``evit_{tiny,small,base}_p{16,8}`` and
``evit_{tiny,small}_p4``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from efficient_attention_torch import AttentionFactory
from efficient_attention_torch.models.layers import (
    DropPath,
    Dropout,
    GatedMlp,
    PatchEmbed,
    run_layer,
)
from efficient_attention_torch.models.registry import register_model


class Block(nn.Module):
    """Pre-LN transformer block (``efficient_vit.py:97-121``)."""

    def __init__(self, attn_name: str, attn_args: Dict[str, Any], dim: int,
                 mlp_ratio: float, drop_path: float, drop_rate: float = 0.0,
                 use_glu: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = AttentionFactory.build_attention(attn_name, attn_args)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = GatedMlp(dim, int(dim * mlp_ratio), drop=drop_rate,
                            use_glu=use_glu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class EfficientTransformer(nn.Module):
    """Grid-token ViT (``efficient_vit.py:123-249``); images ``[B, H, W, 3]``."""

    def __init__(self, attn_name: str = "softmax",
                 attn_args: Optional[Dict[str, Any]] = None,
                 img_size: int = 224, patch_size: int = 16, in_chans: int = 3,
                 num_classes: int = 1000, embed_dim: int = 192, depth: int = 12,
                 num_heads: int = 3, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 patchify_stem: str = "default", use_glu: bool = False,
                 use_pos_emb: bool = True,
                 checkpoint_activations: bool = False):
        super().__init__()
        self.num_classes = num_classes
        # --checkpoint-activations: each block recomputed in the backward
        # (JAX ``efficient_vit.py:129-133``), through ``run_layer``, which
        # hands the recompute this generator's state (set_generator's)
        self.checkpoint_activations = checkpoint_activations
        self.generator: Optional[torch.Generator] = None
        self.use_pos_emb = use_pos_emb
        self.patch_embed = PatchEmbed(patch_size, embed_dim, in_chans,
                                      stem_type=patchify_stem)
        grid = img_size // patch_size
        if use_pos_emb:
            self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
            nn.init.trunc_normal_(self.pos_embed, std=0.02)
            self.pos_drop = Dropout(drop_rate)
        merged_attn_args = {
            **(attn_args or {}),
            "dim": embed_dim,
            "num_heads": num_heads,
            "qkv_bias": qkv_bias,
            "attn_drop": attn_drop_rate,
            "proj_drop": drop_rate,
        }
        # stochastic depth grows linearly over the blocks (JAX
        # ``efficient_vit.py:104``)
        dpr = [float(x) for x in np.linspace(0, drop_path_rate, depth)]
        self.blocks = nn.ModuleList([
            Block(attn_name, merged_attn_args, embed_dim, mlp_ratio, dpr[i],
                  drop_rate=drop_rate, use_glu=use_glu)
            for i in range(depth)
        ])
        self.norm_before_pooling = nn.LayerNorm(embed_dim, eps=1e-6)
        if num_classes > 0:
            self.head = nn.Linear(embed_dim, num_classes)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)  # [B, H, W, C]
        if self.use_pos_emb:
            # the table follows the activations' dtype, so a bf16 stream
            # stays bf16 past the add
            x = self.pos_drop(x + self.pos_embed.to(x.dtype))
        B, H, W, C = x.shape
        for blk in self.blocks:
            x = run_layer(blk, (x,), remat=self.checkpoint_activations,
                          layerdrop=0.0, generator=self.generator,
                          training=self.training)
        x = self.norm_before_pooling(x.reshape(B, H * W, C))
        return x.mean(dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.forward_features(x)
        if self.num_classes > 0:
            x = self.head(x)
        return x

    @staticmethod
    def add_model_specific_args(parent_parser):
        parser = parent_parser.add_argument_group("Deit")
        parser.add_argument("--patchify-stem", default="default", type=str)
        parser.add_argument("--num-heads", default=None, type=int)
        parser.add_argument("--use-glu", action="store_true", default=False)
        parser.add_argument("--patch-size", default=16, type=int)
        parser.add_argument("--depth", default=12, type=int,
                            help="number of transformer layers")
        return parent_parser


def _evit(embed_dim: int, num_heads: int, patch_size: int, **kwargs):
    if kwargs.get("num_heads") is None:
        kwargs["num_heads"] = num_heads
    return EfficientTransformer(
        embed_dim=embed_dim, patch_size=patch_size, **kwargs)


@register_model
def evit_tiny_p16(**kw):
    return _evit(192, 3, 16, **kw)


@register_model
def evit_small_p16(**kw):
    return _evit(384, 6, 16, **kw)


@register_model
def evit_base_p16(**kw):
    return _evit(768, 12, 16, **kw)


@register_model
def evit_tiny_p8(**kw):
    return _evit(192, 3, 8, **kw)


@register_model
def evit_small_p8(**kw):
    return _evit(384, 6, 8, **kw)


@register_model
def evit_base_p8(**kw):
    return _evit(768, 12, 8, **kw)


@register_model
def evit_tiny_p4(**kw):
    return _evit(192, 3, 4, **kw)


@register_model
def evit_small_p4(**kw):
    return _evit(384, 6, 4, **kw)

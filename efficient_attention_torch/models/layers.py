"""Shared model layers: dropout, gated MLP, stochastic depth, patch
embeddings, and PVTv2's depthwise-conv MLP and overlapping patch embedding.

PyTorch counterparts of ``efficient_attention_tpu/models/layers.py``
(reference ``vit/models/model_utils.py``, ``vit/models/efficient_vit.py:
32-95`` and ``vit/models/pvt_legacy.py``).  Token grids stay ``[B, H, W, C]``
as in the JAX package; the convolutions permute to PyTorch's NCHW only
around themselves.  As in flax, LayerNorm and GroupNorm take epsilon 1e-6
and GELU is the tanh form.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from efficient_attention_torch.attention.base import Dropout


def set_generator(model: nn.Module,
                  generator: Optional[torch.Generator]) -> nn.Module:
    """Hand ``generator`` to every module of ``model`` that draws random
    numbers in training (``Dropout``, ``DropPath``, EVA's RF noise): the
    train step's counterpart of flax's ``rngs={"dropout", "sample"}``."""
    for module in model.modules():
        if hasattr(module, "generator"):
            module.generator = generator
    return model


def run_layer(layer: nn.Module, args, *, remat: bool, layerdrop: float,
               generator: Optional[torch.Generator], training: bool):
    """``layer(*args)`` through the training-time wrappers (JAX
    ``transformer.py:66-97``, and ``nn.remat`` of each block in
    ``efficient_vit.py:129-133`` and ``pvt.py:126-130``).

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


class DropPath(nn.Module):
    """Stochastic depth (timm ``DropPath``, JAX ``models/layers.py:31``),
    active in training mode only.  ``generator`` draws the per-sample keep
    mask (None: torch's default one)."""

    def __init__(self, rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        u = torch.rand(shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class GatedMlp(nn.Module):
    """MLP with optional GLU gating (``vit/models/model_utils.py:11-45``).

    The activation is GELU with the tanh approximation, as flax's
    ``nn.gelu`` is."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, drop: float = 0.0,
                 use_glu: bool = False):
        super().__init__()
        out_features = out_features or in_features
        self.use_glu = use_glu
        if use_glu:
            # 2/3 hidden scaling as in the reference (``model_utils.py:20-24``)
            hidden_features = int(2 * hidden_features / 3)
            self.fc1 = nn.Linear(in_features, hidden_features * 2)
        else:
            self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x)
        if self.use_glu:
            x1, x2 = x.chunk(2, dim=-1)
            x = F.gelu(x1, approximate="tanh") * x2
        else:
            x = F.gelu(x, approximate="tanh")
        x = self.fc2(self.drop(x))
        return self.drop(x)


class PatchEmbed(nn.Module):
    """Image-to-grid patch embedding, ``[B, H, W, 3] -> [B, H/p, W/p, d]``.
    Only the ``default`` single-conv stem is ported; ``conv`` and ``hmlp``
    are ROADMAP.md Queue 1, item 2."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 in_chans: int = 3, stem_type: str = "default"):
        super().__init__()
        if stem_type != "default":
            raise NotImplementedError(
                f"patchify stem {stem_type!r} is not ported yet; see "
                "ROADMAP.md Queue 1, item 2")
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x.permute(0, 3, 1, 2))
        return x.permute(0, 2, 3, 1)


def _conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (NCHW) applied to a ``[B, H, W, C]`` grid."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class DWConv(nn.Module):
    """The 3x3 depthwise convolution of PVTv2's MLP (``pvt_legacy.py``
    ``DWConv:285-296``; the reference's ``dwconv.dwconv`` names)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(self.dwconv, x)


class MlpWithDepthwiseConv(nn.Module):
    """PVTv2 MLP on ``[B, H, W, C]`` grids (JAX ``models/layers.py:76-101``):
    fc1, a ReLU when ``linear``, the 3x3 depthwise conv, GELU (tanh form),
    fc2."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, drop: float = 0.0,
                 linear: bool = False):
        super().__init__()
        self.linear = linear
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.dwconv = DWConv(hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features or in_features)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x)
        if self.linear:
            x = F.relu(x)
        x = F.gelu(self.dwconv(x), approximate="tanh")
        x = self.fc2(self.drop(x))
        return self.drop(x)


class OverlapPatchEmbed(nn.Module):
    """PVTv2 overlapping patch embedding (JAX ``models/layers.py:154-190``),
    ``[B, H, W, C] -> [B, H/stride, W/stride, d]``: a ``patch x patch`` conv
    with padding ``patch // 2``, then LayerNorm.  With ``use_conv_patchify``
    the 3-conv stem instead (two stride-2 3x3 convs to d/4 and d/2 channels
    and a stride-1 one to d, each followed by GroupNorm(1), the first two by
    GELU), whose modules are ``proj.0`` to ``proj.7``."""

    def __init__(self, patch_size: int = 7, stride: int = 4, in_chans: int = 3,
                 embed_dim: int = 768, use_conv_patchify: bool = False):
        super().__init__()
        d = embed_dim
        if use_conv_patchify:
            gelu = functools.partial(nn.GELU, approximate="tanh")
            self.proj = nn.Sequential(
                nn.Conv2d(in_chans, d // 4, 3, stride=2, padding=1),
                nn.GroupNorm(1, d // 4, eps=1e-6), gelu(),
                nn.Conv2d(d // 4, d // 2, 3, stride=2, padding=1),
                nn.GroupNorm(1, d // 2, eps=1e-6), gelu(),
                nn.Conv2d(d // 2, d, 3, stride=1, padding=1),
                nn.GroupNorm(1, d, eps=1e-6))
        else:
            self.proj = nn.Conv2d(in_chans, d, patch_size, stride=stride,
                                  padding=patch_size // 2)
        self.norm = nn.LayerNorm(d, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(_conv_nhwc(self.proj, x))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter from ``generator`` as the JAX package
    initialises its modules: truncated-normal(0.02) Linear weights, learned
    tables and embeddings, zero biases, unit LayerNorms and GroupNorms,
    convolutions
    normal(0, sqrt(2/fan_out)) and learned Fourier projections normal(0,
    0.02); a Performer's learnable projection keeps the orthogonal matrix it
    was made with.  Draws on the CPU, so one seed gives the same weights on
    every device."""
    from efficient_attention_torch.attention.kernelized import (
        KernelizedAttention,
    )

    for module in model.modules():
        for name, param in module.named_parameters(recurse=False):
            cpu = torch.empty(param.shape, dtype=torch.float32)
            if name == "random_proj" and isinstance(module, KernelizedAttention):
                continue
            if name == "random_proj":
                cpu.normal_(0.0, 0.02, generator=generator)
            elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
                cpu.fill_(1.0 if name == "weight" else 0.0)
            elif name == "bias":
                cpu.zero_()
            elif isinstance(module, nn.Conv2d):
                kh, kw = module.kernel_size
                cpu.normal_(0.0, math.sqrt(2.0 / (kh * kw * module.out_channels)),
                            generator=generator)
            else:
                nn.init.trunc_normal_(cpu, std=0.02, a=-0.04, b=0.04,
                                      generator=generator)
            param.copy_(cpu)
    return model

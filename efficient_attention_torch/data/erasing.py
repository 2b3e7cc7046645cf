"""Random erasing on the device (timm ``RandomErasing`` semantics).

Counterpart of ``efficient_attention_tpu/data/erasing.py``.  The DeiT recipe
uses ``--reprob 0.25 --remode pixel --recount 1`` (``vit/main.py:119-124``):
each image, with probability ``prob``, gets ``count`` rectangles of area
``[min_area, max_area]`` of the image and log-uniform aspect ratio refilled
with standard normals (``pixel``) or zeros (any other mode, as the JAX
version does).  The rectangle is clamped to fit, where timm retries up to 10
times.  Draws come from a ``torch.Generator`` on the batch's device.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class ErasingConfig(NamedTuple):
    prob: float = 0.25
    min_area: float = 0.02
    max_area: float = 1 / 3
    min_aspect: float = 0.3
    max_aspect: float = 3.3
    mode: str = "pixel"  # 'pixel' (per-pixel normal) | 'const' (zeros)
    count: int = 1


def apply_random_erasing(images: torch.Tensor, cfg: ErasingConfig,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Per-image random erasing over a batch ``[B, H, W, C]``."""
    if cfg.prob <= 0.0:
        return images
    B, h, w, _ = images.shape
    dev = images.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(B, generator=generator, device=dev)

    coin = torch.rand(B, generator=generator, device=dev) < cfg.prob
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    out = images
    for _ in range(cfg.count):
        area = uniform(cfg.min_area, cfg.max_area) * (h * w)
        aspect = torch.exp(uniform(math.log(cfg.min_aspect),
                                   math.log(cfg.max_aspect)))
        eh = torch.round(torch.sqrt(area * aspect)).clamp(1, h).long()
        ew = torch.round(torch.sqrt(area / aspect)).clamp(1, w).long()
        top = (torch.rand(B, generator=generator, device=dev)
               * (h - eh + 1)).long()
        left = (torch.rand(B, generator=generator, device=dev)
                * (w - ew + 1)).long()
        e = lambda v: v[:, None, None]  # noqa: E731
        mask = ((rows >= e(top)) & (rows < e(top + eh))
                & (cols >= e(left)) & (cols < e(left + ew)) & e(coin))
        if cfg.mode == "pixel":
            fill = torch.randn(images.shape, generator=generator, device=dev,
                               dtype=images.dtype)
        else:
            fill = torch.zeros_like(images)
        out = torch.where(mask[..., None], fill, out)
    return out

"""Mixup/CutMix and label smoothing on the device.

Counterpart of ``efficient_attention_tpu/data/mixup.py`` (timm ``Mixup`` as
``vit/main.py:259-265`` uses it), run on the batch where it lies with a
``torch.Generator``.  All three timm pairing modes: ``batch`` (one lambda for
the batch), ``pair`` (one lambda per (i, B-1-i) pair, applied to both) and
``elem`` (an independent lambda and mixup/cutmix choice per sample);
``cutmix_minmax`` switches the box sampler to timm's ``rand_bbox_minmax``.
Each image is mixed with the flipped batch (i with B-1-i), as timm does.

torch's Beta sampler takes no generator, so ``sample_beta`` draws two gamma
variates by Marsaglia and Tsang's method from the generator's normals and
uniforms.  The draws cannot equal JAX's; the tests hold the structure (the
mixing formula, target sums, the box area against lambda) instead.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class MixupConfig(NamedTuple):
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    prob: float = 1.0
    switch_prob: float = 0.5
    label_smoothing: float = 0.1
    num_classes: int = 1000
    mode: str = "batch"  # batch | pair | elem (timm --mixup-mode)
    cutmix_minmax: Optional[Tuple[float, float]] = None


def one_hot_smooth(labels: torch.Tensor, num_classes: int,
                   smoothing: float) -> torch.Tensor:
    """Label-smoothed one-hot targets ``[B, num_classes]`` in float32."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return F.one_hot(labels.long(), num_classes).float() * (on - off) + off


def _uniform(shape, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def sample_gamma(alpha: float, shape, generator: Optional[torch.Generator],
                 device, rounds: int = 16) -> torch.Tensor:
    """Gamma(alpha, 1) variates by Marsaglia and Tsang, with ``rounds``
    proposals per variate (each accepted with probability above 0.95, so
    all of them fail with probability below 1e-20; the mode is taken then).
    ``alpha < 1`` is boosted: Gamma(a) = Gamma(a + 1) * U**(1/a)."""
    shape = tuple(shape)
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    x = torch.randn(shape + (rounds,), generator=generator, device=device)
    u = _uniform(shape + (rounds,), generator, device)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                    + d * torch.log(v.clamp_min(1e-30)))
    first = ok.float().argmax(dim=-1, keepdim=True)  # the first accepted
    g = torch.where(ok.any(dim=-1), d * v.gather(-1, first).squeeze(-1),
                    torch.full(shape, d, device=device))
    if alpha < 1.0:
        g = g * _uniform(shape, generator, device) ** (1.0 / alpha)
    return g


def sample_beta(alpha: float, shape, generator: Optional[torch.Generator],
                device) -> torch.Tensor:
    """Beta(alpha, alpha) variates as a ratio of two gamma variates."""
    x = sample_gamma(alpha, shape, generator, device)
    y = sample_gamma(alpha, shape, generator, device)
    return x / (x + y)


def _rand_bbox(h: int, w: int, lam: torch.Tensor,
               minmax: Optional[Tuple[float, float]],
               generator, device) -> Tuple[torch.Tensor, ...]:
    """Cutmix boxes, one per element of ``lam``.  Default: side ratio
    ``sqrt(1 - lam)`` (timm ``rand_bbox``); with ``minmax``: each side drawn
    uniformly from ``[minmax[0], minmax[1])`` of the image side (timm
    ``rand_bbox_minmax``).  Returns ``(y1, y2, x1, x2)``, int64."""
    shape = lam.shape

    def randint(lo, hi):  # uniform over [lo, hi), lo < hi
        return lo + (_uniform(shape, generator, device) * (hi - lo)).long()

    if minmax is None:
        ratio = torch.sqrt(1.0 - lam)
        cut_h = (h * ratio).long()
        cut_w = (w * ratio).long()
    else:
        lo, hi = minmax
        cut_h = randint(int(h * lo), max(int(h * hi), 1))
        cut_w = randint(int(w * lo), max(int(w * hi), 1))
    cy = randint(0, h)
    cx = randint(0, w)
    y1 = (cy - cut_h // 2).clamp(0, h)
    y2 = (cy + cut_h // 2).clamp(0, h)
    x1 = (cx - cut_w // 2).clamp(0, w)
    x2 = (cx + cut_w // 2).clamp(0, w)
    return y1, y2, x1, x2


def _symmetrize(x: torch.Tensor) -> torch.Tensor:
    """Pair mode: position i and B-1-i share the first half's draw."""
    B = x.shape[0]
    idx = torch.arange(B, device=x.device)
    cond = (idx < B - 1 - idx).reshape((B,) + (1,) * (x.dim() - 1))
    return torch.where(cond, x, x.flip(0))


def apply_mixup(images: torch.Tensor,   # [B, H, W, C]
                labels: torch.Tensor,   # [B] int
                cfg: MixupConfig,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixup/cutmix against the flipped batch; returns ``(mixed images,
    soft targets [B, num_classes] float32)``.  Where one of the two alphas
    is 0, only the other mix is drawn (timm)."""
    B, h, w = images.shape[0], images.shape[1], images.shape[2]
    dev = images.device
    targets = one_hot_smooth(labels, cfg.num_classes, cfg.label_smoothing)
    flipped = images.flip(0)
    targets_flipped = targets.flip(0)

    per_el = cfg.mode in ("elem", "pair")
    if cfg.mode not in ("batch", "pair", "elem"):
        raise ValueError(f"unknown mixup mode {cfg.mode!r}")
    shape = (B,) if per_el else ()
    if cfg.mixup_alpha > 0 and cfg.cutmix_alpha > 0:
        use_cutmix = _uniform(shape, generator, dev) < cfg.switch_prob
    else:
        use_cutmix = torch.full(shape, cfg.cutmix_alpha > 0, device=dev)
    ones = torch.ones(shape, device=dev)
    lam_mix = (sample_beta(cfg.mixup_alpha, shape, generator, dev)
               if cfg.mixup_alpha > 0 else ones)
    lam_cut = (sample_beta(cfg.cutmix_alpha, shape, generator, dev)
               if cfg.cutmix_alpha > 0 else ones)
    apply = _uniform(shape, generator, dev) < cfg.prob
    if cfg.mode == "pair":
        use_cutmix, lam_mix, lam_cut, apply = (
            _symmetrize(t) for t in (use_cutmix, lam_mix, lam_cut, apply))
    y1, y2, x1, x2 = _rand_bbox(h, w, lam_cut, cfg.cutmix_minmax, generator,
                                dev)
    if cfg.mode == "pair":
        y1, y2, x1, x2 = (_symmetrize(t) for t in (y1, y2, x1, x2))

    def el(v):  # per-sample values broadcast over [B, H, W, C]
        return v.reshape(v.shape + (1, 1, 1)) if per_el else v

    def box_edge(v):  # per-sample box edges broadcast over [B, H, W]
        return v.reshape(v.shape + (1, 1)) if per_el else v

    mixed_mix = images * el(lam_mix) + flipped * (1 - el(lam_mix))
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    box = ((yy >= box_edge(y1)) & (yy < box_edge(y2))
           & (xx >= box_edge(x1)) & (xx < box_edge(x2)))[..., None]
    mixed_cut = torch.where(box, flipped, images)
    lam_cut_adj = 1.0 - ((y2 - y1) * (x2 - x1)).float() / (h * w)

    mixed = torch.where(el(use_cutmix), mixed_cut, mixed_mix)
    lam = torch.where(use_cutmix, lam_cut_adj, lam_mix)[..., None]
    soft = targets * lam + targets_flipped * (1 - lam)
    images_out = torch.where(el(apply), mixed, images)
    targets_out = torch.where(apply[..., None], soft, targets)
    return images_out, targets_out


def soft_target_cross_entropy(logits: torch.Tensor,
                              soft_targets: torch.Tensor) -> torch.Tensor:
    """timm ``SoftTargetCrossEntropy`` (the ``vit/engine.py`` criterion),
    its log-softmax taken in float32."""
    return torch.mean(torch.sum(
        -soft_targets * F.log_softmax(logits.float(), dim=-1), dim=-1))

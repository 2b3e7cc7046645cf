"""Optimizer and learning-rate schedule of the ViT recipe.

Counterpart of ``efficient_attention_tpu/training/optim.py`` for the DeiT
recipe (``README.md:104-145``): timm's cosine-with-warmup stepped once per
epoch, and AdamW over timm's weight-decay groups behind a clip of the
global gradient norm.  ``make_optimizer`` is the optax chain
``clip_by_global_norm`` + ``adamw(schedule, mask)`` written over
``torch.optim.AdamW``, whose update is optax's: ``p -= lr * (m_hat /
(sqrt(v_hat) + eps) + wd * p)`` with ``lr = schedule(updates so far)``.
The other optimizers and schedules raise ``NotImplementedError`` with
their ROADMAP.md item.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

Schedule = Callable[[int], float]

# optimizers of the JAX factory not ported yet, and where they are queued
_NOT_PORTED = {
    "adam": "ROADMAP.md Queue 1, item 6 (fairseq Adam)",
    "nag": "ROADMAP.md Queue 1, item 5 (fairseq NAG)",
    "sgd": "ROADMAP.md Queue 1, item 3",
    "adafactor": "ROADMAP.md Queue 1, item 3",
    "adagrad": "ROADMAP.md Queue 1, item 3",
    "adadelta": "ROADMAP.md Queue 1, item 3",
    "adamax": "ROADMAP.md Queue 1, item 3",
    "lamb": "ROADMAP.md Queue 1, item 3",
}


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    warmup_init_lr: float = 1e-6, min_lr: float = 1e-5,
                    steps_per_epoch: int = 0) -> Schedule:
    """DeiT cosine schedule (timm ``CosineLRScheduler`` as ``vit/main.py``
    builds it): linear warmup, then one cosine to ``min_lr``.

    * ``steps_per_epoch`` quantises the step to whole epochs, as DeiT steps
      the scheduler once per epoch (``t_in_epochs=True``); 0 interpolates
      per step.
    * ``warmup_prefix=False``: the cosine's progress counts from step 0,
      warmup included, so it resumes mid-curve after the warmup."""

    def schedule(step: int) -> float:
        step = float(step)
        if steps_per_epoch:
            step = math.floor(step / steps_per_epoch) * steps_per_epoch
        if step < warmup_steps:
            return warmup_init_lr + (base_lr - warmup_init_lr) * (
                step / max(warmup_steps, 1))
        progress = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (
            1 + math.cos(math.pi * progress))

    return schedule


def weight_decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]]
                      ) -> Dict[str, bool]:
    """timm ``add_weight_decay`` grouping, as DeiT's ``create_optimizer``
    builds it: no decay for biases, 1-D weights (LayerNorm) and the model's
    ``no_weight_decay()`` set, which for the reference is only
    ``{pos_embed, cls_token}`` (``efficient_vit.py:205``).  The 2-D RPE
    tables are decayed."""
    mask = {}
    for name, p in named_params:
        parts = name.split(".")
        mask[name] = not (parts[-1] == "bias"
                          or any(n in ("pos_embed", "cls_token") for n in parts)
                          or p.dim() < 2)
    return mask


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32 (optax
    ``global_norm``)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class ClippedAdamW:
    """optax ``chain(clip_by_global_norm(clip_grad), adamw(schedule,
    weight_decay, mask))`` over named parameters whose ``.grad`` holds the
    step's gradient.  The clip scales the gradients by ``clip / norm`` only
    where ``norm >= clip`` (optax), where ``clip_grad_norm_`` would divide
    by ``norm + 1e-6``."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 schedule: Schedule, weight_decay: float = 0.05,
                 clip_grad: Optional[float] = None,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        decay = weight_decay_mask(named)
        self.params = [p for _, p in named]
        self.schedule = schedule
        self.clip_grad = clip_grad
        self.count = 0  # updates applied so far (optax's schedule count)
        groups = [
            {"params": [p for n, p in named if decay[n]],
             "weight_decay": weight_decay},
            {"params": [p for n, p in named if not decay[n]],
             "weight_decay": 0.0},
        ]
        self.torch_optimizer = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=schedule(0), betas=betas,
            eps=eps)

    def zero_grad(self) -> None:
        self.torch_optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        """Clip the gradients, set this update's lr and apply it."""
        if self.clip_grad is not None and self.clip_grad > 0:
            grads = [p.grad for p in self.params if p.grad is not None]
            norm = global_norm(grads)
            factor = torch.where(norm < self.clip_grad,
                                 torch.ones_like(norm), self.clip_grad / norm)
            for g in grads:
                g.mul_(factor.to(g.dtype))
        lr = self.schedule(self.count)
        for group in self.torch_optimizer.param_groups:
            group["lr"] = lr
        self.torch_optimizer.step()
        self.count += 1


def make_optimizer(name: str, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                   schedule: Schedule, weight_decay: float = 0.05,
                   clip_grad: Optional[float] = None,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8) -> ClippedAdamW:
    """Optimizer factory (timm ``create_optimizer``): ``adamw`` is ported;
    the JAX factory's other names raise with their ROADMAP.md item."""
    if name == "adamw":
        return ClippedAdamW(named_params, schedule, weight_decay=weight_decay,
                            clip_grad=clip_grad, betas=betas, eps=eps)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet; see {_NOT_PORTED[name]}")
    raise NotImplementedError(f"optimizer {name}")

"""Optimizers and learning-rate schedules of the ViT, LM and MT recipes.

Counterpart of ``efficient_attention_tpu/training/optim.py``:

* the DeiT recipe (``README.md:104-145``): timm's cosine-with-warmup
  stepped once per epoch (or ``--sched step``'s decay), and AdamW over
  timm's weight-decay groups behind a clip of the global gradient norm,
  the optax chain
  ``clip_by_global_norm`` + ``adamw(schedule, mask)`` written over
  ``torch.optim.AdamW``, whose update is optax's: ``p -= lr * (m_hat /
  (sqrt(v_hat) + eps) + wd * p)`` with ``lr = schedule(updates so far)``;
* the wiki103 LM recipe (``main.sh:75-124``): fairseq's cosine schedule
  with period multiplier and ``lr_shrink``, and fairseq's NAG behind the
  same clip;
* the WMT MT recipe (``main.sh:103-110``): fairseq's ``inverse_sqrt``
  schedule (and ``polynomial_decay``), and fairseq's Adam behind the same
  clip.

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


def step_schedule(base_lr: float, warmup_steps: int, decay_steps: int,
                  decay_rate: float = 0.1,
                  warmup_init_lr: float = 1e-6) -> Schedule:
    """timm ``StepLRScheduler`` (``--sched step``; JAX
    ``training/optim.py:57-75``): linear warmup from ``warmup_init_lr``
    over ``warmup_steps``, then ``base_lr * decay_rate ** floor(step /
    decay_steps)``."""

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return warmup_init_lr + (base_lr - warmup_init_lr) * (
                step / max(warmup_steps, 1))
        return base_lr * decay_rate ** math.floor(step / max(decay_steps, 1))

    return schedule


def cosine_tmult_schedule(base_lr: float, warmup_steps: int, period: int,
                          t_mult: float = 2.0, min_lr: float = 1e-9,
                          warmup_init_lr: float = 1e-7, lr_shrink: float = 1.0,
                          max_steps: int = 1_000_000) -> Schedule:
    """fairseq ``cosine`` scheduler with period multiplier (LM recipe:
    ``--lr-scheduler cosine --t-mult 2 --lr-period-updates 270000
    --lr-shrink 0.75``): linear warmup, then cosines from ``base_lr`` to
    ``min_lr`` over periods growing by ``t_mult``, both ends shrunk by
    ``lr_shrink**i`` in period ``i``
    (``cosine_lr_scheduler.py:137-140``)."""
    boundaries = []
    start, length = 0, period
    while start < max_steps:
        boundaries.append((start, length))
        start += length
        length = int(length * t_mult)

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return warmup_init_lr + (base_lr - warmup_init_lr) * (
                step / max(warmup_steps, 1))
        t = max(step - warmup_steps, 0.0)
        idx = min(max(sum(t >= s for s, _ in boundaries) - 1, 0),
                  len(boundaries) - 1)
        s, n = boundaries[idx]
        lo, hi = min_lr * lr_shrink ** idx, base_lr * lr_shrink ** idx
        return lo + 0.5 * (hi - lo) * (1 + math.cos(math.pi * (t - s) / n))

    return schedule


def inverse_sqrt_schedule(base_lr: float, warmup_steps: int,
                          warmup_init_lr: float = 1e-7) -> Schedule:
    """fairseq ``inverse_sqrt`` (MT recipe: lr 7e-4, warmup 6000): linear
    warmup from ``warmup_init_lr``, then ``base_lr * sqrt(warmup / step)``."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return warmup_init_lr + (base_lr - warmup_init_lr) * (
                step / max(warmup_steps, 1))
        return base_lr * math.sqrt(warmup_steps / max(step, 1))

    return schedule


def polynomial_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                        power: float = 1.0, end_lr: float = 0.0) -> Schedule:
    """fairseq ``polynomial_decay``: linear warmup from 0, then
    ``(base_lr - end_lr) * frac**power + end_lr`` with ``frac`` the share of
    the post-warmup steps still to go."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        frac = min(max((total_steps - step) / max(total_steps - warmup_steps, 1),
                       0.0), 1.0)
        return (base_lr - end_lr) * frac ** power + end_lr

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
        clip_by_global_norm([p.grad for p in self.params if p.grad is not None],
                            self.clip_grad)
        lr = self.schedule(self.count)
        for group in self.torch_optimizer.param_groups:
            group["lr"] = lr
        self.torch_optimizer.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count,
                "adamw": self.torch_optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.torch_optimizer.load_state_dict(state["adamw"])


def clip_by_global_norm(grads, clip: Optional[float]) -> None:
    """optax ``clip_by_global_norm`` in place: scale by ``clip / norm`` only
    where ``norm >= clip`` (``clip_grad_norm_`` would divide by
    ``norm + 1e-6``)."""
    if clip is None or clip <= 0:
        return
    norm = global_norm(grads)
    factor = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))


class ClippedNAG:
    """optax ``chain(clip_by_global_norm(clip_grad), fairseq NAG)`` over named
    parameters whose ``.grad`` holds the step's gradient.

    fairseq's NAG (``fairseq/optim/nag.py:72-109``, JAX ``_fairseq_nag``) is
    not ``torch.optim.SGD(nesterov=True)``: its momentum buffer is kept in
    parameter units (``buf <- m lr_correct buf - lr g``) and rescaled by
    ``lr_correct = lr / lr_old`` when the schedule moves, the update is
    ``m^2 lr_correct buf - (1 + m) lr g`` with the old buffer, and weight
    decay is decoupled (``- lr wd p``, outside the buffer)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 schedule: Schedule, momentum: float = 0.99,
                 weight_decay: float = 0.0, clip_grad: Optional[float] = None):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        decay = weight_decay_mask(named)
        self.params = [p for _, p in named]
        self.decayed = [p for n, p in named if decay[n]]
        self.bufs = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.schedule = schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.clip_grad = clip_grad
        self.count = 0      # updates applied so far
        self.lr_old = None  # the first update takes lr_correct = 1

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """Clip the gradients, then apply this update's NAG step."""
        params = [p for p in self.params if p.grad is not None]
        bufs = [b for p, b in zip(self.params, self.bufs) if p.grad is not None]
        grads = [p.grad.float() for p in params]
        clip_by_global_norm(grads, self.clip_grad)
        lr = self.schedule(self.count)
        m = self.momentum
        lr_correct = (1.0 if self.lr_old is None
                      else lr / self.lr_old if self.lr_old > 0 else lr)
        delta = torch._foreach_mul(bufs, m * m * lr_correct)
        torch._foreach_add_(delta, grads, alpha=-(1 + m) * lr)
        if self.weight_decay:
            decayed = {id(p) for p in self.decayed}
            for p, d in zip(params, delta):
                if id(p) in decayed:
                    d.add_(p.float(), alpha=-lr * self.weight_decay)
        torch._foreach_mul_(bufs, m * lr_correct)
        torch._foreach_add_(bufs, grads, alpha=-lr)
        torch._foreach_add_(params, [d.to(p.dtype) for p, d in zip(params, delta)])
        self.lr_old = lr
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "lr_old": self.lr_old, "bufs": self.bufs}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.lr_old = state["lr_old"]
        _copy_into(self.bufs, state["bufs"])


class ClippedAdam:
    """optax ``chain(clip_by_global_norm(clip_grad), fairseq Adam)`` over
    named parameters whose ``.grad`` holds the step's gradient.

    fairseq's Adam (``fairseq/optim/adam.py:159-241``, JAX
    ``_fairseq_adam``) is not ``torch.optim.Adam``: eps is added to
    ``sqrt(v)`` of the uncorrected second moment, and the whole step is
    then scaled by ``lr * sqrt(1 - b2^t) / (1 - b1^t)``, with ``lr`` the
    schedule at the updates applied so far; weight decay is decoupled
    (``- lr wd p``) and masked."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 schedule: Schedule, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 clip_grad: Optional[float] = None):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        decay = weight_decay_mask(named)
        self.params = [p for _, p in named]
        self.decayed = [p for n, p in named if decay[n]]
        self.exp_avg = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p, dtype=torch.float32)
                           for p in self.params]
        self.schedule = schedule
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.clip_grad = clip_grad
        self.count = 0  # updates applied so far

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """Clip the gradients, then apply this update's Adam step."""
        live = [i for i, p in enumerate(self.params) if p.grad is not None]
        params = [self.params[i] for i in live]
        m = [self.exp_avg[i] for i in live]
        v = [self.exp_avg_sq[i] for i in live]
        grads = [p.grad.float() for p in params]
        clip_by_global_norm(grads, self.clip_grad)
        b1, b2 = self.betas
        lr = self.schedule(self.count)
        t = self.count + 1
        step_size = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.eps)
        delta = torch._foreach_div(m, denom)
        torch._foreach_mul_(delta, -step_size)
        if self.weight_decay:
            decayed = {id(p) for p in self.decayed}
            for p, d in zip(params, delta):
                if id(p) in decayed:
                    d.add_(p.float(), alpha=-lr * self.weight_decay)
        torch._foreach_add_(params, [d.to(p.dtype) for p, d in zip(params, delta)])
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "exp_avg": self.exp_avg,
                "exp_avg_sq": self.exp_avg_sq}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        _copy_into(self.exp_avg, state["exp_avg"])
        _copy_into(self.exp_avg_sq, state["exp_avg_sq"])


def _copy_into(dst, src) -> None:
    """Copy a saved list of tensors into the optimizer's own, in place."""
    if len(dst) != len(src):
        raise ValueError(f"optimizer state holds {len(src)} tensors, "
                         f"the optimizer {len(dst)}")
    for d, s in zip(dst, src):
        if d.shape != s.shape:
            raise ValueError(f"optimizer state of shape {tuple(s.shape)} for "
                             f"a parameter of shape {tuple(d.shape)}")
        d.copy_(s)


def make_optimizer(name: str, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                   schedule: Schedule, weight_decay: float = 0.05,
                   clip_grad: Optional[float] = None,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8, momentum: float = 0.99):
    """Optimizer factory (timm ``create_optimizer``, fairseq's registry):
    ``adamw``, ``adam`` (fairseq's) and ``nag`` are ported; the JAX
    factory's other names raise with their ROADMAP.md item."""
    if name == "adam":
        return ClippedAdam(named_params, schedule, betas=betas, eps=eps,
                           weight_decay=weight_decay, clip_grad=clip_grad)
    if name == "adamw":
        return ClippedAdamW(named_params, schedule, weight_decay=weight_decay,
                            clip_grad=clip_grad, betas=betas, eps=eps)
    if name == "nag":
        return ClippedNAG(named_params, schedule, momentum=momentum,
                          weight_decay=weight_decay, clip_grad=clip_grad)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet; see {_NOT_PORTED[name]}")
    raise NotImplementedError(f"optimizer {name}")

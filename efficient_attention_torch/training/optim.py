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

* the rest of the JAX factory (``training/optim.py:361-401``): ``sgd``
  (momentum, no weight decay), ``adafactor``, ``adagrad``, ``adadelta``,
  ``adamax`` and ``lamb`` (weight decay under the mask), each behind the
  same clip, with optax's update rules and defaults (``ClippedOptimizer``),
  not ``torch.optim``'s.

Every optimizer keeps float32 state, takes ``zero_grad()`` and ``step()``
and has ``state_dict`` / ``load_state_dict``, from which a checkpoint
resumes bit for bit.

Under FSDP or tensor parallelism (``parallel.shard_model``) parameters and
gradients are DTensors and each rank holds a piece of each.  The
elementwise rules run on the local pieces; what needs a whole tensor is
summed over the process groups that split it, and a tensor replicated
there counts once: the global gradient norm of the clip, lamb's trust
ratio, and adafactor's factored moments and root mean squares, whose
factored moments every rank then holds whole.  So every optimizer takes
the same step sharded as unsharded.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from efficient_attention_torch.parallel.mesh import is_dtensor, to_local

Schedule = Callable[[int], float]


def split_groups(t: torch.Tensor) -> tuple:
    """The process groups over which ``t`` is split, one for each mesh
    dimension that shards the DTensor ``t``; () for a plain tensor or a
    replicated one."""
    if not is_dtensor(t):
        return ()
    if any(p.is_partial() for p in t.placements):
        raise ValueError(f"a partial DTensor ({t.placements}) has no norm yet")
    # a strided shard (FSDP over a tensor-parallel shard) splits too
    return tuple(t.device_mesh.get_group(i) for i, p in enumerate(t.placements)
                 if not (p.is_replicate() or p.is_partial()))


def _sum_over_groups(values: torch.Tensor, groups: List[tuple]) -> torch.Tensor:
    """``values[i]`` summed over the process groups ``groups[i]``, in
    place; one all-reduce a distinct set of groups."""
    by_groups: Dict[tuple, List[int]] = {}
    for i, g in enumerate(groups):
        if g:
            by_groups.setdefault(g, []).append(i)
    for gs, idx in by_groups.items():
        at = torch.tensor(idx, device=values.device)
        part = values[at]
        for g in gs:
            dist.all_reduce(part, group=g)
        values[at] = part
    return values


def sharded_norms(tensors: List[torch.Tensor], groups: List[tuple]) -> torch.Tensor:
    """The norm of each whole tensor of which ``tensors`` holds the local
    pieces, split over ``groups`` (``torch._foreach_norm`` where none is
    split)."""
    if not any(groups):
        return torch.stack(torch._foreach_norm(tensors))
    sq = torch.stack([t.float().square().sum() for t in tensors])
    return torch.sqrt(_sum_over_groups(sq, groups))

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
    ``global_norm``), of the whole tensors where some are DTensors: each
    local sum of squares summed over the groups that split its tensor."""
    tensors = list(tensors)
    groups = [split_groups(t) for t in tensors]
    if not any(groups):
        return torch.sqrt(sum(t.float().square().sum() for t in tensors))
    sq = torch.stack([to_local(t).float().square().sum() for t in tensors])
    return torch.sqrt(_sum_over_groups(sq, groups).sum())


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
        self.names = [n for n, _ in named]
        self.schedule = schedule
        self.clip_grad = clip_grad
        self.count = 0  # updates applied so far (optax's schedule count)
        groups = [
            {"params": [p for n, p in named if decay[n]],
             "weight_decay": weight_decay},
            {"params": [p for n, p in named if not decay[n]],
             "weight_decay": 0.0},
        ]
        # tensor parallelism leaves some parameters plain beside DTensors,
        # which torch's foreach kernels cannot take in one list
        kinds = {is_dtensor(p) for p in self.params}
        self.torch_optimizer = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=schedule(0), betas=betas,
            eps=eps, foreach=False if len(kinds) > 1 else None)

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

    def _indexed(self) -> List[Tuple[str, torch.Tensor]]:
        """(name, parameter) in the index order of the AdamW state."""
        names = {id(p): n for n, p in zip(self.names, self.params)}
        return [(names[id(p)], p) for g in self.torch_optimizer.param_groups
                for p in g["params"]]

    def state_dict(self, full=None) -> dict:
        """The state; with ``full(name, tensor)`` (``ShardedModel.full``)
        the moments of sharded parameters whole."""
        inner = self.torch_optimizer.state_dict()
        if full is not None:
            named = self._indexed()
            inner["state"] = {
                i: {k: (full(named[i][0], v) if k in _ADAMW_MOMENTS else v)
                    for k, v in s.items()}
                for i, s in inner["state"].items()}
        return {"count": self.count, "adamw": inner}

    def load_state_dict(self, state: dict, local=None) -> None:
        """Restore :meth:`state_dict`'s output; with ``local(name, full,
        like)`` (``ShardedModel.local``) whole moments are split as their
        parameters are."""
        self.count = int(state["count"])
        inner = state["adamw"]
        if local is not None:
            named = self._indexed()
            inner = dict(inner, state={
                i: {k: (local(named[int(i)][0], v, named[int(i)][1])
                        if k in _ADAMW_MOMENTS else v) for k, v in s.items()}
                for i, s in inner["state"].items()})
        self.torch_optimizer.load_state_dict(inner)


_ADAMW_MOMENTS = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")


def clip_by_global_norm(grads, clip: Optional[float]) -> None:
    """optax ``clip_by_global_norm`` in place: scale by ``clip / norm`` only
    where ``norm >= clip`` (``clip_grad_norm_`` would divide by
    ``norm + 1e-6``)."""
    if clip is None or clip <= 0:
        return
    norm = global_norm(grads)
    factor = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
    for g in grads:
        to_local(g).mul_(factor.to(g.dtype))


def _copy_into(dst, src) -> None:
    """Copy a saved list of tensors into the optimizer's own, in place."""
    if len(dst) != len(src):
        raise ValueError(f"optimizer state holds {len(src)} tensors, "
                         f"the optimizer {len(dst)}")
    for d, s in zip(dst, src):
        if d.shape != s.shape:
            raise ValueError(f"optimizer state of shape {tuple(s.shape)} for "
                             f"a parameter of shape {tuple(d.shape)}")
        to_local(d).copy_(to_local(s))


class ClippedOptimizer:
    """optax ``chain(clip_by_global_norm(clip_grad), <rule>)`` over named
    parameters whose ``.grad`` holds the step's gradient: fairseq's NAG and
    Adam, and the rules of optax's aliases that the JAX factory builds with
    their defaults.  The state is a dict of lists of float32 tensors, one a
    parameter (``STATE`` names them), and the count of updates applied, at
    which the schedule is read.  A subclass makes its state in
    ``_init_state`` and returns each live parameter's step in ``_deltas``;
    ``decayed[i]`` says whether the weight-decay mask decays parameter
    ``i``.  A state tensor shaped like a sharded parameter is a DTensor
    split as it is; ``_deltas`` gets the local pieces of parameters,
    gradients and state, and ``groups[i]`` names the process groups that
    split parameter ``i``."""

    STATE: Tuple[str, ...] = ()

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 schedule: Schedule, clip_grad: Optional[float] = None,
                 weight_decay: float = 0.0):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        decay = weight_decay_mask(named)
        self.params = [p for _, p in named]
        self.names = [n for n, _ in named]
        self.groups = [split_groups(p) for p in self.params]
        self.decayed = [decay[n] for n, _ in named]
        self.schedule = schedule
        self.clip_grad = clip_grad
        self.weight_decay = weight_decay
        self.count = 0  # updates applied so far
        self.state: Dict[str, List[torch.Tensor]] = {
            k: [self._init_state(k, p) for p in self.params] for k in self.STATE}

    def _init_state(self, key: str, p: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(p, dtype=torch.float32)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """Clip the gradients, then apply this update's step."""
        live = [i for i, p in enumerate(self.params) if p.grad is not None]
        grads = [self.params[i].grad.float() for i in live]
        clip_by_global_norm(grads, self.clip_grad)
        params = [to_local(self.params[i]) for i in live]
        grads = [to_local(g) for g in grads]
        state = {k: [to_local(v[i]) for i in live] for k, v in self.state.items()}
        deltas = self._deltas(live, params, grads, state,
                              self.schedule(self.count))
        torch._foreach_add_(params, [d.to(p.dtype) for p, d in zip(params, deltas)])
        self.count += 1

    def _deltas(self, live, params, grads, state, lr) -> List[torch.Tensor]:
        raise NotImplementedError

    def _norms(self, live, tensors) -> torch.Tensor:
        """Each whole tensor's norm, from the local pieces ``tensors`` of
        the live parameters' (or tensors split as they are)."""
        return sharded_norms(tensors, [self.groups[i] for i in live])

    def state_dict(self, full=None) -> dict:
        """The state; with ``full(name, tensor)`` (``ShardedModel.full``)
        its sharded tensors whole."""
        if full is None:
            return {"count": self.count, **self.state}
        return {"count": self.count,
                **{k: [full(n, t) for n, t in zip(self.names, v)]
                   for k, v in self.state.items()}}

    @torch.no_grad()
    def load_state_dict(self, state: dict, local=None) -> None:
        """Restore :meth:`state_dict`'s output; with ``local(name, full,
        like)`` (``ShardedModel.local``) whole tensors are split as the
        state's own are."""
        self.count = int(state["count"])
        for k in self.STATE:
            saved = state[k]
            if local is not None:
                saved = [local(n, s, d) for n, s, d in
                         zip(self.names, saved, self.state[k])]
            _copy_into(self.state[k], saved)


class ClippedNAG(ClippedOptimizer):
    """optax ``chain(clip_by_global_norm(clip_grad), fairseq NAG)``.

    fairseq's NAG (``fairseq/optim/nag.py:72-109``, JAX ``_fairseq_nag``) is
    not ``torch.optim.SGD(nesterov=True)``: its momentum buffer is kept in
    parameter units (``buf <- m lr_correct buf - lr g``) and rescaled by
    ``lr_correct = lr / lr_old`` when the schedule moves, the update is
    ``m^2 lr_correct buf - (1 + m) lr g`` with the old buffer, and weight
    decay is decoupled (``- lr wd p``, outside the buffer)."""

    STATE = ("bufs",)

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 schedule: Schedule, momentum: float = 0.99,
                 weight_decay: float = 0.0, clip_grad: Optional[float] = None):
        super().__init__(named_params, schedule, clip_grad, weight_decay)
        self.momentum = momentum
        self.lr_old = None  # the first update takes lr_correct = 1

    def _deltas(self, live, params, grads, state, lr):
        bufs = state["bufs"]
        m = self.momentum
        lr_correct = (1.0 if self.lr_old is None
                      else lr / self.lr_old if self.lr_old > 0 else lr)
        delta = torch._foreach_mul(bufs, m * m * lr_correct)
        torch._foreach_add_(delta, grads, alpha=-(1 + m) * lr)
        if self.weight_decay:
            for i, p, d in zip(live, params, delta):
                if self.decayed[i]:
                    d.add_(p.float(), alpha=-lr * self.weight_decay)
        torch._foreach_mul_(bufs, m * lr_correct)
        torch._foreach_add_(bufs, grads, alpha=-lr)
        self.lr_old = lr
        return delta

    def state_dict(self, full=None) -> dict:
        return dict(super().state_dict(full), lr_old=self.lr_old)

    def load_state_dict(self, state: dict, local=None) -> None:
        super().load_state_dict(state, local)
        self.lr_old = state["lr_old"]


class ClippedAdam(ClippedOptimizer):
    """optax ``chain(clip_by_global_norm(clip_grad), fairseq Adam)``.

    fairseq's Adam (``fairseq/optim/adam.py:159-241``, JAX
    ``_fairseq_adam``) is not ``torch.optim.Adam``: eps is added to
    ``sqrt(v)`` of the uncorrected second moment, and the whole step is
    then scaled by ``lr * sqrt(1 - b2^t) / (1 - b1^t)``, with ``lr`` the
    schedule at the updates applied so far; weight decay is decoupled
    (``- lr wd p``) and masked."""

    STATE = ("exp_avg", "exp_avg_sq")

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 schedule: Schedule, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 clip_grad: Optional[float] = None):
        super().__init__(named_params, schedule, clip_grad, weight_decay)
        self.betas = betas
        self.eps = eps

    def _deltas(self, live, params, grads, state, lr):
        m, v = state["exp_avg"], state["exp_avg_sq"]
        b1, b2 = self.betas
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
            for i, p, d in zip(live, params, delta):
                if self.decayed[i]:
                    d.add_(p.float(), alpha=-lr * self.weight_decay)
        return delta


class ClippedSGD(ClippedOptimizer):
    """``optax.sgd(schedule, momentum)``: ``trace <- g + m trace``, the
    step ``-lr trace``; no weight decay."""

    STATE = ("trace",)

    def __init__(self, named_params, schedule, momentum: float = 0.99,
                 clip_grad: Optional[float] = None):
        super().__init__(named_params, schedule, clip_grad)
        self.momentum = momentum

    def _deltas(self, live, params, grads, state, lr):
        trace = state["trace"]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        return torch._foreach_mul(trace, -lr)


# optax's defaults for the aliases that the JAX factory builds without
# arguments beyond the schedule (and lamb's weight decay, adamax's betas).
ADAGRAD_INITIAL_ACCUMULATOR = 0.1
ADAGRAD_EPS = 1e-7
ADADELTA_RHO = 0.9
ADADELTA_EPS = 1e-6
ADAMAX_EPS = 1e-8
LAMB_BETAS = (0.9, 0.999)
LAMB_EPS = 1e-6
ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR = 128
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIPPING_THRESHOLD = 1.0
ADAFACTOR_MIN_SCALE = 1e-3


class ClippedAdagrad(ClippedOptimizer):
    """``optax.adagrad(schedule)``: the sum of squared gradients starts at
    0.1, the step is ``-lr g / sqrt(sum + eps)``, eps 1e-7 inside the root.
    (optax's step is 0 where the sum is 0, which a sum that starts at 0.1
    never is.)"""

    STATE = ("sum_of_squares",)

    def _init_state(self, key, p):
        return torch.full_like(p, ADAGRAD_INITIAL_ACCUMULATOR,
                               dtype=torch.float32)

    def _deltas(self, live, params, grads, state, lr):
        ssq = state["sum_of_squares"]
        torch._foreach_addcmul_(ssq, grads, grads)
        inv = torch._foreach_add(ssq, ADAGRAD_EPS)
        torch._foreach_rsqrt_(inv)
        torch._foreach_mul_(inv, grads)
        torch._foreach_mul_(inv, -lr)
        return inv


class ClippedAdadelta(ClippedOptimizer):
    """``optax.adadelta(schedule)``: ``E[g^2] <- rho E[g^2] + (1 - rho)
    g^2``, ``u = sqrt(E[u^2] + eps) / sqrt(E[g^2] + eps) g``, then ``E[u^2]
    <- rho E[u^2] + (1 - rho) u^2``; the step ``-lr u`` (rho 0.9, eps
    1e-6)."""

    STATE = ("e_g", "e_x")

    def _deltas(self, live, params, grads, state, lr):
        rho, eps = ADADELTA_RHO, ADADELTA_EPS
        e_g, e_x = state["e_g"], state["e_x"]
        torch._foreach_mul_(e_g, rho)
        torch._foreach_addcmul_(e_g, grads, grads, value=1 - rho)
        num = torch._foreach_add(e_x, eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, eps)
        torch._foreach_sqrt_(den)
        u = torch._foreach_div(num, den)
        torch._foreach_mul_(u, grads)
        torch._foreach_mul_(e_x, rho)
        torch._foreach_addcmul_(e_x, u, u, value=1 - rho)
        torch._foreach_mul_(u, -lr)
        return u


class ClippedAdamax(ClippedOptimizer):
    """``optax.adamax(schedule, b1, b2)``: ``mu <- b1 mu + (1 - b1) g``, the
    infinity moment ``nu <- max(|g| + eps, b2 nu)``, the step ``-lr mu /
    (1 - b1^t) / nu``; only the first moment is bias-corrected (eps
    1e-8)."""

    STATE = ("mu", "nu")

    def __init__(self, named_params, schedule, clip_grad: Optional[float] = None,
                 betas: Tuple[float, float] = (0.9, 0.999)):
        super().__init__(named_params, schedule, clip_grad)
        self.betas = betas

    def _deltas(self, live, params, grads, state, lr):
        b1, b2 = self.betas
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        g_abs = torch._foreach_abs(grads)
        torch._foreach_add_(g_abs, ADAMAX_EPS)
        torch._foreach_maximum_(nu, g_abs)
        out = torch._foreach_div(mu, nu)
        torch._foreach_mul_(out, -lr / (1 - b1 ** (self.count + 1)))
        return out


class ClippedLamb(ClippedOptimizer):
    """``optax.lamb(schedule, weight_decay, mask)``: Adam's direction
    ``m_hat / (sqrt(v_hat) + eps)`` (b1 0.9, b2 0.999, eps 1e-6), plus ``wd
    p`` where the mask decays, scaled by the trust ratio ``|p| / |u|`` (1
    where either norm is 0); the step ``-lr`` times that."""

    STATE = ("mu", "nu")

    def _deltas(self, live, params, grads, state, lr):
        b1, b2 = LAMB_BETAS
        t = self.count + 1
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        den = torch._foreach_div(nu, 1 - b2 ** t)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, LAMB_EPS)
        u = torch._foreach_div(mu, 1 - b1 ** t)
        torch._foreach_div_(u, den)
        if self.weight_decay:
            decayed = [(d, p.float()) for i, p, d in zip(live, params, u)
                       if self.decayed[i]]
            if decayed:
                torch._foreach_add_([d for d, _ in decayed], [p for _, p in decayed],
                                    alpha=self.weight_decay)
        p_norm = self._norms(live, [p.float() for p in params])
        u_norm = self._norms(live, u)
        ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                            p_norm / u_norm) * -lr
        torch._foreach_mul_(u, list(ratio.unbind()))
        return u


def _factored_dims(shape: Tuple[int, ...]) -> Optional[Tuple[int, int]]:
    """optax's: the axes of the two largest dims (second, first), or None
    below 2 dims or where the second largest is under
    ``ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class ClippedAdafactor(ClippedOptimizer):
    """``optax.adafactor(schedule)`` with its defaults: second moments
    decayed by ``1 - (t+1)^-0.8`` of the squared gradient plus 1e-30,
    factored into row and column means for parameters whose two largest
    dims are at least 128, else kept whole; the scaled update clipped to a
    root mean square of 1.0, times ``lr`` and the parameter's root mean
    square (at least 1e-3, ``multiply_by_parameter_scale``); the step its
    negative.  No momentum, no weight decay.  Only the factored moments'
    row and column means take a loop over the parameters.  The factored
    moments of a sharded parameter are held whole on every rank: its local
    sums are placed at its piece's indices and summed over the groups that
    split it."""

    STATE = ("v_row", "v_col", "v")

    def __init__(self, named_params, schedule, clip_grad: Optional[float] = None):
        super().__init__(named_params, schedule, clip_grad)
        self.shapes = [tuple(p.shape) for p in self.params]
        # per sharded parameter, the global index of its local piece along
        # each dim (made on first use)
        self._index: Dict[int, List[torch.Tensor]] = {}

    def _init_state(self, key, p):
        dims = _factored_dims(tuple(p.shape))
        one = torch.zeros(1, dtype=torch.float32, device=p.device)
        if dims is None:
            return torch.zeros_like(p, dtype=torch.float32) if key == "v" else one
        if key == "v":
            return one
        d1, d0 = dims
        drop = d0 if key == "v_row" else d1
        shape = [s for i, s in enumerate(p.shape) if i != drop]
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def _piece_index(self, i: int) -> List[torch.Tensor]:
        """The global indices, along each dim, of parameter ``i``'s local
        piece (a product of one index set a dim)."""
        if i not in self._index:
            from torch.distributed.tensor import distribute_tensor

            p, shape = self.params[i], self.shapes[i]
            flat = torch.arange(p.numel(), device=p.device).view(shape)
            mine = distribute_tensor(flat, p.device_mesh, p.placements,
                                     src_data_rank=None).to_local()
            coords = torch.unravel_index(mine.reshape(-1), shape)
            local_shape = mine.shape
            self._index[i] = [
                c.view(local_shape).movedim(k, 0).reshape(local_shape[k], -1)[:, 0]
                for k, c in enumerate(coords)]
        return self._index[i]

    def _mean(self, i: int, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The mean over ``dim`` of the whole tensor of which ``x`` is
        parameter ``i``'s local piece, whole."""
        if not self.groups[i]:
            return x.mean(dim=dim)
        index = self._piece_index(i)
        kept = [k for k in range(x.dim()) if k != dim]
        whole = x.new_zeros([self.shapes[i][k] for k in kept])
        at = tuple(index[k].view([-1 if a == j else 1 for j in range(len(kept))])
                   for a, k in enumerate(kept))
        whole[at] = x.sum(dim=dim)
        for g in self.groups[i]:
            dist.all_reduce(whole, group=g)
        return whole / self.shapes[i][dim]

    def _piece(self, i: int, whole: torch.Tensor, dropped: int) -> torch.Tensor:
        """Parameter ``i``'s local piece of ``whole``, a tensor over all its
        dims but ``dropped``."""
        if not self.groups[i]:
            return whole
        index = self._piece_index(i)
        kept = [k for k in range(len(self.shapes[i])) if k != dropped]
        for a, k in enumerate(kept):
            whole = whole.index_select(a, index[k])
        return whole

    def _deltas(self, live, params, grads, state, lr):
        # optax's decay, in float32
        rate = float(np.float32(1.0) - np.float32(self.count + 1)
                     ** np.float32(-ADAFACTOR_DECAY_RATE))
        grad_sqr = torch._foreach_mul(grads, grads)
        torch._foreach_add_(grad_sqr, ADAFACTOR_EPS)
        dims = [_factored_dims(self.shapes[i]) for i in live]
        whole = [j for j, d in enumerate(dims) if d is None]
        split = [j for j, d in enumerate(dims) if d is not None]
        out = [None] * len(params)
        if whole:
            v = [state["v"][j] for j in whole]
            torch._foreach_mul_(v, rate)
            torch._foreach_add_(v, [grad_sqr[j] for j in whole], alpha=1 - rate)
            u = torch._foreach_pow(v, -0.5)
            torch._foreach_mul_(u, [grads[j] for j in whole])
            for j, uj in zip(whole, u):
                out[j] = uj
        if split:
            v_row = [state["v_row"][j] for j in split]
            v_col = [state["v_col"][j] for j in split]
            torch._foreach_mul_(v_row, rate)
            torch._foreach_add_(v_row, [self._mean(live[j], grad_sqr[j],
                                                   dims[j][1])
                                        for j in split], alpha=1 - rate)
            torch._foreach_mul_(v_col, rate)
            torch._foreach_add_(v_col, [self._mean(live[j], grad_sqr[j],
                                                   dims[j][0])
                                        for j in split], alpha=1 - rate)
            col_factor = torch._foreach_pow(v_col, -0.5)
            for j, row, col in zip(split, v_row, col_factor):
                d1, d0 = dims[j]
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (row / row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                row_factor = self._piece(live[j], row_factor, d0)
                col = self._piece(live[j], col, d1)
                out[j] = grads[j] * row_factor.unsqueeze(d0) * col.unsqueeze(d1)
        # The update's root mean square clipped to the threshold, then the
        # step scaled by lr and the parameter's root mean square.
        numel = torch.tensor([float(math.prod(self.shapes[i])) for i in live],
                             device=params[0].device).sqrt()
        u_rms = self._norms(live, out) / numel
        p_rms = self._norms(live, [p.float() for p in params]) / numel
        denom = torch.clamp(u_rms / ADAFACTOR_CLIPPING_THRESHOLD, min=1.0)
        scale = torch.where(p_rms <= ADAFACTOR_MIN_SCALE,
                            torch.full_like(p_rms, ADAFACTOR_MIN_SCALE), p_rms)
        torch._foreach_mul_(out, list((scale * -lr / denom).unbind()))
        return out


def make_optimizer(name: str, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                   schedule: Schedule, weight_decay: float = 0.05,
                   clip_grad: Optional[float] = None,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8, momentum: float = 0.99):
    """Optimizer factory (timm ``create_optimizer``, fairseq's registry),
    every name of the JAX factory (``training/optim.py:348-401``):
    ``adamw``, ``adam`` (fairseq's), ``nag`` (fairseq's), and optax's
    ``sgd``, ``adafactor``, ``adagrad``, ``adadelta``, ``adamax`` and
    ``lamb`` with the arguments the JAX factory hands each."""
    if name == "adam":
        return ClippedAdam(named_params, schedule, betas=betas, eps=eps,
                           weight_decay=weight_decay, clip_grad=clip_grad)
    if name == "adamw":
        return ClippedAdamW(named_params, schedule, weight_decay=weight_decay,
                            clip_grad=clip_grad, betas=betas, eps=eps)
    if name == "nag":
        return ClippedNAG(named_params, schedule, momentum=momentum,
                          weight_decay=weight_decay, clip_grad=clip_grad)
    if name == "sgd":
        return ClippedSGD(named_params, schedule, momentum=momentum,
                          clip_grad=clip_grad)
    if name == "adafactor":
        return ClippedAdafactor(named_params, schedule, clip_grad=clip_grad)
    if name == "adagrad":
        return ClippedAdagrad(named_params, schedule, clip_grad=clip_grad)
    if name == "adadelta":
        return ClippedAdadelta(named_params, schedule, clip_grad=clip_grad)
    if name == "adamax":
        return ClippedAdamax(named_params, schedule, clip_grad=clip_grad,
                             betas=betas)
    if name == "lamb":
        return ClippedLamb(named_params, schedule, weight_decay=weight_decay,
                           clip_grad=clip_grad)
    raise NotImplementedError(f"optimizer {name}")

"""Train state and the ViT train and eval steps.

Counterpart of ``efficient_attention_tpu/training/train_state.py`` (reference
``vit/engine.py``): one ``TrainState`` (model with float32 master
parameters, optimizer, update count, optional EMA), a train step that runs
random erasing, then mixup, then the loss and its gradients, their global
norm and the update, with gradient accumulation as a Python loop over
microbatches, and the eval step.  The random draws of a step (erasing,
mixup, stochastic depth, dropout, EVA's RF noise) all come from the
``torch.Generator`` the caller hands it.

Mixed precision (``--bf16``) is the JAX package's scheme, not
``torch.autocast``: the forward runs on a bfloat16 copy of the float32
master parameters (``cast_modules``), and the cast's backward returns
float32 gradients to the masters.  Under FSDP the same scheme is FSDP's
``MixedPrecisionPolicy`` (``parallel.shard_model``), and ``cast_modules``
leaves its parameters alone.

A state made with a ``parallel.ShardedModel`` trains the sharded model: all
microbatches but the last accumulate without a gradient sync, the
gradients the heads share under tensor parallelism are summed over the
model axis, the loss is the mean over the batch axes, and the EMA lives on
the parameters' shards; its ``state_dict`` is the whole state in the
unsharded layout, which every rank loads back.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from efficient_attention_torch.data.mixup import (
    MixupConfig,
    apply_mixup,
    one_hot_smooth,
    soft_target_cross_entropy,
)
from efficient_attention_torch.models.layers import set_generator
from efficient_attention_torch.parallel.mesh import to_local
from efficient_attention_torch.training.optim import global_norm


class TrainState:
    """The model (float32 master parameters), its optimizer, the number of
    updates applied, and an EMA of the parameters when ``ema_decay > 0``.
    With ``sharding`` (``parallel.shard_model``'s result) ``model`` is the
    sharded model to train, and ``module`` the one with the parameters'
    own names."""

    def __init__(self, model: torch.nn.Module, optimizer,
                 ema_decay: float = 0.0, sharding=None):
        self.model = model
        self.sharding = sharding
        self.module = model if sharding is None else sharding.module
        self.optimizer = optimizer
        self.step = 0
        self.ema_decay = ema_decay
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None
        if ema_decay:
            self.ema_params = {n: p.detach().clone()
                               for n, p in self.module.named_parameters()}

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """Apply the gradients held in the parameters' ``.grad`` and move
        the EMA: ``e = e * d + p * (1 - d)``."""
        self.optimizer.step()
        self.step += 1
        if self.ema_params is not None:
            for n, p in self.module.named_parameters():
                self.ema_params[n].lerp_(p, 1.0 - self.ema_decay)

    @contextlib.contextmanager
    def ema_weights(self):
        """Within the block the parameters hold the EMA (each rank its
        shards), and their own values again after it; without an EMA,
        nothing changes."""
        if self.ema_params is None:
            yield
            return
        params = dict(self.module.named_parameters())
        with torch.no_grad():
            saved = {n: to_local(p).clone() for n, p in params.items()}
            for n, p in params.items():
                to_local(p).copy_(to_local(self.ema_params[n]))
        try:
            yield
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    to_local(p).copy_(saved[n])

    def state_dict(self) -> dict:
        """The update count, the model's state dict (float32 masters), the
        optimizer's state and the EMA (or None): what a checkpoint holds of
        the train state, in the JAX ``TrainState``'s field names.  Sharded,
        each is gathered whole in the unsharded layout (collective: every
        rank calls it)."""
        sharding = self.sharding
        if sharding is None:
            return {"step": self.step, "params": self.model.state_dict(),
                    "opt_state": self.optimizer.state_dict(),
                    "ema_params": self.ema_params}
        ema = (None if self.ema_params is None else
               {n: sharding.full(n, e) for n, e in self.ema_params.items()})
        return {"step": self.step, "params": sharding.state_dict(),
                "opt_state": self.optimizer.state_dict(full=sharding.full),
                "ema_params": ema}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s output in place: parameters are
        copied into the model's own tensors, so tied weights stay tied;
        sharded, each rank keeps its part of the whole state."""
        sharding = self.sharding
        if sharding is None:
            self.model.load_state_dict(state["params"], strict=True)
            self.optimizer.load_state_dict(state["opt_state"])
        else:
            sharding.load_state_dict(state["params"])
            self.optimizer.load_state_dict(state["opt_state"],
                                           local=sharding.local)
        self.step = int(state["step"])
        if self.ema_params is not None:
            saved = state["ema_params"]
            if saved is None:
                raise ValueError("the checkpoint holds no EMA")
            for n, e in self.ema_params.items():
                s = saved[n] if sharding is None else sharding.local(n, saved[n], e)
                to_local(e).copy_(to_local(s))


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    grad_norm: torch.Tensor
    # True where the update was skipped because loss or gradients were
    # non-finite; None when skipping is off
    skipped: Optional[torch.Tensor] = None


def apply_or_skip(state: TrainState, loss: torch.Tensor,
                  grad_norm: torch.Tensor) -> torch.Tensor:
    """Apply the gradients unless loss or grad norm is non-finite; then the
    state stays as it was (no update, step not counted), the bf16 form of
    fairseq's overflow recovery (``trainer.py:911-920``).  Returns whether
    the update was skipped."""
    skipped = ~(torch.isfinite(loss) & torch.isfinite(grad_norm))
    if not bool(skipped):
        state.apply_gradients()
    return skipped


@contextlib.contextmanager
def cast_modules(model: torch.nn.Module, compute_dtype: Optional[torch.dtype]):
    """Within the block, each float32 parameter of ``model`` reads as its
    cast to ``compute_dtype``; the cast is differentiable, so gradients
    reach the float32 masters in float32.  Each module is visited once, so
    a module that ``model`` holds under two names, as the encoder and the
    decoder share one embedding under ``--share-all-embeddings``, gets one
    copy and its parameter back (``torch.func.functional_call`` restores
    such a module's second name last, with the copy, and the module would
    keep the copy).  A model under FSDP is left alone: its
    ``MixedPrecisionPolicy`` makes the bfloat16 copy."""
    if compute_dtype is None or _fsdp_managed(model):
        yield model
        return
    saved = [(mod, name, p) for mod in model.modules()
             for name, p in mod._parameters.items()
             if p is not None and p.dtype == torch.float32]
    try:
        for mod, name, p in saved:
            mod._parameters[name] = p.to(compute_dtype)
        yield model
    finally:
        for mod, name, p in saved:
            mod._parameters[name] = p


def _fsdp_managed(model: torch.nn.Module) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def microbatch_sync(state: TrainState, i: int, n: int):
    """The context of microbatch ``i`` of ``n``: under a sharded model all
    but the last keep their gradients local (DDP's ``no_sync``, FSDP's
    gradient sync off), so an update syncs once."""
    if state.sharding is None or i == n - 1:
        return contextlib.nullcontext()
    return state.sharding.no_sync()


def make_vit_train_step(
    mixup_cfg: Optional[MixupConfig],
    num_classes: int,
    label_smoothing: float = 0.1,
    accum_steps: int = 1,
    erasing_cfg=None,
    skip_nonfinite: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[..., StepMetrics]:
    """The ViT train step (``vit/engine.py:train_one_epoch``'s inner loop):
    ``train_step(state, images, labels, generator) -> StepMetrics``, which
    updates ``state`` in place.  With ``accum_steps > 1`` the batch splits
    into that many microbatches whose gradients are averaged."""

    def loss_fn(model, images, targets):
        if compute_dtype is not None:
            images = images.to(compute_dtype)
        with cast_modules(model, compute_dtype):
            logits = model(images)
        return soft_target_cross_entropy(logits, targets)

    def microbatch_loss(model, images, labels, generator):
        if erasing_cfg is not None and erasing_cfg.prob > 0:
            from efficient_attention_torch.data.erasing import (
                apply_random_erasing,
            )

            images = apply_random_erasing(images, erasing_cfg, generator)
        if mixup_cfg is not None:
            images, targets = apply_mixup(images, labels, mixup_cfg, generator)
        else:
            targets = one_hot_smooth(labels, num_classes, label_smoothing)
        return loss_fn(model, images, targets)

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor,
                   generator: Optional[torch.Generator]) -> StepMetrics:
        model = state.model
        set_generator(model.train(), generator)
        state.optimizer.zero_grad()
        if accum_steps == 1:
            loss = microbatch_loss(model, images, labels, generator)
            loss.backward()
            loss = loss.detach()
        else:
            if images.shape[0] % accum_steps:
                raise ValueError(f"batch {images.shape[0]} does not split "
                                 f"into {accum_steps} microbatches")
            loss = torch.zeros((), device=images.device)
            for i, (im, lb) in enumerate(zip(images.chunk(accum_steps),
                                             labels.chunk(accum_steps))):
                with microbatch_sync(state, i, accum_steps):
                    part = microbatch_loss(model, im, lb, generator)
                    (part / accum_steps).backward()
                loss += part.detach() / accum_steps
        if state.sharding is not None:
            # every data-parallel rank holds as many rows: the global mean
            # is the mean of the ranks' means
            state.sharding.finish_grads()
            loss = state.sharding.all_reduce_dp(loss) / state.sharding.dp_size
        grad_norm = global_norm(p.grad for p in model.parameters()
                                if p.grad is not None)
        if skip_nonfinite:
            return StepMetrics(loss, grad_norm,
                               apply_or_skip(state, loss, grad_norm))
        state.apply_gradients()
        return StepMetrics(loss, grad_norm)

    return train_step


def vit_eval_step(model: Callable[[torch.Tensor], torch.Tensor],
                  images: torch.Tensor,
                  labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Top-1, top-5 and cross-entropy of ``model(images)``, as scalars on
    the model's device (metrics in float32; ``vit/engine.py:76-107``)."""
    sums = vit_eval_sums(model, images, labels,
                         torch.ones_like(labels, dtype=torch.bool))
    return {k: v / labels.shape[0] for k, v in sums.items()}


@torch.no_grad()
def vit_eval_sums(model: Callable[[torch.Tensor], torch.Tensor],
                  images: torch.Tensor, labels: torch.Tensor,
                  real: torch.Tensor) -> Dict[str, torch.Tensor]:
    """:func:`vit_eval_step`'s metrics as sums over the rows where ``real``
    holds (a sharded eval masks the rows that pad its shard)."""
    logits = model(images).float()
    w = real.float()
    top1 = (logits.argmax(-1) == labels).float()
    top5_pred = logits.topk(min(5, logits.shape[-1]), dim=-1).indices
    top5 = (top5_pred == labels[:, None]).any(-1).float()
    loss = F.cross_entropy(logits, labels, reduction="none")
    return {"acc1": (top1 * w).sum(), "acc5": (top5 * w).sum(),
            "loss": (loss * w).sum()}

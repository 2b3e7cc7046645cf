"""LM and MT train and eval steps.

Counterpart of ``efficient_attention_tpu/training/lm_steps.py`` (the
fairseq Trainer's forward/backward/step, ``trainer.py:716-1022``): the LM
loss is the token-mean NLL (adaptive softmax or full cross entropy) over
non-pad targets, the MT loss fairseq's label-smoothed cross entropy over
tokens or, with ``sentence_avg``, over sentences; ``--update-freq``
accumulation is a Python loop over microbatches whose losses (each
normalised by its own count) and gradients are averaged;
the update is skipped where loss or gradient norm is non-finite
(``apply_or_skip``); the LM eval steps return the NLL sums or the
per-token NLL of ``eval_lm`` (``--softmax-batch`` bounding the live
logits).  ``--bf16`` is the port's master-copy scheme
(``train_state.cast_modules``): the forward runs on a bfloat16 copy of the
float32 parameters.

Data-parallel (a state with a ``parallel.ShardedModel``), each rank holds
its rows of every microbatch (``parallel.local_rows``), and a microbatch's
loss is the global one: its sum over every rank divided by its global
token (or sentence) count, which is all-reduced before the backward, as
JAX divides on the global batch; DDP's mean is undone by the data-parallel
size.  Ranks with unequal token counts then give the single-process
gradient, loss and gradient norm.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from efficient_attention_torch.models.layers import set_generator
from efficient_attention_torch.training.criterions import (
    adaptive_loss,
    label_smoothed_nll_loss,
)
from efficient_attention_torch.training.optim import global_norm
from efficient_attention_torch.training.train_state import (
    StepMetrics,
    TrainState,
    apply_or_skip,
    cast_modules,
    microbatch_sync,
)


def _accumulate(state: TrainState, parts, loss_fn, accum_steps: int,
                counts) -> torch.Tensor:
    """Run the backward of every microbatch of ``parts`` and return the
    step's loss: each microbatch's loss sum (``loss_fn(*part)``) divided by
    its count (``counts(*part)``, clamped at 1).  Data-parallel, the counts
    are all-reduced up front into the global ones and each rank's quotient
    is scaled by ``dp`` before the backward, so that DDP's mean over the
    ``dp`` ranks is the global quotient; the loss is summed over the
    ranks."""
    sharding = state.sharding
    dp = 1 if sharding is None else sharding.dp_size
    den = torch.stack([counts(*part) for part in parts]).float()
    if sharding is not None:
        den = sharding.all_reduce_dp(den)
    den = den.clamp(min=1.0)
    loss = torch.zeros((), device=parts[0][0].device)
    for i, part in enumerate(parts):
        with microbatch_sync(state, i, len(parts)):
            part_loss = loss_fn(*part) / den[i]
            (part_loss * dp / accum_steps).backward()
        loss += part_loss.detach() / accum_steps
    if sharding is None:
        return loss
    sharding.finish_grads()
    return sharding.all_reduce_dp(loss)


def make_lm_train_step(pad_idx: int = 1, accum_steps: int = 1,
                       use_adaptive: bool = False,
                       compute_dtype: Optional[torch.dtype] = None
                       ) -> Callable[..., StepMetrics]:
    """``train_step(state, tokens, targets, generator) -> StepMetrics``,
    which updates ``state`` in place; the step's random draws (dropout,
    the causal-EVA proposal noise, quant noise) come from ``generator``."""

    def loss_fn(model, tokens, targets):
        with cast_modules(model, compute_dtype):
            out = model(tokens, targets) if use_adaptive else model(tokens)
        if use_adaptive:
            return adaptive_loss(out, targets, pad_idx)[0]
        return label_smoothed_nll_loss(out, targets, epsilon=0.0,
                                       pad_idx=pad_idx)[0]

    def train_step(state: TrainState, tokens: torch.Tensor,
                   targets: torch.Tensor,
                   generator: Optional[torch.Generator]) -> StepMetrics:
        model = state.model
        set_generator(model.train(), generator)
        state.optimizer.zero_grad()
        if tokens.shape[0] % accum_steps:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                             f"--update-freq {accum_steps}")
        loss = _accumulate(
            state, list(zip(tokens.chunk(accum_steps),
                            targets.chunk(accum_steps))),
            lambda tk, tg: loss_fn(model, tk, tg), accum_steps,
            lambda tk, tg: (tg != pad_idx).sum())
        grad_norm = global_norm(p.grad for p in model.parameters()
                                if p.grad is not None)
        return StepMetrics(loss, grad_norm,
                           apply_or_skip(state, loss, grad_norm))

    return train_step


def _token_nll(model, tokens, targets, use_adaptive: bool,
               softmax_chunk: Optional[int] = None) -> torch.Tensor:
    """Per-token NLL ``[B, T]`` (f32).  With ``softmax_chunk`` (and no
    adaptive softmax, which streams the vocabulary already) the output
    layer and log-softmax run over the flattened ``B*T`` features in slices
    of that many tokens, so at most ``[chunk, V]`` logits are live (fairseq
    ``SequenceScorer``'s ``batch_for_softmax``); ``model`` must then be the
    ``TransformerLM`` itself."""
    if use_adaptive:
        return model(tokens, targets)
    if softmax_chunk:
        feats = model(tokens, features_only=True)
        b, t, d = feats.shape
        flat, flat_tgt = feats.reshape(b * t, d), targets.reshape(b * t)
        return torch.cat([
            model.nll_from_features(flat[i:i + softmax_chunk],
                                    flat_tgt[i:i + softmax_chunk])
            for i in range(0, b * t, softmax_chunk)]).reshape(b, t)
    logits = model(tokens).float()
    return -torch.gather(torch.log_softmax(logits, -1), -1,
                         targets[..., None])[..., 0]


def make_lm_eval_step(use_adaptive: bool = False, pad_idx: int = 1,
                      softmax_chunk: Optional[int] = None
                      ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """``eval_step(model, tokens, targets, score_mask) -> (nll sum, tokens
    scored)`` (``fairseq_cli/eval_lm.py`` scoring); ``model`` is any
    callable ``(tokens[, targets])`` with the LM's outputs, in eval mode
    (the ``TransformerLM`` itself with ``softmax_chunk``, which bounds the
    live logits to that many tokens, ``--softmax-batch``)."""

    @torch.no_grad()
    def eval_step(model, tokens, targets, score_mask):
        nll = _token_nll(model, tokens, targets, use_adaptive, softmax_chunk)
        mask = score_mask & (targets != pad_idx)
        return (nll * mask).sum(), mask.sum()

    return eval_step


def make_lm_token_nll_step(use_adaptive: bool = False, pad_idx: int = 1,
                           softmax_chunk: Optional[int] = None
                           ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """``token_step(model, tokens, targets, score_mask) -> (NLL [B, T],
    scored mask [B, T])``: the per-token form behind ``eval_lm
    --output-word-probs/--output-word-stats`` (fairseq
    ``sequence_scorer.py``'s ``pos_scores``)."""

    @torch.no_grad()
    def token_step(model, tokens, targets, score_mask):
        nll = _token_nll(model, tokens, targets, use_adaptive, softmax_chunk)
        return nll, score_mask & (targets != pad_idx)

    return token_step


def make_mt_train_step(pad_idx: int = 1, label_smoothing: float = 0.1,
                       accum_steps: int = 1,
                       compute_dtype: Optional[torch.dtype] = None,
                       sentence_avg: bool = False
                       ) -> Callable[..., StepMetrics]:
    """``train_step(state, src, prev_output_tokens, targets, generator) ->
    StepMetrics`` (``criterions/label_smoothed_cross_entropy.py``, the WMT
    recipe), which updates ``state`` in place; the step's random draws
    (dropout, EVA's RF noise, the causal-EVA proposal noise, layerdrop,
    quant noise) come from ``generator``."""

    def loss_fn(model, src, prev, targets):
        with cast_modules(model, compute_dtype):
            logits = model(src, prev)
        return label_smoothed_nll_loss(
            logits, targets, epsilon=label_smoothing, pad_idx=pad_idx)[0]

    def count(src, prev, targets):
        return (torch.tensor(float(targets.shape[0]), device=targets.device)
                if sentence_avg else (targets != pad_idx).sum())

    def train_step(state: TrainState, src: torch.Tensor, prev: torch.Tensor,
                   targets: torch.Tensor,
                   generator: Optional[torch.Generator]) -> StepMetrics:
        model = state.model
        set_generator(model.train(), generator)
        state.optimizer.zero_grad()
        if src.shape[0] % accum_steps:
            raise ValueError(f"batch {src.shape[0]} not divisible by "
                             f"--update-freq {accum_steps}")
        loss = _accumulate(
            state, list(zip(src.chunk(accum_steps), prev.chunk(accum_steps),
                            targets.chunk(accum_steps))),
            lambda s, p, t: loss_fn(model, s, p, t), accum_steps, count)
        grad_norm = global_norm(p.grad for p in model.parameters()
                                if p.grad is not None)
        return StepMetrics(loss, grad_norm,
                           apply_or_skip(state, loss, grad_norm))

    return train_step


def make_mt_eval_step(pad_idx: int = 1, label_smoothing: float = 0.1
                      ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]]:
    """``eval_step(model, src, prev_output_tokens, targets) -> (smoothed
    loss sum, nll sum, tokens)`` (``fairseq_cli/train.py`` ``validate`` ->
    ``task.valid_step``); ``model`` is any callable ``(src, prev)`` with the
    model's logits, in eval mode."""

    @torch.no_grad()
    def eval_step(model, src, prev, targets):
        return label_smoothed_nll_loss(model(src, prev), targets,
                                       epsilon=label_smoothing, pad_idx=pad_idx)

    return eval_step

"""Checkpoints of the train state, and layer pruning and averaging.

Counterpart of ``efficient_attention_tpu/training/checkpoint.py`` (fairseq
``checkpoint_utils.py``, ``scripts/average_checkpoints.py``) with the
port's own format, since the port reads no orbax: ``<directory>/<step>/``
holds ``state.pt``, written by ``torch.save`` and read by
``torch.load(weights_only=True)``, so a state holds tensors, numbers,
strings, lists, dicts and None only; ``metrics.json`` beside it where
``save`` was given metrics.  A step's directory is written under a
temporary name and renamed when complete, as orbax finalises a step.

The policy is the JAX manager's (orbax's, with synchronous writes):

* ``save(step)`` writes where no step at or after ``step`` is kept and
  either ``step % save_interval_steps == 0`` or nothing is kept yet;
* then, without ``best_fn``, the newest ``keep_last`` steps are kept;
  with ``best_fn``, the ``keep_last`` best by that metric (``best_mode``
  ``'min'`` or ``'max'``, inferred from the metric's name when None) and
  every step saved without metrics.

Parameters are state-dict tensors keyed by the port's names
(``decoder.layers.{i}...``); JAX parameters come across through
``interop.lm_state_dict_from_jax``.

Under a process group (``parallel.init_distributed``) the state handed to
``save`` is the whole one, which every rank has gathered
(``TrainState.state_dict``); rank 0 alone writes it, in the same format,
between two barriers of every rank: each rank decides whether to save on
the steps on disk before rank 0 writes, and sees the new step after.  Every
rank loads a checkpoint and keeps its part.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch

from efficient_attention_torch.parallel.distributed import barrier, is_primary

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


def infer_best_mode(best_fn: str) -> str:
    """Loss-like metric names rank lower-is-better (the JAX manager's
    rule)."""
    lowered = best_fn.lower()
    return ("min" if any(tok in lowered for tok in
                         ("loss", "ppl", "perplexity", "nll", "error", "wer"))
            else "max")


class CheckpointManager:
    """Keeps the checkpoints of one run in ``directory`` (see the module's
    docstring for the policy)."""

    def __init__(self, directory: str, keep_last: int = 3,
                 save_interval_steps: int = 1, best_fn: Optional[str] = None,
                 best_mode: Optional[str] = None):
        self.directory = os.path.abspath(directory)
        if is_primary():
            os.makedirs(self.directory, exist_ok=True)
        self.keep_last = keep_last
        self.save_interval_steps = save_interval_steps
        self.best_fn = best_fn
        self.best_mode = (best_mode or infer_best_mode(best_fn)) if best_fn else None
        self._metrics: Dict[int, Optional[dict]] = {
            step: self._read_metrics(step) for step in self.all_steps()}

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _read_metrics(self, step: int) -> Optional[dict]:
        path = os.path.join(self._step_dir(step), METRICS_FILE)
        if not os.path.exists(path):
            return None
        with open(path, encoding="utf-8") as f:
            return json.load(f)

    def all_steps(self) -> List[int]:
        """The finalised steps on disk, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory)
                      if re.fullmatch(r"\d+", name)
                      and os.path.isdir(os.path.join(self.directory, name)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % self.save_interval_steps == 0 or latest is None

    def save(self, step: int, state: Dict[str, Any],
             metrics: Optional[dict] = None) -> bool:
        """Write ``state`` as step ``step`` if the policy takes the step,
        then drop the steps the policy no longer keeps.  Returns whether it
        wrote (under a process group: whether rank 0 did)."""
        step = int(step)
        if not self.should_save(step):
            return False
        metrics = {k: float(v) for k, v in (metrics or {}).items()} or None
        # every rank reads the steps on disk for the decision above before
        # rank 0 changes them
        barrier()
        if is_primary():
            self._write(step, state, metrics)
        barrier()
        self._metrics[step] = metrics
        return True

    def _write(self, step: int, state: Dict[str, Any],
               metrics: Optional[dict]) -> None:
        tmp = os.path.join(self.directory, f"{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        if metrics is not None:
            with open(os.path.join(tmp, METRICS_FILE), "w", encoding="utf-8") as f:
                json.dump(metrics, f)
        os.replace(tmp, self._step_dir(step))
        self._metrics[step] = metrics
        for old in self._steps_to_remove():
            shutil.rmtree(self._step_dir(old))
            self._metrics.pop(old, None)

    def _steps_to_remove(self) -> List[int]:
        steps = self.all_steps()
        n = self.keep_last
        if n is None or len(steps) <= n:
            return []
        if self.best_fn is None:
            return steps[:len(steps) - n]
        scored = [s for s in steps if self._metrics.get(s) is not None]
        # ascending for 'max', descending for 'min': the best come last
        # (a stable sort, so among ties the newer steps are kept)
        ranked = sorted(scored, key=lambda s: self._metrics[s][self.best_fn],
                        reverse=self.best_mode == "min")
        keep = set(ranked[-n:] if n > 0 else [])
        keep.update(s for s in steps if self._metrics.get(s) is None)
        return [s for s in steps if s not in keep]

    def load(self, step: Optional[int] = None,
             mmap: bool = False) -> Optional[Dict[str, Any]]:
        """The state saved at ``step`` (default the newest), on the CPU, or
        None where no step is kept.  With ``mmap`` the tensors map the file
        and are read where they are used."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                          map_location="cpu", weights_only=True, mmap=mmap)

    def restore(self, target=None, step: Optional[int] = None):
        """Load ``step`` (default the newest) into ``target`` through its
        ``load_state_dict`` and return it; without a target, return the
        saved state.  None where no step is kept."""
        state = self.load(step)
        if state is None or target is None:
            return state
        target.load_state_dict(state)
        return target

    def restore_params(self, step: Optional[int] = None):
        """Only the model parameters, ``(step, state dict)``, or None: the
        inference CLIs know no optimizer (fairseq likewise loads only
        ``state['model']`` at inference); the file is mapped, so the
        optimizer's tensors are never read."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return step, self.load(step, mmap=True)["params"]

    def wait(self) -> None:
        """Writes are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open between calls."""


def _layer_index(key: str, scope: str, prefix: str) -> Optional[int]:
    m = re.match(rf"{re.escape(scope)}\.{re.escape(prefix)}(\d+)\.", key)
    return int(m.group(1)) if m else None


def prune_layer_params(params: Dict[str, torch.Tensor], layers_to_keep,
                       scope: str, prefix: str = "layers.") -> Dict[str, torch.Tensor]:
    """Keep only the listed layers of ``scope`` in a state dict and
    renumber them densely (fairseq ``prune_state_dict``,
    ``checkpoint_utils.py:674``: a model trained with layerdrop is evaluated
    on any subset of its layers, so ``--decoder-layers-to-keep 0,2,4`` loads
    a 3-layer model from a full-depth checkpoint).  ``scope`` is
    ``'decoder'`` or ``'encoder'``."""
    if not any(k.startswith(scope + ".") for k in params):
        raise KeyError(f"scope {scope!r} not in checkpoint")
    keep = sorted(int(i) for i in layers_to_keep)
    present = {_layer_index(k, scope, prefix) for k in params} - {None}
    for i in keep:
        if i not in present:
            raise ValueError(f"layer {i} not in checkpoint ({len(present)} layers)")
    renumber = {old: new for new, old in enumerate(keep)}
    out = {}
    for key, value in params.items():
        i = _layer_index(key, scope, prefix)
        if i is None:
            out[key] = value
        elif i in renumber:
            head = f"{scope}.{prefix}{i}."
            out[f"{scope}.{prefix}{renumber[i]}." + key[len(head):]] = value
    return out


def maybe_prune_for_keep(params: Dict[str, torch.Tensor], layers_to_keep,
                         scope: str, prefix: str = "layers.") -> Dict[str, torch.Tensor]:
    """:func:`prune_layer_params` where the checkpoint is deeper than the
    kept subset (fairseq prunes on every load, warm starts included); a
    checkpoint saved at the pruned depth passes unchanged."""
    if not layers_to_keep:
        return params
    n_ckpt = len({_layer_index(k, scope, prefix) for k in params} - {None})
    if n_ckpt == len(list(layers_to_keep)):
        return params
    return prune_layer_params(params, layers_to_keep, scope, prefix)


def parse_layers_to_keep(spec: Optional[str]):
    """``"0,2,4"`` -> [0, 2, 4]; None or '' -> None (fairseq's
    ``--decoder-layers-to-keep`` format)."""
    if not spec:
        return None
    return [int(x) for x in str(spec).replace(" ", "").split(",") if x != ""]


def average_checkpoints(states: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The uniform average of N state dicts (``scripts/average_checkpoints.py``;
    the MT recipe averages its last 10 checkpoints, ``main.sh:160-164``):
    each tensor summed in float64 in the given order, divided by N and cast
    back to its dtype; other values are taken from the first state."""
    n = len(states)
    if n == 0:
        raise ValueError("no checkpoints to average")
    return {key: ((sum(s[key].double() for s in states) / n).to(first.dtype)
                  if torch.is_tensor(first) else first)
            for key, first in states[0].items()}

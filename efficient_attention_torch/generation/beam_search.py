"""Beam-search sequence generation over a decode-state pytree.

PyTorch counterpart of ``efficient_attention_tpu/generation/beam_search.py``
(fairseq ``sequence_generator.py:191-569``): plain beam search with the
GNMT length penalty (the MT recipe's ``--beam 4 --lenpen 0.6``), per-sentence
``min_len``/``min_len_a``/``max_len_a``/``max_len_b`` bounds
(LengthConstrainedBeamSearch, ``search.py:526-549``) and ``unk_penalty``.
The JAX package's ``lax.while_loop`` is a Python loop over steps on tensors
here; the decode state (softmax KV caches, causal-EVA states, static
cross-attention K/V) is any nest of tuples, lists and named tuples of
tensors, whose ``[B*K, ...]`` tensors are gathered along the beams after
every step.  Every ``lax.top_k``/``argsort`` of the JAX loop is a stable
descending sort here, so ties (the finished set holds many ``NEG_INF``
entries) break by the lower index, as in JAX, and every returned row
matches, not only the 1-best.  Not ported yet, each raising
``NotImplementedError`` with its ROADMAP.md item: diverse beam search,
diverse siblings, prefixes, lexical constraints, n-gram blocking and
sampling.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

NEG_INF = -1e9
_TODO = "is not ported yet; see ROADMAP.md Queue 1, item 6"


class BeamState(NamedTuple):
    tokens: torch.Tensor           # [B, K, L+1] emitted tokens (starts with bos)
    log_probs: torch.Tensor        # [B, K] cumulative alive scores
    finished_tokens: torch.Tensor  # [B, K, L+1]
    finished_scores: torch.Tensor  # [B, K] length-penalised
    finished_mask: torch.Tensor    # [B, K] bool
    cache: Any                     # decode state, batch dim B*K
    step: int


def map_tensors(tree: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """``fn`` applied to every tensor of a nest of tuples, named tuples and
    lists; other leaves (a Python ``pos``) are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(x, fn) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(x, fn) for x in tree)
    return tree


def _gather_beams(tree: Any, indices: torch.Tensor, batch: int, beams: int) -> Any:
    """Reorder every ``[B*K, ...]`` tensor of ``tree`` by per-sentence beam
    indices ``[B, K]`` (JAX ``beam_search.py:41-50``)."""
    flat = (torch.arange(batch, device=indices.device)[:, None] * beams
            + indices).reshape(-1)

    def take(x):
        if x.dim() >= 1 and x.shape[0] == batch * beams:
            return x.index_select(0, flat)
        return x

    return map_tensors(tree, take)


def _length_penalty(length, alpha: float):
    # fairseq/GNMT: ((5 + len) / 6) ** alpha
    return ((5.0 + length) / 6.0) ** alpha


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: ties by the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class SequenceGenerator:
    """Batched beam search over a step function.

    ``step_fn(cache, tokens [B*K, 1], step) -> (logits [B*K, V], cache)``
    and ``init_cache_fn(batch * K, max_len + 1) -> cache``.
    """

    def __init__(self, step_fn: Callable, init_cache_fn: Callable,
                 vocab_size: int, beam_size: int = 4, max_len: int = 256,
                 len_penalty: float = 1.0, pad: int = 1, eos: int = 2,
                 bos: Optional[int] = None, no_repeat_ngram_size: int = 0,
                 unk_penalty: float = 0.0, unk: int = 3,
                 diversity_groups: int = 1, diverse_siblings_gamma: float = 0.0,
                 min_len: int = 1,
                 min_len_a: float = 0.0, max_len_a: float = 0.0,
                 max_len_b: Optional[int] = None):
        for bad, what in ((no_repeat_ngram_size > 0, "n-gram repeat blocking"),
                          (diversity_groups > 1, "diverse beam search"),
                          (diverse_siblings_gamma > 0, "diverse siblings")):
            if bad:
                raise NotImplementedError(f"{what} {_TODO}")
        self.step_fn = step_fn
        self.init_cache_fn = init_cache_fn
        self.vocab_size = vocab_size
        self.beam_size = beam_size
        self.max_len = max_len
        self.len_penalty = len_penalty
        self.pad, self.eos = pad, eos
        self.bos = eos if bos is None else bos
        # subtracted after normalisation, as fairseq does
        self.unk_penalty = unk_penalty
        self.unk = unk
        self.min_len = min_len
        self.min_len_a = min_len_a
        self.max_len_a = max_len_a
        self.max_len_b = max_len_b

    def _init_state(self, batch: int, device) -> BeamState:
        K, L = self.beam_size, self.max_len
        tokens = torch.full((batch, K, L + 1), self.pad, dtype=torch.long, device=device)
        tokens[:, :, 0] = self.bos
        log_probs = torch.full((batch, K), NEG_INF, device=device)
        log_probs[:, 0] = 0.0
        return BeamState(tokens, log_probs, tokens.clone(),
                         torch.full((batch, K), NEG_INF, device=device),
                         torch.zeros((batch, K), dtype=torch.bool, device=device),
                         self.init_cache_fn(batch * K, L + 1), 0)

    def generate(self, batch: int, prefix_tokens=None, constraints=None,
                 src_lengths: Optional[torch.Tensor] = None,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run the beam loop; returns ``(tokens [B, K, L+1], scores [B, K])``
        sorted best-first (JAX ``beam_search.py:251-446``)."""
        if prefix_tokens is not None:
            raise NotImplementedError(f"prefix-constrained decoding {_TODO}")
        if constraints is not None:
            raise NotImplementedError(f"lexically constrained decoding {_TODO}")
        if src_lengths is None and (self.min_len_a or self.max_len_a):
            raise ValueError("min_len_a/max_len_a scale with the source length; "
                             "pass generate(src_lengths=...)")
        K, V = self.beam_size, self.vocab_size
        state = self._init_state(batch, device)
        sl = (torch.zeros(batch, device=device) if src_lengths is None
              else src_lengths.to(device=device, dtype=torch.float32))
        min_lens = self.min_len_a * sl + self.min_len
        cap = float(self.max_len)
        if self.max_len_b is None and self.max_len_a == 0.0:
            max_lens = torch.full((batch,), cap, device=device)
        else:
            mlb = cap if self.max_len_b is None else float(self.max_len_b)
            max_lens = torch.clamp(self.max_len_a * sl + mlb, max=cap)
        alive_lp = _length_penalty(self.max_len, self.len_penalty)
        while state.step < self.max_len:
            best_alive = (state.log_probs / alive_lp).amax(dim=1)
            worst_fin = torch.where(state.finished_mask, state.finished_scores,
                                    NEG_INF).amin(dim=1)
            done = (state.finished_mask.all(dim=1) & (worst_fin >= best_alive)).all()
            if bool(done):
                break
            state = self._step(state, batch, K, V, min_lens, max_lens)
        self.steps = state.step  # decode steps the last call ran
        # fall back to the alive beams where nothing finished
        steps = torch.tensor(max(state.step, 1), dtype=torch.float32, device=device)
        alive_scores = state.log_probs / _length_penalty(steps, self.len_penalty)
        any_fin = state.finished_mask.any(dim=1, keepdim=True)
        scores = torch.where(any_fin, state.finished_scores, alive_scores)
        tokens = torch.where(any_fin[..., None], state.finished_tokens, state.tokens)
        order = torch.sort(-scores, dim=1, stable=True)[1]
        return (torch.gather(tokens, 1, order[..., None].expand_as(tokens)),
                torch.gather(scores, 1, order))

    def _step(self, state: BeamState, batch: int, K: int, V: int,
              min_lens: torch.Tensor, max_lens: torch.Tensor) -> BeamState:
        step = state.step
        cur = state.tokens[:, :, step].reshape(batch * K, 1)
        logits, cache = self.step_fn(state.cache, cur, step)
        logp = torch.log_softmax(logits.float().reshape(batch, K, V), dim=-1)
        if self.unk_penalty:
            logp[:, :, self.unk] -= self.unk_penalty
        # rows at their max output length must emit eos now
        force_eos = float(step) >= max_lens  # [B]
        eos_only = torch.full((V,), NEG_INF, device=logp.device)
        eos_only[self.eos] = 0.0
        logp = torch.where(force_eos[:, None, None], eos_only, logp)
        cand = state.log_probs[..., None] + logp  # [B, K, V]

        # candidates ending in eos become finished hypotheses, banned below
        # each sentence's minimum output length
        step_len = torch.tensor(step + 1, dtype=torch.float32, device=logp.device)
        eos_scores = cand[:, :, self.eos] / _length_penalty(step_len, self.len_penalty)
        eos_scores = torch.where((float(step) >= min_lens)[:, None], eos_scores, NEG_INF)
        fin_scores = torch.cat([torch.where(state.finished_mask,
                                            state.finished_scores, NEG_INF),
                                eos_scores], dim=1)  # [B, 2K]
        eos_tokens = state.tokens.clone()
        eos_tokens[:, :, step + 1] = self.eos
        fin_tokens = torch.cat([state.finished_tokens, eos_tokens], dim=1)
        top_fin, fin_idx = _top_k(fin_scores, K)
        L1 = fin_tokens.shape[2]
        finished_tokens = torch.gather(fin_tokens, 1,
                                       fin_idx[..., None].expand(-1, -1, L1))
        finished_mask = top_fin > NEG_INF / 2

        # alive candidates: eos masked out, top K over beams x vocabulary
        cand[:, :, self.eos] = NEG_INF
        top_scores, top_idx = _top_k(cand.reshape(batch, K * V), K)
        beam_idx, tok_idx = top_idx // V, top_idx % V
        tokens = torch.gather(state.tokens, 1, beam_idx[..., None].expand(-1, -1, L1))
        tokens[:, :, step + 1] = tok_idx
        return BeamState(tokens, top_scores, finished_tokens,
                         torch.where(finished_mask, top_fin, NEG_INF), finished_mask,
                         _gather_beams(cache, beam_idx, batch, K), step + 1)

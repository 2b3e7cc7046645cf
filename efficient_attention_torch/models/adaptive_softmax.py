"""Adaptive softmax and adaptive input embeddings (the wiki103 LM recipe).

PyTorch counterpart of ``efficient_attention_tpu/models/adaptive_softmax.py``
(fairseq ``modules/adaptive_softmax.py`` and ``modules/adaptive_input.py``).
As in the JAX package, every cluster is computed densely over all tokens in
its reduced dimension (``dim / 4^i``) and combined with masks.  Parameter
names follow fairseq's, so reference state dicts load into these modules.

The training NLL streams each cluster's vocabulary in chunks
(``chunked_lse_and_target``): an autograd ``Function`` keeps a running
(max, sum) pair over vocabulary chunks in the forward and recomputes each
chunk's logits in the backward, as the JAX package's ``jax.checkpoint``'d
scan does, so a step never holds the ``[tokens, V]`` logits (at the wiki103
geometry, 9216 tokens by the 207,744 words of the last cluster, 7.7 GB in
f32).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from efficient_attention_torch.ops.promote import Linear

CHUNK = 16384


class _ChunkedLSE(torch.autograd.Function):
    """``(logsumexp(h @ w^T), (h @ w^T)[target])`` over vocabulary chunks of
    ``chunk`` rows of ``w``; h ``[N, D]``, w ``[V, D]``, targets ``[N]``.
    Logits are formed in h's dtype and summed in f32, as the JAX form."""

    @staticmethod
    def forward(ctx, h, w, targets, chunk):
        N, V = h.shape[0], w.shape[0]
        m = torch.full((N,), float("-inf"), device=h.device)
        s = torch.zeros(N, device=h.device)
        tgt = torch.zeros(N, device=h.device)
        rows = torch.arange(N, device=h.device)
        for lo in range(0, V, chunk):
            logits = (h @ w[lo:lo + chunk].to(h.dtype).t()).float()
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            loc = targets - lo
            inside = (loc >= 0) & (loc < logits.shape[1])
            got = logits[rows, loc.clamp(0, logits.shape[1] - 1)]
            tgt = torch.where(inside, got, tgt)
        lse = m + torch.log(s)
        ctx.save_for_backward(h, w, targets, lse)
        ctx.chunk = chunk
        return lse, tgt

    @staticmethod
    def backward(ctx, g_lse, g_tgt):
        h, w, targets, lse = ctx.saved_tensors
        chunk = ctx.chunk
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        for lo in range(0, w.shape[0], chunk):
            wc = w[lo:lo + chunk].to(h.dtype)
            logits = (h @ wc.t()).float()
            dl = g_lse[:, None] * torch.exp(logits - lse[:, None])
            loc = targets - lo
            inside = (loc >= 0) & (loc < logits.shape[1])
            # one column a row: a scatter, with no host sync on the mask
            dl.scatter_add_(1, loc.clamp(0, logits.shape[1] - 1)[:, None],
                            torch.where(inside, g_tgt, 0.0)[:, None])
            dl = dl.to(h.dtype)
            dh += (dl @ wc).float()
            dw[lo:lo + chunk] = (dl.t() @ h).float()
        return dh.to(h.dtype), dw.to(w.dtype), None, None


def chunked_lse_and_target(h: torch.Tensor, w: torch.Tensor,
                           targets: torch.Tensor, chunk: int = CHUNK
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming ``(lse, target logit)`` of ``h @ w^T`` over a large
    vocabulary (JAX ``_chunked_lse_and_target``), both f32 of ``targets``'
    shape; ``h [..., D]``, ``w [V, D]``."""
    shape = targets.shape
    lse, tgt = _ChunkedLSE.apply(h.reshape(-1, h.shape[-1]), w,
                                 targets.reshape(-1), chunk)
    return lse.reshape(shape), tgt.reshape(shape)


def _cluster_columns(targets: torch.Tensor, bounds: Sequence[int]
                     ) -> torch.Tensor:
    """Head column of each target: the word itself in the head, else its
    cluster's slot after the ``bounds[0]`` head words."""
    c0 = bounds[0]
    col = torch.where(targets < c0, targets, torch.zeros_like(targets))
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i], bounds[i + 1]
        col = torch.where((targets >= lo) & (targets < hi),
                          torch.full_like(targets, c0 + i), col)
    return col


def _tail_nll(nll, targets, h_t, w_out, lo, hi):
    in_tail = (targets >= lo) & (targets < hi)
    t_loc = torch.where(in_tail, targets - lo,
                        torch.zeros_like(targets)).clamp(0, hi - lo - 1)
    lse, tgt = chunked_lse_and_target(h_t, w_out, t_loc)
    return nll + torch.where(in_tail, lse - tgt, torch.zeros_like(lse))


def _log_prob(head_logits, tail_logits: List[torch.Tensor], c0: int):
    head_lp = F.log_softmax(head_logits.float(), dim=-1)
    parts = [head_lp[..., :c0]]
    for i, logits in enumerate(tail_logits):
        parts.append(head_lp[..., c0 + i:c0 + i + 1]
                     + F.log_softmax(logits.float(), dim=-1))
    return torch.cat(parts, dim=-1)


def _bounds(cutoffs: Sequence[int], vocab_size: int) -> List[int]:
    bounds = list(cutoffs) + [vocab_size]
    if sorted(set(bounds)) != bounds:
        raise ValueError(f"cutoffs {cutoffs} must increase below {vocab_size}")
    return bounds


class AdaptiveSoftmax(nn.Module):
    """Hierarchical output layer with its own weights: the head predicts the
    ``cutoffs[0]`` common words and one slot per tail cluster; tail cluster
    i predicts its range through a factor-4^(i+1) bottleneck."""

    def __init__(self, vocab_size: int, input_dim: int,
                 cutoffs: Sequence[int], factor: float = 4.0):
        super().__init__()
        self.bounds = _bounds(cutoffs, vocab_size)
        n = len(self.bounds) - 1
        self.head = Linear(input_dim, self.bounds[0] + n, bias=False)
        # fairseq's tail is (Linear, Dropout, Linear); the dropout is 0 here
        self.tail = nn.ModuleList(
            nn.Sequential(
                Linear(input_dim, max(1, int(input_dim // factor ** (i + 1))),
                       bias=False),
                nn.Identity(),
                Linear(max(1, int(input_dim // factor ** (i + 1))),
                       self.bounds[i + 1] - self.bounds[i], bias=False))
            for i in range(n))

    def nll(self, x: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Per-token negative log-likelihood (f32); x ``[..., D]``."""
        lse, tgt = chunked_lse_and_target(
            x, self.head.weight, _cluster_columns(targets, self.bounds))
        nll = lse - tgt
        for i, tail in enumerate(self.tail):
            h_t = x @ tail[0].weight.to(x.dtype).t()
            nll = _tail_nll(nll, targets, h_t, tail[2].weight,
                            self.bounds[i], self.bounds[i + 1])
        return nll

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Full ``[..., V]`` log-probabilities (f32)."""
        return _log_prob(self.head(x), [t(x) for t in self.tail],
                         self.bounds[0])


class _TiedHead(nn.Module):
    def __init__(self, input_dim: int, n_clusters: int):
        super().__init__()
        self.class_proj = Linear(input_dim, n_clusters, bias=False)


class TiedAdaptiveSoftmax(nn.Module):
    """Adaptive softmax fully tied to an :class:`AdaptiveInput` (fairseq
    ``--tie-adaptive-weights --tie-adaptive-proj``, the published wiki103
    configuration).  It owns only the cluster head ``head.class_proj``; the
    band embeddings ``embs[i] [size_i, dim_i]`` and projections
    ``projs[i] [D, dim_i]`` (torch Linear layout) of the input are passed
    in:

    * head word logits  = x @ embs[0]^T
    * tail i projection = x @ projs[i+1]
    * tail i logits     = that @ embs[i+1]^T
    """

    def __init__(self, vocab_size: int, input_dim: int,
                 cutoffs: Sequence[int]):
        super().__init__()
        self.bounds = _bounds(cutoffs, vocab_size)
        self.head = _TiedHead(input_dim, len(self.bounds) - 1)

    def nll(self, x, targets, embs, projs) -> torch.Tensor:
        """Per-token negative log-likelihood (f32)."""
        w_cls = self.head.class_proj.weight
        w_head = torch.cat([embs[0], w_cls.to(embs[0].dtype)], dim=0)
        lse, tgt = chunked_lse_and_target(
            x, w_head, _cluster_columns(targets, self.bounds))
        nll = lse - tgt
        for i in range(len(self.bounds) - 1):
            h_t = x @ projs[i + 1].to(x.dtype)
            nll = _tail_nll(nll, targets, h_t, embs[i + 1],
                            self.bounds[i], self.bounds[i + 1])
        return nll

    def log_prob(self, x, embs, projs) -> torch.Tensor:
        head = torch.cat([x @ embs[0].to(x.dtype).t(),
                          self.head.class_proj(x)], dim=-1)
        tails = [(x @ projs[i + 1].to(x.dtype)) @ embs[i + 1].to(x.dtype).t()
                 for i in range(len(self.bounds) - 1)]
        return _log_prob(head, tails, self.bounds[0])


class AdaptiveInput(nn.Module):
    """Adaptive input embeddings (Baevski & Auli; fairseq
    ``modules/adaptive_input.py``): band i of the vocabulary has
    ``D / 4^i``-wide embeddings projected up to ``D``.

    The bands are summed into a float32 buffer, as the JAX module's are
    (``models/adaptive_softmax.py:277``): under ``--bf16`` every later
    activation of the model is float32, and its layers compute in float32
    with their bfloat16 weights cast up (``ops/promote.py``)."""

    def __init__(self, vocab_size: int, embed_dim: int,
                 cutoffs: Sequence[int], factor: float = 4.0):
        super().__init__()
        self.bounds = _bounds(cutoffs, vocab_size)
        self.embed_dim = embed_dim
        self.embeddings = nn.ModuleList()
        prev = 0
        for i, hi in enumerate(self.bounds):
            dim = max(1, int(embed_dim // factor ** i))
            self.embeddings.append(nn.Sequential(
                nn.Embedding(hi - prev, dim),
                nn.Linear(dim, embed_dim, bias=False)))
            prev = hi

    def band_weights(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Band embeddings and projections, for the tied softmax."""
        return ([e[0].weight for e in self.embeddings],
                [e[1].weight for e in self.embeddings])

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(tokens.shape + (self.embed_dim,), dtype=torch.float32,
                          device=tokens.device)
        prev = 0
        for band, hi in zip(self.embeddings, self.bounds):
            in_band = (tokens >= prev) & (tokens < hi)
            tok = torch.where(in_band, tokens - prev, torch.zeros_like(tokens))
            emb = band(tok)
            out = out + torch.where(in_band[..., None], emb,
                                    torch.zeros((), dtype=emb.dtype,
                                                device=tokens.device))
            prev = hi
        return out

"""Corpus BLEU scorer (pure Python).

The port's own copy of ``efficient_attention_tpu/scoring/bleu.py`` (which
replaces fairseq's ``clib/libbleu`` counter, ``fairseq/scoring/bleu.py``):
clipped n-gram precision up to order 4 and the brevity penalty, over token
ids with pad and eos dropped; ``WordIdMapper`` maps whitespace words to ids
for dictionary-free scoring.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence


def _ngram_counts(tokens: Sequence[int], order: int) -> Counter:
    out: Counter = Counter()
    for n in range(1, order + 1):
        for i in range(len(tokens) - n + 1):
            out[tuple(tokens[i:i + n])] += 1
    return out


class BleuScorer:
    """Streaming corpus BLEU (``fairseq.scoring.bleu.Scorer`` surface)."""

    def __init__(self, pad: int = 1, eos: int = 2, unk: int = 3,
                 order: int = 4):
        self.pad, self.eos, self.unk = pad, eos, unk
        self.order = order
        self.reset()

    def reset(self):
        self.match = [0] * self.order
        self.total = [0] * self.order
        self.sys_len = 0
        self.ref_len = 0

    def _clean(self, toks: Sequence[int]) -> List[int]:
        return [t for t in toks if t not in (self.pad, self.eos)]

    def add(self, ref: Sequence[int], hyp: Sequence[int]) -> None:
        ref = self._clean(ref)
        hyp = self._clean(hyp)
        self.sys_len += len(hyp)
        self.ref_len += len(ref)
        ref_counts = _ngram_counts(ref, self.order)
        hyp_counts = _ngram_counts(hyp, self.order)
        for ng, cnt in hyp_counts.items():
            n = len(ng) - 1
            self.total[n] += cnt
            self.match[n] += min(cnt, ref_counts.get(ng, 0))

    def brevity(self) -> float:
        if self.sys_len == 0:
            return 0.0
        return min(1.0, math.exp(1 - self.ref_len / self.sys_len))

    def precision(self, n: int, smooth: int = 0) -> float:
        if self.total[n] + smooth == 0:
            return 0.0
        return (self.match[n] + smooth) / (self.total[n] + smooth)

    def score(self, order: int = 4, smooth: int = 0) -> float:
        precisions = [self.precision(n, smooth) for n in range(order)]
        if min(precisions) <= 0:
            return 0.0
        log_avg = sum(math.log(p) for p in precisions) / order
        return 100.0 * self.brevity() * math.exp(log_avg)

    def result_string(self, order: int = 4) -> str:
        ps = [100 * self.precision(n) for n in range(order)]
        return (f"BLEU{order} = {self.score(order):.2f}, "
                + "/".join(f"{p:.1f}" for p in ps)
                + f" (BP={self.brevity():.3f}, ratio={self.sys_len / max(self.ref_len, 1):.3f}, "
                f"syslen={self.sys_len}, reflen={self.ref_len})")


class WordIdMapper:
    """Whitespace-token -> stable integer id mapping for word-level BLEU
    over text lines (``fairseq_cli/score.py``'s dictionary-free scoring).
    Ids start at 10 to stay clear of the reserved special-token range."""

    def __init__(self):
        self._vocab = {}

    def __call__(self, line: str):
        out = []
        for w in line.split():
            if w not in self._vocab:
                self._vocab[w] = len(self._vocab) + 10
            out.append(self._vocab[w])
        return out

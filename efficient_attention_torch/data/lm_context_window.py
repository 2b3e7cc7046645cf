"""Sliding-context blocks for LM evaluation.

Counterpart of ``efficient_attention_tpu/data/lm_context_window.py``
(fairseq ``data/lm_context_window_dataset.py`` and
``fairseq_cli/eval_lm.py:244-246``): with ``--context-window c`` the blocks
advance by ``tokens_per_sample - c`` and each carries the previous ``c``
tokens as unscored context, so every scored token sees at least ``c``
tokens of history.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def context_window_blocks(tokens: np.ndarray, tokens_per_sample: int,
                          context_window: int = 0, pad_idx: int = 1
                          ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields ``(block [tokens_per_sample], score_mask [tokens_per_sample])``:
    the mask marks the positions whose token is scored (not context, not
    padding); the caller shifts both by one for next-token targets.  The
    last block is right-padded with ``pad_idx``."""
    n = len(tokens)
    stride = tokens_per_sample - context_window
    if stride <= 0:
        raise ValueError("context window must be smaller than tokens_per_sample")
    start, first = 0, True
    while start < n:
        if first:
            block = tokens[:tokens_per_sample]
            scored_from, next_start, first = 0, len(block), False
        else:
            ctx_start = start - context_window
            block = tokens[ctx_start:ctx_start + tokens_per_sample]
            scored_from, next_start = context_window, start + stride
        mask = np.zeros(tokens_per_sample, bool)
        mask[scored_from:len(block)] = True
        if len(block) < tokens_per_sample:
            block = np.concatenate([block, np.full(
                tokens_per_sample - len(block), pad_idx, dtype=tokens.dtype)])
        yield block, mask
        start = next_start

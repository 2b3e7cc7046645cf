"""LM token blocks and token collation.

Counterparts of ``TokenBlockDataset`` and ``collate_tokens`` in
``efficient_attention_tpu/data/text_data.py`` (fairseq
``data/token_block_dataset.py``, 'none' break mode, the wiki103 recipe's
``--tokens-per-sample``; ``data/data_utils.py:collate_tokens``).  Language
pair datasets and token-budget batching come with MT training (ROADMAP.md
Queue 1, item 6).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


class TokenBlockDataset:
    """A flat token stream cut into blocks of ``block_size``; the last block
    is right-padded with ``pad_idx``."""

    def __init__(self, tokens: np.ndarray, block_size: int, pad_idx: int = 1):
        self.tokens = tokens
        self.block_size = block_size
        self.pad_idx = pad_idx
        self.n_blocks = max(1, math.ceil(len(tokens) / block_size))

    def __len__(self) -> int:
        return self.n_blocks

    def __getitem__(self, i: int) -> np.ndarray:
        block = self.tokens[i * self.block_size:(i + 1) * self.block_size]
        if len(block) < self.block_size:
            block = np.concatenate([block, np.full(
                self.block_size - len(block), self.pad_idx, dtype=block.dtype)])
        return block

    @property
    def sizes(self) -> np.ndarray:
        return np.full(self.n_blocks, self.block_size, dtype=np.int64)


def collate_tokens(samples: Sequence[np.ndarray], pad_idx: int,
                   pad_to_length: Optional[int] = None,
                   pad_to_multiple: int = 8, move_eos_to_beginning: bool = False,
                   eos_idx: int = 2) -> np.ndarray:
    """Right-pad 1-D token arrays into ``[B, T]``, ``T`` at least
    ``pad_to_length`` and a multiple of ``pad_to_multiple``; with
    ``move_eos_to_beginning`` build ``prev_output_tokens`` (eos first, the
    last token dropped)."""
    max_len = max(len(s) for s in samples)
    if pad_to_length:
        max_len = max(max_len, pad_to_length)
    max_len = int(math.ceil(max_len / pad_to_multiple) * pad_to_multiple)
    out = np.full((len(samples), max_len), pad_idx, dtype=np.int64)
    for i, s in enumerate(samples):
        if move_eos_to_beginning:
            out[i, 0] = eos_idx
            out[i, 1:len(s)] = s[:-1]
        else:
            out[i, :len(s)] = s
    return out

"""LM token blocks.

Counterpart of ``TokenBlockDataset`` in
``efficient_attention_tpu/data/text_data.py`` (fairseq
``data/token_block_dataset.py``, 'none' break mode, the wiki103 recipe's
``--tokens-per-sample``).  Language pairs and token-budget batching come
with the MT model (ROADMAP.md Queue 1, item 6).
"""
from __future__ import annotations

import math

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

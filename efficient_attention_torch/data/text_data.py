"""LM token blocks, language pairs, token-budget batching and token
collation.

Counterparts of ``TokenBlockDataset``, ``LanguagePairDataset``,
``batch_by_size`` and ``collate_tokens`` in
``efficient_attention_tpu/data/text_data.py`` (fairseq
``data/token_block_dataset.py``, 'none' break mode, the wiki103 recipe's
``--tokens-per-sample``; ``data/language_pair_dataset.py``;
``data/data_utils_fast.pyx:batch_by_size_*``;
``data/data_utils.py:collate_tokens``).  ``batch_by_size`` is the JAX
package's pure-Python packing loop, whose batches its native library
reproduces.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

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


class LanguagePairDataset:
    """Paired source and target sentences (fairseq
    ``language_pair_dataset.py`` essentials): item ``i`` is ``(src[i],
    tgt[i])``."""

    def __init__(self, src, tgt, pad_idx: int = 1, eos_idx: int = 2):
        assert len(src) == len(tgt)
        self.src, self.tgt = src, tgt
        self.pad_idx, self.eos_idx = pad_idx, eos_idx

    def __len__(self) -> int:
        return len(self.src)

    def __getitem__(self, i: int):
        return self.src[i], self.tgt[i]

    @property
    def src_sizes(self) -> np.ndarray:
        return self.src.sizes

    @property
    def tgt_sizes(self) -> np.ndarray:
        return self.tgt.sizes


def batch_by_size(indices: np.ndarray, sizes: np.ndarray, max_tokens: int,
                  max_sentences: Optional[int] = None,
                  required_multiple: int = 8) -> List[np.ndarray]:
    """Greedy token-budget packing of ``indices`` (usually length-sorted):
    a batch closes when the next item would take it past ``max_tokens``
    (counting padding to the batch's longest) or past ``max_sentences``; a
    closing batch longer than ``required_multiple`` is cut to a multiple of
    it, and the cut items open the next batch."""
    batches = []
    cur: List[int] = []
    cur_max = 0
    for idx in indices:
        size = int(sizes[idx])
        new_max = max(cur_max, size)
        if cur and (new_max * (len(cur) + 1) > max_tokens
                    or (max_sentences and len(cur) >= max_sentences)):
            keep = len(cur)
            if keep > required_multiple:
                keep -= keep % required_multiple
            batches.append(np.asarray(cur[:keep]))
            cur = cur[keep:]
            cur_max = max((int(sizes[i]) for i in cur), default=0)
        cur.append(idx)
        cur_max = max(cur_max, size)
    if cur:
        batches.append(np.asarray(cur))
    return batches


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

"""Memory-mapped binarized corpus.

Counterpart of ``efficient_attention_tpu/data/indexed_dataset.py`` (the
role of fairseq's ``MMapIndexedDataset``): a ``.bin`` of the sequences'
tokens back to back and a ``.idx`` of the magic ``EATPUIDX``, the dtype
code (1 uint16, 2 int32, 3 int64), the sequence count (little-endian
``<BQ``) and the int64 lengths.  The files are byte for byte the JAX
writer's, so each package reads the other's corpus.
"""
from __future__ import annotations

import struct
from typing import List

import numpy as np

_MAGIC = b"EATPUIDX"
_DTYPES = {1: np.uint16, 2: np.int32, 3: np.int64}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class MMapIndexedDatasetBuilder:
    def __init__(self, path_prefix: str, dtype=np.int32):
        self.prefix = path_prefix
        self.dtype = np.dtype(dtype)
        self._bin = open(path_prefix + ".bin", "wb")
        self.lengths: List[int] = []

    def add_item(self, tokens: np.ndarray) -> None:
        arr = np.asarray(tokens, dtype=self.dtype)
        self._bin.write(arr.tobytes(order="C"))
        self.lengths.append(len(arr))

    def finalize(self) -> None:
        self._bin.close()
        lengths = np.asarray(self.lengths, dtype=np.int64)
        with open(self.prefix + ".idx", "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<BQ", _DTYPE_CODES[self.dtype], len(lengths)))
            f.write(lengths.tobytes(order="C"))


class MMapIndexedDataset:
    """Zero-copy random access over a binarized corpus."""

    def __init__(self, path_prefix: str):
        with open(path_prefix + ".idx", "rb") as f:
            if f.read(len(_MAGIC)) != _MAGIC:
                raise ValueError(f"bad index file for {path_prefix}")
            dtype_code, n = struct.unpack("<BQ", f.read(9))
            self.lengths = np.frombuffer(f.read(8 * n), dtype=np.int64)
        self.dtype = _DTYPES[dtype_code]
        self.offsets = np.concatenate([[0], np.cumsum(self.lengths)]).astype(np.int64)
        self._data = np.memmap(path_prefix + ".bin", dtype=self.dtype, mode="r")

    def __len__(self):
        return len(self.lengths)

    def __getitem__(self, i: int) -> np.ndarray:
        return np.asarray(self._data[self.offsets[i]:self.offsets[i + 1]],
                          dtype=np.int64)

    @property
    def sizes(self) -> np.ndarray:
        return self.lengths

    def flat_tokens(self) -> np.ndarray:
        """The whole corpus as one int64 token stream (for token blocks)."""
        return np.asarray(self._data, dtype=np.int64)


def binarize_file(text_path: str, dictionary, out_prefix: str,
                  append_eos: bool = True, dtype=np.int32) -> dict:
    """Encode a tokenized text file a line a sequence (fairseq
    ``binarizer.py``) and write ``out_prefix.{bin,idx}``; returns the
    counts of sequences, tokens and ``<unk>``s."""
    builder = MMapIndexedDatasetBuilder(out_prefix, dtype=dtype)
    n_tok = n_unk = n_seq = 0
    with open(text_path, encoding="utf-8") as f:
        for line in f:
            ids = dictionary.encode_line(line, append_eos=append_eos)
            n_unk += int((ids == dictionary.unk()).sum())
            n_tok += len(ids)
            n_seq += 1
            builder.add_item(ids)
    builder.finalize()
    return {"sequences": n_seq, "tokens": n_tok, "unk": n_unk}

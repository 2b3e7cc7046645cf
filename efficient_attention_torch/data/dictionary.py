"""Vocabulary with fairseq's special-symbol layout.

Counterpart of ``efficient_attention_tpu/data/dictionary.py`` (fairseq
``data/dictionary.py``): ``<s>=0, <pad>=1, </s>=2, <unk>=3``, then the
corpus words by descending count; the text format (``word count`` a line)
is fairseq's ``dict.txt``, so either package reads the other's files.
"""
from __future__ import annotations

from collections import Counter
from typing import Iterable, List

import numpy as np


class Dictionary:
    def __init__(self, bos="<s>", pad="<pad>", eos="</s>", unk="<unk>"):
        self.symbols: List[str] = []
        self.count: List[int] = []
        self.indices = {}
        self.bos_word, self.pad_word, self.eos_word, self.unk_word = (
            bos, pad, eos, unk)
        self.bos_index = self.add_symbol(bos)
        self.pad_index = self.add_symbol(pad)
        self.eos_index = self.add_symbol(eos)
        self.unk_index = self.add_symbol(unk)
        self.nspecial = len(self.symbols)

    def __len__(self):
        return len(self.symbols)

    def __getitem__(self, idx):
        return self.symbols[idx] if idx < len(self.symbols) else self.unk_word

    def bos(self):
        return self.bos_index

    def pad(self):
        return self.pad_index

    def eos(self):
        return self.eos_index

    def unk(self):
        return self.unk_index

    def add_symbol(self, word: str, n: int = 1) -> int:
        if word in self.indices:
            idx = self.indices[word]
            self.count[idx] += n
            return idx
        idx = len(self.symbols)
        self.indices[word] = idx
        self.symbols.append(word)
        self.count.append(n)
        return idx

    def index(self, word: str) -> int:
        return self.indices.get(word, self.unk_index)

    def encode_line(self, line: str, append_eos: bool = True) -> np.ndarray:
        ids = [self.index(w) for w in line.strip().split()]
        if append_eos:
            ids.append(self.eos_index)
        return np.asarray(ids, dtype=np.int32)

    def string(self, ids: Iterable[int], remove_special: bool = True) -> str:
        special = (self.bos_index, self.pad_index, self.eos_index)
        return " ".join(self[int(i)] for i in ids
                        if not (remove_special and int(i) in special))

    def finalize(self, threshold: int = -1, nwords: int = -1,
                 padding_factor: int = 8) -> None:
        """Sort the corpus words by (-count, word), drop those below
        ``threshold``, keep ``nwords`` symbols in all (specials included),
        and pad the vocabulary to a multiple of ``padding_factor`` with
        ``madeupwordNNNN`` (fairseq ``Dictionary.finalize``)."""
        special = list(zip(self.symbols[:self.nspecial],
                           self.count[:self.nspecial]))
        corpus = sorted(zip(self.symbols[self.nspecial:],
                            self.count[self.nspecial:]),
                        key=lambda kv: (-kv[1], kv[0]))
        if threshold > 0:
            corpus = [(w, c) for w, c in corpus if c >= threshold]
        if nwords > 0:
            corpus = corpus[:nwords - self.nspecial]
        symbols = special + corpus
        while padding_factor > 1 and len(symbols) % padding_factor != 0:
            symbols.append((f"madeupword{len(symbols):04d}", 0))
        self.symbols = [w for w, _ in symbols]
        self.count = [c for _, c in symbols]
        self.indices = {w: i for i, (w, _) in enumerate(symbols)}

    @classmethod
    def build_from_corpus(cls, lines: Iterable[str], threshold=-1, nwords=-1,
                          padding_factor=8) -> "Dictionary":
        d = cls()
        counter = Counter()
        for line in lines:
            counter.update(line.strip().split())
        for w, c in counter.items():
            d.add_symbol(w, c)
        d.finalize(threshold, nwords, padding_factor)
        return d

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for w, c in zip(self.symbols[self.nspecial:],
                            self.count[self.nspecial:]):
                f.write(f"{w} {c}\n")

    @classmethod
    def load(cls, path: str) -> "Dictionary":
        d = cls()
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").rsplit(" ", 1)
                if len(parts) == 2:
                    d.add_symbol(parts[0], int(parts[1]))
        return d

"""The LM protocol's data layer in the PyTorch port against the JAX package.

The dictionary, the binarized ``.bin``/``.idx`` files, ``cli.preprocess``
and the eval blocks of ``context_window_blocks``, on corpora of 30-50 lines
drawn with numpy from a seed.  Everything here is exact: the same symbols,
counts and ids, the same bytes on disk (so either package reads the
other's corpus), the same blocks and score masks.
"""
import os

import numpy as np
import pytest

from efficient_attention_torch.cli import preprocess
from efficient_attention_torch.data.dictionary import Dictionary
from efficient_attention_torch.data.indexed_dataset import (
    MMapIndexedDataset,
    binarize_file,
)
from efficient_attention_torch.data.lm_context_window import context_window_blocks
from efficient_attention_tpu.cli import preprocess as jax_preprocess
from efficient_attention_tpu.data import dictionary as jax_dictionary
from efficient_attention_tpu.data import indexed_dataset as jax_indexed
from efficient_attention_tpu.data import lm_context_window as jax_window

# 40 word types of Zipf-like frequency, so thresholds and nwords cut ties
WORDS = [f"w{i:02d}" for i in range(40)]


def _write_corpus(path, n=40, seed=0, words=WORDS):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    with open(path, "w", encoding="utf-8") as f:
        for _ in range(n):
            k = int(rng.integers(3, 12))
            f.write(" ".join(words[i] for i in rng.choice(len(words), k, p=p / p.sum()))
                    + "\n")


def _write_pairs(prefix, n=30, seed=0):
    rng = np.random.default_rng(seed)
    with open(f"{prefix}.src", "w", encoding="utf-8") as fs, \
            open(f"{prefix}.tgt", "w", encoding="utf-8") as ft:
        for _ in range(n):
            idx = rng.integers(0, len(WORDS), int(rng.integers(2, 6)))
            fs.write(" ".join(WORDS[i] for i in idx) + "\n")
            ft.write(" ".join("t" + WORDS[i] for i in reversed(idx)) + "\n")


def _lines(path):
    with open(path, encoding="utf-8") as f:
        return f.readlines()


def _same_dictionary(d, jd):
    assert d.symbols == jd.symbols
    assert d.count == jd.count
    assert d.indices == jd.indices
    assert (d.bos(), d.pad(), d.eos(), d.unk(), d.nspecial) == (
        jd.bos(), jd.pad(), jd.eos(), jd.unk(), jd.nspecial)


@pytest.mark.parametrize("threshold,nwords,padding", [
    (-1, -1, 8), (3, -1, 8), (-1, 13, 8), (2, 20, 8), (-1, -1, 1), (-1, -1, 16)])
def test_dictionary_matches_jax(tmp_path, threshold, nwords, padding):
    """Build, finalize (threshold, nwords, padding to a multiple), save,
    load, ``encode_line`` and ``string``: the same symbols, counts and ids,
    the same dict.txt bytes, each package loading the other's file."""
    corpus = tmp_path / "train.txt"
    _write_corpus(corpus, n=50)
    d = Dictionary.build_from_corpus(_lines(corpus), threshold, nwords, padding)
    jd = jax_dictionary.Dictionary.build_from_corpus(_lines(corpus), threshold,
                                                     nwords, padding)
    _same_dictionary(d, jd)
    assert len(d) % max(padding, 1) == 0
    d.save(str(tmp_path / "port.txt"))
    jd.save(str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    _same_dictionary(Dictionary.load(str(tmp_path / "jax.txt")),
                     jax_dictionary.Dictionary.load(str(tmp_path / "port.txt")))
    for line in _lines(corpus)[:10] + ["w00 never-seen w01", ""]:
        for eos in (True, False):
            ids = d.encode_line(line, append_eos=eos)
            jids = jd.encode_line(line, append_eos=eos)
            assert ids.dtype == jids.dtype and np.array_equal(ids, jids)
            assert d.string(ids) == jd.string(jids)
            assert d.string(ids, remove_special=False) == jd.string(
                jids, remove_special=False)
    assert d[len(d) + 5] == jd[len(jd) + 5] == "<unk>"


@pytest.mark.parametrize("dtype", [np.uint16, np.int32, np.int64])
def test_binarized_files_are_byte_equal_and_cross_read(tmp_path, dtype):
    """``binarize_file`` writes JAX's bytes, and each package's reader reads
    the other's files to the same sizes, sequences and flat stream."""
    corpus = tmp_path / "train.txt"
    _write_corpus(corpus, n=45, seed=1)
    d = Dictionary.build_from_corpus(_lines(corpus), nwords=24)
    stats = binarize_file(str(corpus), d, str(tmp_path / "port"), dtype=dtype)
    jstats = jax_indexed.binarize_file(str(corpus), d, str(tmp_path / "jax"),
                                       dtype=dtype)
    assert stats == jstats and stats["unk"] > 0
    for ext in (".bin", ".idx"):
        assert ((tmp_path / f"port{ext}").read_bytes()
                == (tmp_path / f"jax{ext}").read_bytes())
    port_reads_jax = MMapIndexedDataset(str(tmp_path / "jax"))
    jax_reads_port = jax_indexed.MMapIndexedDataset(str(tmp_path / "port"))
    assert len(port_reads_jax) == len(jax_reads_port) == stats["sequences"]
    assert np.array_equal(port_reads_jax.sizes, jax_reads_port.sizes)
    flat = port_reads_jax.flat_tokens()
    assert flat.dtype == np.int64 and len(flat) == stats["tokens"]
    assert np.array_equal(flat, jax_reads_port.flat_tokens())
    for i in (0, 7, len(port_reads_jax) - 1):
        assert np.array_equal(port_reads_jax[i], jax_reads_port[i])
    with open(str(tmp_path / "bad.idx"), "wb") as f:
        f.write(b"NOTANIDX" + bytes(9))
    with pytest.raises(ValueError, match="bad index"):
        MMapIndexedDataset(str(tmp_path / "bad"))


def _tree(path):
    return {os.path.relpath(os.path.join(root, name), path):
            open(os.path.join(root, name), "rb").read()
            for root, _, files in os.walk(path) for name in files}


def _run_both(tmp_path, argv_of):
    """Run both CLIs with ``argv_of(destdir)``; return the two trees."""
    port, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    preprocess.cli_main(argv_of(port))
    jax_preprocess.cli_main(argv_of(jax_dir))
    return _tree(port), _tree(jax_dir)


def test_preprocess_lm_mode_matches_jax(tmp_path):
    """LM mode (no languages): dict.txt and the three splits' files byte
    for byte, with a threshold and nwords."""
    for split, n in (("train", 50), ("valid", 30), ("test", 30)):
        _write_corpus(tmp_path / f"{split}.txt", n=n, seed=len(split))
    port, jax_tree = _run_both(tmp_path, lambda dest: [
        "--trainpref", str(tmp_path / "train.txt"),
        "--validpref", str(tmp_path / "valid.txt"),
        "--testpref", str(tmp_path / "test.txt"), "--destdir", dest,
        "--thresholdsrc", "2", "--nwordssrc", "30"])
    assert sorted(port) == ["dict.txt"] + [f"{s}.{e}" for s in ("test", "train", "valid")
                                           for e in ("bin", "idx")]
    assert port == jax_tree


@pytest.mark.parametrize("joined", [True, False], ids=["joined", "per-side"])
def test_preprocess_mt_mode_matches_jax(tmp_path, joined):
    """MT mode (-s/-t), one joined dictionary or one a side with per-side
    thresholds: every file byte for byte."""
    _write_pairs(str(tmp_path / "train"), n=30)
    _write_pairs(str(tmp_path / "valid"), n=12, seed=1)
    extra = ["--joined-dictionary"] if joined else [
        "--thresholdtgt", "2", "--nwordssrc", "20"]
    port, jax_tree = _run_both(tmp_path, lambda dest: [
        "--trainpref", str(tmp_path / "train"),
        "--validpref", str(tmp_path / "valid"), "--destdir", dest,
        "-s", "src", "-t", "tgt"] + extra)
    assert {"dict.src.txt", "dict.tgt.txt", "train.src.bin", "valid.tgt.idx"} <= set(port)
    assert port == jax_tree
    if joined:
        assert port["dict.src.txt"] == port["dict.tgt.txt"]


def test_preprocess_dict_reuse_and_dict_only_match_jax(tmp_path):
    """``test_e2e_language.py::test_preprocess_dict_reuse_and_dict_only``
    on both packages: --dict-only with per-side nwords writes dictionaries
    and no binaries; --srcdict/--tgtdict reuse binarizes against them."""
    _write_pairs(str(tmp_path / "train"), n=30)
    _write_pairs(str(tmp_path / "valid"), n=10, seed=2)
    port, jax_tree = _run_both(tmp_path / "only", lambda dest: [
        "--trainpref", str(tmp_path / "train"), "--destdir", dest,
        "-s", "src", "-t", "tgt", "--nwordssrc", "12", "--nwordstgt", "8",
        "--dict-only"])
    assert sorted(port) == ["dict.src.txt", "dict.tgt.txt"] and port == jax_tree
    dsrc = Dictionary.load(str(tmp_path / "only" / "port" / "dict.src.txt"))
    dtgt = Dictionary.load(str(tmp_path / "only" / "port" / "dict.tgt.txt"))
    assert len(dsrc) == 16 and len(dtgt) == 8
    assert dsrc[12].startswith("madeupword")
    port, jax_tree = _run_both(tmp_path / "reuse", lambda dest: [
        "--trainpref", str(tmp_path / "train"),
        "--validpref", str(tmp_path / "valid"), "--destdir", dest,
        "-s", "src", "-t", "tgt",
        "--srcdict", str(tmp_path / "only" / "port" / "dict.src.txt"),
        "--tgtdict", str(tmp_path / "only" / "jax" / "dict.tgt.txt")])
    assert "train.src.bin" in port and port == jax_tree
    assert len(Dictionary.load(str(tmp_path / "reuse" / "port" / "dict.src.txt"))) == 16


@pytest.mark.parametrize("tps,window", [(17, 0), (17, 8), (17, 16), (33, 0),
                                        (33, 5), (33, 32)])
@pytest.mark.parametrize("n", [1, 10, 17, 18, 100, 257])
def test_context_window_blocks_match_jax(n, tps, window):
    """The same blocks and score masks over a grid of corpus lengths
    (shorter than a sample, one sample, one token over, several), samples
    and windows (0 up to ``tokens_per_sample - 1``)."""
    tokens = np.random.default_rng(n).integers(4, 50, n).astype(np.int64)
    ours = list(context_window_blocks(tokens, tps, window, pad_idx=1))
    ref = list(jax_window.context_window_blocks(tokens, tps, window, pad_idx=1))
    assert len(ours) == len(ref)
    for (b, m), (rb, rm) in zip(ours, ref):
        assert b.dtype == rb.dtype and np.array_equal(b, rb)
        assert np.array_equal(m, rm)
    # every token but the first is scored once as a next-token target
    scored = sum(int(m[1:].sum()) for _, m in ours)
    first_only = n - len(ours) if window == 0 else n - 1
    assert scored == first_only


def test_context_window_rejects_a_window_as_long_as_the_sample():
    with pytest.raises(ValueError, match="smaller than"):
        list(context_window_blocks(np.arange(10), 8, 8))

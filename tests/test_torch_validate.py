"""``cli/validate.py`` of the PyTorch port against the JAX package's, on the
CPU.

* ``--task lm``: the port's ``eval_lm`` on the ``valid`` split, reading
  JAX's ``PRNGKey(0)`` parameters from the port's ``CheckpointManager``,
  against JAX's ``validate --task lm`` (which initialises the same
  parameters): the token count exactly, the losses to 1e-5 relative.
* ``--task mt``: the label-smoothed loss, NLL and perplexity from the same
  checkpoint written by each package's manager (JAX's by orbax with
  ``async_save=False``, the port's after ``interop.mt_state_dict_from_jax``),
  with ``--valid-subset train`` on the port, since JAX's CLI reads the
  train split (ROADMAP.md Queue 3): the tokens exactly, the sums to 1e-5
  relative.  The port reads ``--valid-subset valid`` by default.

The models are tiny (dim 32, 1 + 1 layers) with the WMT recipe's attention
kinds; the corpora are ``test_e2e_language.py``'s.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import exact_float32
from efficient_attention_torch.cli import preprocess, validate
from efficient_attention_torch.interop import lm_state_dict_from_jax, mt_state_dict_from_jax
from efficient_attention_torch.training.checkpoint import CheckpointManager
from efficient_attention_tpu.cli import train_lm as jax_train_lm
from efficient_attention_tpu.cli import train_mt as jax_train_mt
from efficient_attention_tpu.cli import validate as jax_validate
from efficient_attention_tpu.training import checkpoint as jax_checkpoint

from test_e2e_language import _write_lm_corpus

LM_ARGV = [
    "--attn-name-decoder", "causal_eva", "--decoder-attn-window-size", "8",
    "--decoder-attn-chunk-size", "4", "--decoder-attn-adaptive-proj", "qk",
    "--decoder-attn-use-t5-rpe", "--decoder-attn-causal",
    "--decoder-embed-dim", "32", "--decoder-ffn-embed-dim", "64",
    "--decoder-layers", "2", "--decoder-attention-heads", "2",
    "--tokens-per-sample", "16", "--max-tokens", "64", "--dropout", "0",
    "--max-len", "64", "--criterion", "cross_entropy",
]
LM_VOCAB = 24
MT_ARGV = [
    "--encoder-embed-dim", "32", "--encoder-ffn-embed-dim", "64",
    "--encoder-layers", "1", "--encoder-attention-heads", "2",
    "--attn-name-encoder", "eva", "--encoder-attn-window-size", "8",
    "--encoder-attn-num-landmarks", "8", "--encoder-attn-overlap-window",
    "--encoder-attn-use-t5-rpe", "--encoder-attn-adaptive-proj", "no-ln",
    "--attn-name-decoder", "causal_eva", "--decoder-attn-window-size", "16",
    "--decoder-attn-chunk-size", "8", "--decoder-attn-adaptive-proj", "qk",
    "--decoder-attn-causal", "--share-all-embeddings",
]
WORDS = ["the", "cat", "sat", "on", "mat", "dog", "ran", "in", "park",
         "bird", "flew", "over", "tree"]


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def _lm_data(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for split, n in (("train", 30), ("valid", 20), ("test", 10)):
        _write_lm_corpus(corpus / f"{split}.txt", n=n, seed=len(split))
    dest = str(tmp_path / "bin")
    preprocess.cli_main(["--trainpref", str(corpus / "train.txt"),
                         "--validpref", str(corpus / "valid.txt"),
                         "--testpref", str(corpus / "test.txt"), "--destdir", dest])
    return dest


@functools.lru_cache(maxsize=None)
def _jax_lm_params():
    model = jax_train_lm.build_model(jax_train_lm.parse_args(LM_ARGV), LM_VOCAB)
    dummy = jnp.zeros((1, 16), jnp.int32)
    return jax.jit(lambda: model.init(jax.random.PRNGKey(0), dummy))()


def test_validate_lm_matches_jax(tmp_path, capsys):
    dest = _lm_data(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt).save(2, {"step": 2, "params": lm_state_dict_from_jax(
        _jax_lm_params())})
    argv = ["--task", "lm"] + LM_ARGV + ["--data", dest, "--eval-max-batch", "3"]
    ref = jax_validate.cli_main(argv)
    capsys.readouterr()
    with exact_float32():
        got = validate.cli_main(argv + ["--checkpoint", ckpt, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "| loaded checkpoint step 2" in out and _last_json(out) == got
    assert got["tokens"] == ref["tokens"] > 0
    for key in ("nll_loss_base_e", "loss_base_2", "ppl"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, err_msg=key)


def _write_pairs(prefix, n, seed):
    """``test_e2e_language.py``'s reversal task, 2-5 words a line."""
    rng = np.random.default_rng(seed)
    with open(f"{prefix}.src", "w") as fs, open(f"{prefix}.tgt", "w") as ft:
        for _ in range(n):
            src = [WORDS[i] for i in rng.integers(0, len(WORDS), int(rng.integers(2, 6)))]
            fs.write(" ".join(src) + "\n")
            ft.write(" ".join(reversed(src)) + "\n")


def _mt_data(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for seed, (split, n) in enumerate((("train", 40), ("valid", 20), ("test", 10))):
        _write_pairs(str(corpus / split), n, seed)
    dest = str(tmp_path / "bin")
    preprocess.cli_main([
        "--trainpref", str(corpus / "train"), "--validpref", str(corpus / "valid"),
        "--testpref", str(corpus / "test"), "--destdir", dest,
        "-s", "src", "-t", "tgt", "--joined-dictionary"])
    return dest


def _mt_checkpoints(tmp_path, dest):
    """The same perturbed ``PRNGKey(0)`` parameters written by both
    managers; returns (JAX dir, port dir)."""
    jargs = jax_train_mt.parse_args(["--data", dest, "-s", "src", "-t", "tgt"] + MT_ARGV)
    _, _, sd, td = jax_train_mt.load_pairs(jargs)
    model = jax_train_mt.build_model(jargs, len(sd), len(td))
    dummy = jnp.zeros((1, 16), jnp.int32)
    base = jax.device_get(jax.jit(lambda: model.init(jax.random.PRNGKey(0), dummy,
                                                     dummy))())
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(x.dtype), base)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jmgr = jax_checkpoint.CheckpointManager(jdir, keep_last=3, async_save=False)
    jmgr.save(4, {"params": params})
    jmgr.wait()
    CheckpointManager(tdir).save(4, {"step": 4, "params": mt_state_dict_from_jax(params)})
    return jdir, tdir


@pytest.mark.parametrize("size", [40, 20], ids=["all", "first20"])
def test_validate_mt_matches_jax(tmp_path, capsys, size):
    """``--task mt --valid-subset train`` against JAX's ``--task mt`` from
    the same checkpoint, over every train pair (3 batches of 16, the last
    partial) and over the first 20."""
    dest = _mt_data(tmp_path)
    jdir, tdir = _mt_checkpoints(tmp_path, dest)
    argv = (["--task", "mt", "--data", dest, "-s", "src", "-t", "tgt"] + MT_ARGV
            + ["--valid-subset-size", str(size)])
    ref = jax_validate.cli_main(argv + ["--path", jdir])
    capsys.readouterr()
    with exact_float32():
        got = validate.cli_main(argv + ["--path", tdir, "--valid-subset", "train",
                                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert _last_json(out) == got and set(got) == set(ref)
    assert got["tokens"] == ref["tokens"] > 0
    for key in ("valid_loss", "valid_nll", "valid_ppl"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, err_msg=key)


def test_validate_reads_the_valid_split_by_default(tmp_path, capsys):
    """fairseq's ``--valid-subset`` defaults to ``valid`` and the port
    scores that split (JAX's CLI scores the train split): the default
    run's token count is the valid split's, and it equals an explicit
    ``--valid-subset valid``, not ``train``."""
    from efficient_attention_torch.cli import train_mt

    dest = _mt_data(tmp_path)
    _, tdir = _mt_checkpoints(tmp_path, dest)
    argv = (["--task", "mt", "--data", dest, "-s", "src", "-t", "tgt"] + MT_ARGV
            + ["--path", tdir, "--device", "cpu", "--valid-subset-size", "100"])
    with exact_float32():
        default = validate.cli_main(argv)
        valid = validate.cli_main(argv + ["--valid-subset", "valid"])
        train = validate.cli_main(argv + ["--valid-subset", "train"])
    args = train_mt.parse_args(["--data", dest, "-s", "src", "-t", "tgt"])
    _, tgt_valid, _, _ = train_mt.load_pairs(args, "valid")
    assert default == valid != train
    assert default["tokens"] == sum(len(tgt_valid[i]) for i in range(len(tgt_valid)))
    assert validate.parse_mt_args(["--device", "cpu"]).valid_subset == "valid"
    assert os.path.isdir(tdir)

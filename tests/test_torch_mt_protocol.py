"""The MT protocol of the PyTorch port against the JAX package, on the CPU.

The WMT14 EN-DE recipe's steps from text to BLEU (``main.sh:87-123``):
``cli.preprocess -s -t --joined-dictionary``, ``cli.train_mt --data`` with
checkpoints, resume and warm start, ``cli.generate --path
--num-avg-checkpoints --remove-bpe --results-path`` and
``scripts/torch_compound_split_bleu.sh`` over ``cli.score``.  The models
are tiny (dim 32, 1 + 1 layers; 2 + 1 where a test prunes) with the
recipe's attention kinds: 1-D EVA in the encoder (window 8 with a halo,
8 landmarks, T5 bias, ``no-ln``) and causal EVA in the decoder (window 16,
chunk 8, ``qk``), shared embeddings.  JAX parameters come from
``model.init`` at ``PRNGKey(0)``, as JAX's ``generate`` makes them, and
cross to the port through ``interop.mt_state_dict_from_jax``.
Tolerances:

* ``load_pairs``, pruning, averaging and the gen.out text: exact;
* ``generate``'s hypotheses token for token and its BLEU line exact; the
  ``H-`` and ``P-`` scores within 1e-4;
* the pipeline keeps ``test_e2e_language.py``'s assertions (BLEU above 10
  on the reversal task); a resumed run's loss equals the straight run's
  exactly.
"""
import math
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import randomize
from efficient_attention_tpu.cli import generate as jax_generate
from efficient_attention_tpu.cli import score as jax_score
from efficient_attention_tpu.cli import train_mt as jax_train_mt
from efficient_attention_tpu.generation import SequenceGenerator as JaxSequenceGenerator
from efficient_attention_tpu.training import checkpoint as jax_checkpoint
from efficient_attention_torch.cli import generate, preprocess, score, train_mt
from efficient_attention_torch.interop import mt_state_dict_from_jax
from efficient_attention_torch.training.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["the", "cat", "sat", "on", "mat", "dog", "ran", "in", "park",
         "bird", "flew", "over", "tree"]
# subword pieces joined by --remove-bpe, and compounds that the
# compound-split script splits
BPE_WORDS = WORDS + ["sun@@", "wood@@", "well-known", "x-ray"]
ATTN = [
    "--attn-name-encoder", "eva", "--encoder-attn-window-size", "8",
    "--encoder-attn-num-landmarks", "8", "--encoder-attn-overlap-window",
    "--encoder-attn-use-t5-rpe", "--encoder-attn-adaptive-proj", "no-ln",
    "--attn-name-decoder", "causal_eva", "--decoder-attn-window-size", "16",
    "--decoder-attn-chunk-size", "8", "--decoder-attn-adaptive-proj", "qk",
    "--decoder-attn-causal", "--share-all-embeddings",
]
TINY = ["--encoder-embed-dim", "32", "--encoder-ffn-embed-dim", "64",
        "--encoder-layers", "1", "--encoder-attention-heads", "2"] + ATTN


def _write_mt_corpus(prefix, n=50, seed=0, words=WORDS):
    """``test_e2e_language.py``'s reversal task: 2-5 words a source line,
    the target the source reversed."""
    rng = np.random.default_rng(seed)
    with open(f"{prefix}.src", "w", encoding="utf-8") as fs, \
            open(f"{prefix}.tgt", "w", encoding="utf-8") as ft:
        for _ in range(n):
            k = int(rng.integers(2, 6))
            src = [words[i] for i in rng.integers(0, len(words), k)]
            fs.write(" ".join(src) + "\n")
            ft.write(" ".join(reversed(src)) + "\n")


def _binarized(tmp_path, words=WORDS, n=50, seeds=(0, 1, 2)):
    """A corpus of ``n`` pairs a split, the splits drawn from ``seeds``,
    binarized by the port's preprocess with a joined dictionary; returns
    its directory."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for seed, split in zip(seeds, ("train", "valid", "test")):
        _write_mt_corpus(str(corpus / split), n=n, seed=seed, words=words)
    dest = str(tmp_path / "bin")
    preprocess.cli_main([
        "--trainpref", str(corpus / "train"), "--validpref", str(corpus / "valid"),
        "--testpref", str(corpus / "test"), "--destdir", dest,
        "-s", "src", "-t", "tgt", "--joined-dictionary"])
    return dest


# ---- data


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_load_pairs_matches_jax(tmp_path, split):
    """``load_pairs`` over ``--data`` reads what JAX's reads: every
    sentence of both sides and the dictionaries' sizes; the model's
    vocabularies are the dictionaries'."""
    dest = _binarized(tmp_path, words=BPE_WORDS)
    argv = ["--data", dest, "-s", "src", "-t", "tgt"]
    ours = train_mt.load_pairs(train_mt.parse_args(argv), split)
    theirs = jax_train_mt.load_pairs(jax_train_mt.parse_args(argv), split)
    for a, b in zip(ours[:2], theirs[:2]):
        assert len(a) == len(b) == 50
        np.testing.assert_array_equal(a.sizes, b.sizes)
        assert all(np.array_equal(a[i], np.asarray(b[i])) for i in range(len(a)))
    assert len(ours[2]) == len(theirs[2]) and len(ours[3]) == len(theirs[3])
    assert ours[2].symbols == theirs[2].symbols
    args = train_mt.parse_args(argv + TINY)
    model = train_mt.build_model(args, *train_mt.vocab_sizes(args, *ours[2:]))
    # the specials and the words, padded to a multiple of 8 as fairseq pads
    assert model.encoder.embed_tokens.weight.shape[0] == len(ours[2]) == 24


# ---- training


def test_mt_pipeline_preprocess_train_generate(tmp_path):
    """``test_e2e_language.py``'s MT pipeline on the port: preprocess,
    80 updates on the reversal task with checkpoints and in-train BLEU,
    then ``generate`` from the newest checkpoint: BLEU far above chance on
    both (as there, every split is the same 50 pairs)."""
    dest = _binarized(tmp_path, seeds=(0, 0, 0))
    save_dir = str(tmp_path / "mt_ckpt")
    common = ["--data", dest, "-s", "src", "-t", "tgt"] + TINY + [
        "--dropout", "0.0", "--max-tokens", "256", "--max-len", "32",
        "--save-dir", save_dir, "--device", "cpu"]
    stats = train_mt.cli_main(common + [
        "--optimizer", "adam", "--lr", "5e-3", "--warmup-updates", "5",
        "--max-update", "80", "--log-interval", "40",
        "--save-interval-updates", "20", "--label-smoothing", "0.0",
        "--eval-bleu", "--eval-bleu-args", '{"beam": 2, "max_len_b": 16}',
        "--eval-bleu-subset-size", "16"])
    assert math.isfinite(stats["loss"]) and math.isfinite(stats["valid_loss"])
    assert stats["valid_bleu"] > 10.0, stats
    # the first update (none kept yet) and every 20th, the newest 10 kept
    ckpt = os.path.join(save_dir, "ckpt")
    assert CheckpointManager(ckpt).all_steps() == [1, 20, 40, 60, 80]
    result = generate.cli_main(common + [
        "--path", ckpt, "--beam", "2", "--max-len-b", "16",
        "--gen-subset-size", "16", "--gen-batch", "8"])
    assert result["sentences"] == 16
    assert result["bleu"] > 10.0, result


MT_RESUME = [
    "--dummy-data", "--dummy-vocab", "100", "--max-tokens", "128",
    "--max-len", "16", "--dropout", "0.1", "--optimizer", "adam",
    "--lr", "1e-3", "--warmup-updates", "2", "--log-interval", "10",
    "--label-smoothing", "0.1", "--seed", "3", "--device", "cpu",
] + TINY


@pytest.mark.parametrize("extra", [[], ["--store-ema", "--ema-decay", "0.9",
                                        "--update-freq", "2"]],
                         ids=["adam", "ema-accum"])
def test_mt_resume_is_bit_stable(tmp_path, extra):
    """``test_e2e_language.py``'s MT reproducibility test on the port: 16
    updates straight and 8 + resume + 8 at dropout 0.1 land on the same
    loss exactly (the optimizer, EMA and generator restored, the epochs
    and batches replayed from the seed)."""
    common = MT_RESUME + ["--save-interval-updates", "8"] + extra
    straight = train_mt.cli_main(common + ["--max-update", "16",
                                           "--save-dir", str(tmp_path / "a")])
    first = train_mt.cli_main(common + ["--max-update", "8",
                                        "--save-dir", str(tmp_path / "b")])
    assert first["step"] == 8
    resumed = train_mt.cli_main(common + ["--max-update", "16",
                                          "--save-dir", str(tmp_path / "b")])
    assert resumed["step"] == 16 and straight["step"] == 16
    assert resumed["loss"] == straight["loss"], (straight, resumed)
    assert resumed["valid_loss"] == straight["valid_loss"]


def test_mt_max_epoch_counts_total_epochs_across_resume(tmp_path):
    """``--max-epoch`` counts the whole run's epochs: a run resumed after
    one epoch stops where a straight 2-epoch run stops."""
    common = MT_RESUME + ["--dropout", "0.0", "--save-interval-updates", "1",
                          "--max-update", "10000", "--log-interval", "50"]
    two = train_mt.cli_main(common + ["--max-epoch", "2",
                                      "--save-dir", str(tmp_path / "a")])
    one = train_mt.cli_main(common + ["--max-epoch", "1",
                                      "--save-dir", str(tmp_path / "b")])
    assert 0 < one["step"] < two["step"]
    resumed = train_mt.cli_main(common + ["--max-epoch", "2",
                                          "--save-dir", str(tmp_path / "b")])
    assert resumed["step"] == two["step"], (one, resumed, two)


def test_mt_no_save_writes_nothing(tmp_path):
    """``--no-save``: no step is written, so a second run starts afresh."""
    argv = MT_RESUME + ["--max-update", "3", "--save-interval-updates", "1",
                        "--no-save", "--save-dir", str(tmp_path / "s"),
                        "--disable-validation"]
    first = train_mt.cli_main(argv)
    assert CheckpointManager(str(tmp_path / "s" / "ckpt")).all_steps() == []
    assert train_mt.cli_main(argv) == first


def test_mt_finetune_from_model_prunes_as_jax(tmp_path):
    """``--finetune-from-model`` with both ``--*-layers-to-keep`` flags
    loads exactly what JAX's ``maybe_prune_for_keep`` makes of the
    full-depth parameters (drawn with numpy; read back from the first checkpoint of a run at
    lr 0), and refuses a ``--save-dir`` that holds a checkpoint."""
    full = ["--encoder-layers", "3", "--decoder-layers", "2"]
    jargs = jax_train_mt.parse_args([a for a in MT_RESUME + full
                                     if a not in ("--device", "cpu")])
    jmodel = jax_train_mt.build_model(jargs, 100, 100)
    dummy = jnp.zeros((1, 16), jnp.int32)
    params = randomize(jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), dummy, dummy)), 4)
    CheckpointManager(str(tmp_path / "full")).save(
        4, {"step": 4, "params": mt_state_dict_from_jax(params)})
    want = params
    for spec, scope in (([0, 2], "encoder"), ([1], "decoder")):
        want = jax_checkpoint.maybe_prune_for_keep(want, spec, scope)
    want = mt_state_dict_from_jax(want)

    argv = MT_RESUME + full + [
        "--encoder-layers-to-keep", "0,2", "--decoder-layers-to-keep", "1",
        "--finetune-from-model", str(tmp_path / "full"), "--lr", "0",
        "--warmup-init-lr", "0", "--max-update", "1", "--disable-validation",
        "--save-dir", str(tmp_path / "ft")]
    stats = train_mt.cli_main(argv)
    assert stats["step"] == 1 and math.isfinite(stats["loss"])
    step, got = CheckpointManager(str(tmp_path / "ft" / "ckpt")).restore_params()
    assert step == 1 and got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="resuming"):
        train_mt.cli_main(argv)


# ---- generation


GEN = ["-s", "src", "-t", "tgt"] + TINY + [
    "--encoder-layers", "2", "--decoder-layers", "1", "--dropout", "0.0",
    "--beam", "3", "--max-len-b", "10", "--gen-subset-size", "12",
    "--gen-batch", "12", "--remove-bpe", "--nbest", "2",
    "--num-avg-checkpoints", "3"]


def _gen_out(path):
    with open(path, encoding="utf-8") as f:
        return f.read().splitlines()


@pytest.mark.parametrize("extra", [[], ["--encoder-layers-to-keep", "1"],
                                   ["--score-reference"]],
                         ids=["avg3", "keep-enc1", "score-reference"])
def test_generate_matches_jax(tmp_path, extra):
    """``generate --path --num-avg-checkpoints 3 --remove-bpe --nbest 2
    --results-path --gen-subset train`` on both packages from the same
    three checkpoints (``PRNGKey(0)`` parameters and two seeded
    perturbations of them, written by each package's manager): the
    averaged parameters bit for bit, the hypotheses token for token, the
    BLEU line, and gen.out line for line (its scores within 1e-4)."""
    dest = _binarized(tmp_path, words=BPE_WORDS, n=12)
    jargv = ["--data", dest] + GEN + extra
    jargs = jax_generate.parse_args(jargv + ["--path", str(tmp_path / "j"),
                                             "--results-path", str(tmp_path / "j.out")])
    _, _, sd, td = jax_train_mt.load_pairs(jargs)
    # the full-depth model's parameters, whatever the run keeps
    jmodel = jax_train_mt.build_model(jax_generate.parse_args(["--data", dest] + GEN),
                                      len(sd), len(td))
    dummy = jnp.zeros((1, 16), jnp.int32)
    base = jax.device_get(jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), dummy, dummy))())
    jmgr = jax_checkpoint.CheckpointManager(str(tmp_path / "j"), keep_last=3,
                                            async_save=False)
    tmgr = CheckpointManager(str(tmp_path / "t"), keep_last=3)
    saved = []
    for step in (1, 2, 3):
        rng = np.random.default_rng(step)
        p = base if step == 1 else jax.tree_util.tree_map(
            lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(x.dtype), base)
        saved.append(p)
        jmgr.save(step, {"params": p})
        tmgr.save(step, {"step": step, "params": mt_state_dict_from_jax(p)})
    jmgr.wait()

    recorded = []

    class Recorder(JaxSequenceGenerator):
        def generate(self, *a, **kw):
            tokens, scores = super().generate(*a, **kw)
            recorded.append(np.asarray(tokens))
            return tokens, scores

    with mock.patch("efficient_attention_tpu.generation.SequenceGenerator", Recorder):
        want = jax_generate.main(jargs)
    got = generate.main(generate.parse_args(
        jargv + ["--gen-subset", "train", "--device", "cpu",
                 "--path", str(tmp_path / "t"), "--results-path", str(tmp_path / "t.out")]))

    average = jax_checkpoint.average_checkpoints(saved)
    if extra[:1] == ["--encoder-layers-to-keep"]:
        average = jax_checkpoint.prune_layer_params(average, [1], "encoder")
    average = mt_state_dict_from_jax(average)
    assert got["params"].keys() == average.keys()
    for k in average:
        assert torch.equal(got["params"][k], average[k]), k
    # JAX's 1-best hypotheses, cut after their first eos (no beam search
    # under --score-reference)
    jhyps = []
    for tokens in recorded:
        for row in tokens[:, 0, 1:]:
            eos = np.where(row == 2)[0]
            jhyps.append((row[: eos[0] + 1] if len(eos) else row).tolist())
    if extra[:1] != ["--score-reference"]:
        assert got["hypotheses"] == jhyps and len(jhyps) == 12
    assert got["sentences"] == want["sentences"] == 12
    assert got["detail"] == want["detail"]
    ours, theirs = _gen_out(tmp_path / "t.out"), _gen_out(tmp_path / "j.out")
    assert len(ours) == len(theirs) and ours[-1] == theirs[-1]
    assert ours[-1].startswith("Generate test with beam=3: BLEU4 = ")
    for a, b in zip(ours, theirs):
        (tag, *fa), (tag_b, *fb) = a.split("\t"), b.split("\t")
        assert tag == tag_b
        if tag.startswith("H-"):  # score, hypothesis
            assert fa[1] == fb[1] and abs(float(fa[0]) - float(fb[0])) <= 1e-4, (a, b)
        elif tag.startswith("P-"):  # a score a reference token
            np.testing.assert_allclose([float(x) for x in fa[0].split()],
                                       [float(x) for x in fb[0].split()],
                                       rtol=0, atol=1e-4)
        else:
            assert a == b
    if extra[:1] == ["--score-reference"]:
        assert sum(line.startswith("P-") for line in ours) == 12
    else:
        assert sum(line.startswith("H-") for line in ours) == 24
        assert not any("@@" in line for line in ours if line.startswith("H-"))


def test_generate_translates_the_test_split_by_default(tmp_path):
    """fairseq's ``--gen-subset`` defaults to ``test``, and ``generate
    --data`` reads it (JAX's CLI translates the train split); the
    references in gen.out are the test split's lines."""
    dest = _binarized(tmp_path)
    args = generate.parse_args(["--data", dest] + GEN + [
        "--device", "cpu", "--num-avg-checkpoints", "1",
        "--results-path", str(tmp_path / "gen.out")])
    assert args.gen_subset == "test"
    result = generate.main(args)
    assert result["params"] is None and result["sentences"] == 12
    with open(tmp_path / "corpus" / "test.tgt", encoding="utf-8") as f:
        refs = f.read().splitlines()[:12]
    got = [line.split("\t", 1)[1] for line in _gen_out(tmp_path / "gen.out")
           if line.startswith("T-")]
    assert got == refs
    with open(tmp_path / "corpus" / "train.tgt", encoding="utf-8") as f:
        assert got != f.read().splitlines()[:12]


GEN_PORTED = [[], ["--remove-bpe"], ["--nbest", "2"], ["--score-reference"],
              ["--num-avg-checkpoints", "3"], ["--gen-subset", "valid"],
              ["--results-path", "gen.out"], ["--path", "ckpt"]]
GEN_QUEUED = [["--lm-path", "lm"], ["--sampling"], ["--diverse-beam-groups", "2"],
              ["--diversity-rate", "0.5"], ["--prefix-size", "1"],
              ["--constraints"], ["--no-repeat-ngram-size", "2"],
              ["--print-alignment"], ["--scoring", "chrf"], ["--bpe", "gpt2"],
              ["--tokenizer", "moses"]]


@pytest.mark.parametrize("extra", GEN_PORTED + GEN_QUEUED,
                         ids=[" ".join(e) or "none" for e in GEN_PORTED + GEN_QUEUED])
def test_generate_check_ported(extra):
    """The ported flags pass ``check_ported``; each flag still queued raises
    ``NotImplementedError`` naming its ROADMAP.md item."""
    args = generate.parse_args(["--dummy-data", "--device", "cpu"] + extra)
    if extra in GEN_QUEUED:
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, item 6"):
            generate.check_ported(args)
    else:
        generate.check_ported(args)


# ---- scoring


@pytest.mark.parametrize("order", [4, 2])
def test_score_matches_jax(tmp_path, capsys, order):
    """``cli.score`` prints JAX's line and returns its BLEU; both stop on
    files whose line counts differ; ``--metric chrf`` is queued."""
    rng = np.random.default_rng(order)
    hyps = [" ".join(rng.choice(BPE_WORDS, int(rng.integers(1, 9)))) for _ in range(20)]
    refs = [" ".join(rng.choice(BPE_WORDS, int(rng.integers(1, 9)))) for _ in range(20)]
    refs[:10] = hyps[:10]
    (tmp_path / "sys").write_text("\n".join(hyps) + "\n")
    (tmp_path / "ref").write_text("\n".join(refs) + "\n")
    argv = ["--sys", str(tmp_path / "sys"), "--ref", str(tmp_path / "ref"),
            "--order", str(order)]
    ours = score.cli_main(argv)
    line = capsys.readouterr().out
    assert ours == jax_score.cli_main(argv) and 0 < ours < 100
    assert line == capsys.readouterr().out
    (tmp_path / "short").write_text("\n".join(refs[:-1]) + "\n")
    short = ["--sys", str(tmp_path / "sys"), "--ref", str(tmp_path / "short")]
    with pytest.raises(SystemExit) as ours_exit:
        score.cli_main(short)
    with pytest.raises(SystemExit) as theirs_exit:
        jax_score.cli_main(short)
    assert str(ours_exit.value) == str(theirs_exit.value)
    with pytest.raises(NotImplementedError, match="Queue 1, item 6"):
        score.cli_main(argv + ["--metric", "chrf"])


def test_compound_split_script_matches_jax(tmp_path):
    """``scripts/torch_compound_split_bleu.sh`` prints what
    ``scripts/compound_split_bleu.sh`` prints on one gen.out, and writes
    the same compound-split files; both wait for the BLEU line."""
    lines = []
    rng = np.random.default_rng(0)
    for j in range(15):
        ref = " ".join(rng.choice(BPE_WORDS[:-4] + ["well-known", "x-ray"], 6))
        hyp = ref if j % 3 else " ".join(rng.choice(BPE_WORDS, 5))
        lines += [f"S-{j}\tsrc", f"T-{j}\t{ref}", f"H-{j}\t-0.5000\t{hyp}"]
    lines.append("Generate test with beam=4: BLEU4 = 1.00, 1/1/1/1 (BP=1.000)")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable) + os.pathsep
               + os.environ.get("PATH", ""))
    out = {}
    for name, script in (("torch", "torch_compound_split_bleu.sh"),
                         ("jax", "compound_split_bleu.sh")):
        gen = tmp_path / f"{name}.out"
        gen.write_text("\n".join(lines) + "\n")
        res = subprocess.run(["bash", os.path.join(REPO, "scripts", script), str(gen)],
                             cwd=REPO, env=env, capture_output=True, text=True,
                             check=True)
        out[name] = (res.stdout, (tmp_path / f"{name}.out.sys").read_text(),
                     (tmp_path / f"{name}.out.ref").read_text())
    assert out["torch"] == out["jax"]
    assert out["torch"][0].startswith("BLEU4 = ")
    assert "##AT##-##AT##" in out["torch"][2]
    unfinished = tmp_path / "unfinished.out"
    unfinished.write_text("\n".join(lines[:-1]) + "\n")
    res = subprocess.run(["bash", os.path.join(REPO, "scripts",
                                               "torch_compound_split_bleu.sh"),
                          str(unfinished)], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    assert res.stdout.strip() == "not done generating"

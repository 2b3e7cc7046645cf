"""The LM protocol's checkpoints and evaluation in the PyTorch port against
the JAX package, on the CPU.

A 2-layer LM of dim 32 with causal EVA (window 8, chunk 4, ``qk``, T5 bias),
with the full softmax (``cross_entropy``) or the wiki103 head (adaptive
input, tied adaptive softmax).  JAX parameters come from ``model.init``
at ``PRNGKey(0)``, as JAX's ``eval_lm`` makes them, and cross to the port
through ``interop.lm_state_dict_from_jax``.  Tolerances:

* the eval step's NLL sums 1e-5 relative, its token count exact; the
  per-token NLL 1e-4 absolute, its mask exact;
* ``eval_lm``'s JSON fields 1e-5 relative, ``tokens`` exact; the
  ``--output-word-probs`` and ``--output-word-stats`` values 1e-3;
* the checkpoint manager's kept steps, layer pruning and averaging: exact
  (the orbax manager with synchronous writes; bit for bit);
* the pipeline tests keep ``test_e2e_language.py``'s assertions; a resumed
  run's loss equals the straight run's exactly.
"""
import functools
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32, randomize
from efficient_attention_torch.cli import eval_lm, preprocess, train_lm
from efficient_attention_torch.data.dictionary import Dictionary
from efficient_attention_torch.data.lm_context_window import context_window_blocks
from efficient_attention_torch.interop import lm_state_dict_from_jax
from efficient_attention_torch.training import lm_steps
from efficient_attention_torch.training.checkpoint import (
    CheckpointManager,
    average_checkpoints,
    maybe_prune_for_keep,
    prune_layer_params,
)
from efficient_attention_tpu.cli import eval_lm as jax_eval_lm
from efficient_attention_tpu.cli import train_lm as jax_train_lm
from efficient_attention_tpu.training import checkpoint as jax_checkpoint
from efficient_attention_tpu.training import lm_steps as jax_lm_steps

from test_e2e_language import _write_lm_corpus

VOCAB = 24  # the vocabulary of test_e2e_language.py's corpus, padded to 8
MODEL_ARGV = [
    "--attn-name-decoder", "causal_eva", "--decoder-attn-window-size", "8",
    "--decoder-attn-chunk-size", "4", "--decoder-attn-adaptive-proj", "qk",
    "--decoder-attn-use-t5-rpe", "--decoder-attn-causal",
    "--decoder-embed-dim", "32", "--decoder-ffn-embed-dim", "64",
    "--decoder-layers", "2", "--decoder-attention-heads", "2",
    "--tokens-per-sample", "16", "--max-tokens", "64", "--dropout", "0",
    "--max-len", "64",
]
CRITERIA = {
    "cross_entropy": ["--criterion", "cross_entropy"],
    "adaptive_loss": ["--criterion", "adaptive_loss", "--adaptive-cutoffs", "8,16",
                      "--adaptive-input", "--tie-adaptive-weights",
                      "--no-decoder-final-norm"],
}


@functools.lru_cache(maxsize=None)
def _jax_model_and_params(criterion, layers=2):
    """JAX's model and its parameters as JAX's ``eval_lm`` initialises
    them (``PRNGKey(0)``, jitted); made once a configuration, for each
    compile takes seconds."""
    argv = MODEL_ARGV + CRITERIA[criterion] + ["--decoder-layers", str(layers)]
    model = jax_train_lm.build_model(jax_train_lm.parse_args(argv), VOCAB)
    dummy = jnp.zeros((1, 16), jnp.int32)
    return model, jax.jit(lambda: model.init(jax.random.PRNGKey(0), dummy))()


def _port_model(argv, vocab, params):
    model = train_lm.build_model(train_lm.parse_args(argv + ["--device", "cpu"]), vocab)
    model.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return model.eval()


def _eval_blocks(n=150, window=8, seed=0):
    """Eval blocks of 17 tokens with a padded tail: inputs, targets and the
    score mask."""
    tokens = np.random.default_rng(seed).integers(4, VOCAB, n).astype(np.int64)
    blocks = list(context_window_blocks(tokens, 17, window, pad_idx=1))
    a = np.stack([b for b, _ in blocks])
    m = np.stack([s for _, s in blocks])
    return a[:, :-1], a[:, 1:], m[:, 1:]


@pytest.mark.parametrize("softmax_chunk", [None, 5], ids=["whole", "chunk5"])
@pytest.mark.parametrize("criterion", sorted(CRITERIA))
def test_eval_and_token_steps_match_jax(criterion, softmax_chunk):
    """``make_lm_eval_step`` and ``make_lm_token_nll_step`` on the same
    blocks and parameters: NLL sums 1e-5 rel, per-token NLL 1e-4 abs.  A
    chunk of 5 tokens is smaller than a block (16) and no divisor of
    B*T."""
    jm, params = _jax_model_and_params(criterion)
    tm = _port_model(MODEL_ARGV + CRITERIA[criterion], VOCAB, params)
    tok, tgt, sm = _eval_blocks()
    assert (tok.shape[0] * tok.shape[1]) % 5 and (tgt == 1).any()
    adaptive = criterion == "adaptive_loss"
    j_eval = jax.jit(jax_lm_steps.make_lm_eval_step(adaptive, softmax_chunk=softmax_chunk),
                     static_argnums=(1,))
    j_tok = jax.jit(jax_lm_steps.make_lm_token_nll_step(adaptive,
                                                        softmax_chunk=softmax_chunk),
                    static_argnums=(1,))
    jargs = (params, jm.apply, jnp.asarray(tok), jnp.asarray(tgt), jnp.asarray(sm))
    j_sum, j_n = (float(x) for x in j_eval(*jargs))
    j_nll, j_mask = (np.asarray(x) for x in j_tok(*jargs))
    targs = (tm, torch.from_numpy(tok), torch.from_numpy(tgt), torch.from_numpy(sm))
    with exact_float32():
        t_sum, t_n = lm_steps.make_lm_eval_step(adaptive, softmax_chunk=softmax_chunk)(*targs)
        t_nll, t_mask = lm_steps.make_lm_token_nll_step(
            adaptive, softmax_chunk=softmax_chunk)(*targs)
    assert float(t_n) == j_n and j_n < tok.size
    np.testing.assert_allclose(float(t_sum), j_sum, rtol=1e-5)
    np.testing.assert_array_equal(t_mask.numpy(), j_mask)
    np.testing.assert_allclose(t_nll.numpy(), j_nll, atol=1e-4, rtol=0)


def _make_data(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for split, n in (("train", 50), ("valid", 20), ("test", 30)):
        _write_lm_corpus(corpus / f"{split}.txt", n=n, seed=len(split))
    dest = str(tmp_path / "bin")
    preprocess.cli_main(["--trainpref", str(corpus / "train.txt"),
                         "--validpref", str(corpus / "valid.txt"),
                         "--testpref", str(corpus / "test.txt"), "--destdir", dest])
    return dest


def _word_lines(out):
    """``W-`` lines as {sample: [(word, log-prob)]}; WordStat lines as
    {word: (count, mean log-prob)}."""
    probs, stats = {}, {}
    for line in out.splitlines():
        if line.startswith("W-"):
            head, body = line.split("\t", 1)
            probs[head] = [(w, float(lp)) for w, lp in
                           re.findall(r"(\S+) \[(-?[\d.]+)\]", body)]
        m = re.fullmatch(r"(\S+) \| count (\d+) \| avg_log_prob (-?[\d.]+)", line)
        if m:
            stats[m.group(1)] = (int(m.group(2)), float(m.group(3)))
    return probs, stats


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("criterion", sorted(CRITERIA))
def test_eval_lm_main_matches_jax(tmp_path, capsys, criterion, window):
    """``eval_lm`` of the port, reading JAX's initial parameters from its
    own ``CheckpointManager``, against JAX's ``eval_lm`` without
    ``--checkpoint`` (which initialises the same parameters), on a
    binarized test split in batches of 3 blocks; the full softmax with
    ``--softmax-batch 20``."""
    dest = _make_data(tmp_path)
    assert len(Dictionary.load(os.path.join(dest, "dict.txt"))) == VOCAB
    argv = (MODEL_ARGV + CRITERIA[criterion] + [
        "--data", dest, "--split", "test", "--eval-max-batch", "3",
        "--context-window", str(window), "--output-word-probs",
        "--output-word-stats"]
        + (["--softmax-batch", "20"] if criterion == "cross_entropy" else []))
    _, params = _jax_model_and_params(criterion)
    ckpt = str(tmp_path / "ckpt")
    assert CheckpointManager(ckpt).save(3, {"step": 3,
                                            "params": lm_state_dict_from_jax(params)})
    capsys.readouterr()
    ref = jax_eval_lm.cli_main(argv)
    ref_words = _word_lines(capsys.readouterr().out)
    with exact_float32():
        got = eval_lm.cli_main(argv + ["--checkpoint", ckpt, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "| loaded checkpoint step 3" in out
    got_words = _word_lines(out)
    assert got["tokens"] == ref["tokens"] and got["context_window"] == window
    for key in ("nll_loss_base_e", "loss_base_2", "ppl"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, err_msg=key)
    assert json_last_line(out) == got
    for ours, theirs in zip(got_words, ref_words):
        assert ours.keys() == theirs.keys() and ours
    for sample, words in ref_words[0].items():
        assert [w for w, _ in got_words[0][sample]] == [w for w, _ in words]
        np.testing.assert_allclose([lp for _, lp in got_words[0][sample]],
                                   [lp for _, lp in words], atol=1e-3)
    for word, (cnt, mean) in ref_words[1].items():
        assert got_words[1][word][0] == cnt
        np.testing.assert_allclose(got_words[1][word][1], mean, atol=1e-3)


def json_last_line(out):
    import json

    return json.loads(out.strip().splitlines()[-1])


def _metrics(kind, step):
    """Deterministic metrics with ties, and none at every fourth step."""
    if kind is None or step % 4 == 0:
        return None
    return {kind: float((step * 7) % 5), "other": float(step)}


@pytest.mark.parametrize("kw,kind", [
    (dict(keep_last=2, save_interval_steps=3), None),
    (dict(keep_last=3, save_interval_steps=1), None),
    (dict(keep_last=1, save_interval_steps=4), None),
    (dict(keep_last=2, save_interval_steps=2, best_fn="valid_loss"), "valid_loss"),
    (dict(keep_last=2, save_interval_steps=1, best_fn="acc"), "acc"),
    (dict(keep_last=3, save_interval_steps=1, best_fn="bleu", best_mode="min"), "bleu"),
], ids=["interval3", "keep3", "keep1", "best-loss", "best-acc", "best-forced-min"])
def test_checkpoint_manager_keeps_the_steps_orbax_keeps(tmp_path, kw, kind):
    """One sequence of saves (steps 1-10, an older step again, then a new
    manager on the same directory for steps 11-13) through the port's
    manager and JAX's orbax manager with synchronous writes: the same steps
    kept after every save."""
    port = CheckpointManager(str(tmp_path / "port"), **kw)
    ref = jax_checkpoint.CheckpointManager(str(tmp_path / "jax"), async_save=False, **kw)
    state = {"w": np.zeros(2, np.float32)}
    for step in list(range(1, 11)) + [5, "reopen", 11, 12, 13]:
        if step == "reopen":
            ref.close()
            port = CheckpointManager(str(tmp_path / "port"), **kw)
            ref = jax_checkpoint.CheckpointManager(str(tmp_path / "jax"),
                                                   async_save=False, **kw)
            continue
        port.save(step, {"step": step, "params": {"w": torch.zeros(2)}},
                  _metrics(kind, step))
        ref.save(step, state, _metrics(kind, step))
        assert port.all_steps() == sorted(ref.manager.all_steps()), step
        assert port.latest_step() == ref.latest_step()
    ref.close()
    assert port.restore_params()[0] == port.latest_step()


def test_checkpoint_manager_round_trip_and_best_mode(tmp_path):
    """A state survives ``save`` and ``load`` exactly (tensors, numbers,
    None, nesting), ``restore`` fills a target through ``load_state_dict``,
    the metric's name sets the mode as in JAX, and nothing is kept under a
    temporary name."""
    for name in ("valid_loss", "ppl", "NLL", "wer", "bleu", "acc"):
        assert (CheckpointManager(str(tmp_path / name), best_fn=name).best_mode
                == ("max" if name in ("bleu", "acc") else "min"))
    mgr = CheckpointManager(str(tmp_path / "rt"), keep_last=2)
    assert mgr.latest_step() is None and mgr.restore() is None
    state = {"step": 7, "params": {"a.weight": torch.randn(3, 4)},
             "opt_state": {"count": 7, "lr_old": None, "bufs": [torch.randn(5)]},
             "rng": {"generator": torch.Generator().manual_seed(3).get_state()}}
    assert mgr.save(7, state, {"valid_loss": 1.5}) and not mgr.save(7, state)
    assert sorted(os.listdir(mgr.directory)) == ["7"]
    assert sorted(os.listdir(os.path.join(mgr.directory, "7"))) == ["metrics.json",
                                                                   "state.pt"]
    back = mgr.load()
    assert back["step"] == 7 and back["opt_state"]["lr_old"] is None
    assert torch.equal(back["params"]["a.weight"], state["params"]["a.weight"])
    assert torch.equal(back["rng"]["generator"], state["rng"]["generator"])

    class Target:
        def load_state_dict(self, sd):
            self.sd = sd

    assert mgr.restore(Target()).sd["step"] == 7
    step, params = mgr.restore_params()
    assert step == 7 and torch.equal(params["a.weight"], state["params"]["a.weight"])


def _jax_lm_params(seed):
    """A 3-layer wiki103-headed LM's flax parameters, redrawn from
    ``seed``."""
    return randomize(_jax_model_and_params("adaptive_loss", layers=3)[1], seed)


@pytest.mark.parametrize("keep", [[0, 2], [1], [2, 0], [0, 1, 2]])
def test_prune_layer_params_matches_jax(keep):
    """``prune_layer_params`` and ``maybe_prune_for_keep`` on the port's
    state dict of a 3-layer LM equal JAX's on its flax tree, converted, bit
    for bit; a checkpoint at the kept depth passes ``maybe_prune_for_keep``
    unchanged, and a layer the checkpoint lacks raises."""
    params = _jax_lm_params(0)
    sd = lm_state_dict_from_jax(params)
    for ours, theirs in (
            (prune_layer_params(sd, keep, "decoder"),
             jax_checkpoint.prune_layer_params(params, keep, "decoder")),
            (maybe_prune_for_keep(sd, keep, "decoder"),
             jax_checkpoint.maybe_prune_for_keep(params, keep, "decoder"))):
        ref = lm_state_dict_from_jax(theirs)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert torch.equal(ours[k], ref[k]), k
    pruned = prune_layer_params(sd, keep, "decoder")
    n_layers = len({k.split(".")[2] for k in pruned if k.startswith("decoder.layers.")})
    assert n_layers == len(keep)
    assert maybe_prune_for_keep(pruned, list(range(len(keep))), "decoder") is pruned
    with pytest.raises(ValueError, match="layer 3"):
        prune_layer_params(sd, [3], "decoder")


def test_average_checkpoints_matches_jax():
    """The average of three state dicts equals JAX's average of the three
    flax trees, converted, bit for bit."""
    trees = [_jax_lm_params(seed) for seed in (1, 2, 3)]
    ours = average_checkpoints([lm_state_dict_from_jax(t) for t in trees])
    ref = lm_state_dict_from_jax(jax_checkpoint.average_checkpoints(trees))
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and torch.equal(ours[k], ref[k]), k
    mixed = average_checkpoints([{"step": 1, "w": torch.ones(2, dtype=torch.bfloat16)},
                                 {"step": 2, "w": torch.zeros(2, dtype=torch.bfloat16)}])
    assert mixed["step"] == 1 and mixed["w"].dtype == torch.bfloat16
    assert torch.equal(mixed["w"], torch.full((2,), 0.5, dtype=torch.bfloat16))


def test_lm_pipeline_preprocess_train_eval(tmp_path):
    """``test_e2e_language.py``'s pipeline on the port: preprocess, train 60
    updates on the binarized corpus with checkpoints, then ``eval_lm`` from
    the checkpoint at context window 8."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for split in ("train", "valid", "test"):
        _write_lm_corpus(corpus / f"{split}.txt", n=50)
    dest = str(tmp_path / "bin")
    preprocess.cli_main([
        "--trainpref", str(corpus / "train.txt"),
        "--validpref", str(corpus / "valid.txt"),
        "--testpref", str(corpus / "test.txt"), "--destdir", dest])
    assert os.path.exists(os.path.join(dest, "dict.txt"))
    assert os.path.exists(os.path.join(dest, "train.bin"))
    save_dir = str(tmp_path / "lm_ckpt")
    common = [
        "--data", dest, "--tokens-per-sample", "16", "--max-tokens", "128",
        "--decoder-embed-dim", "32", "--decoder-ffn-embed-dim", "64",
        "--decoder-layers", "1", "--decoder-attention-heads", "2",
        "--criterion", "cross_entropy", "--dropout", "0.0",
        "--max-len", "64", "--save-dir", save_dir, "--device", "cpu",
    ]
    stats = train_lm.cli_main(common + [
        "--optimizer", "adamw", "--lr", "5e-3",
        "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "5",
        "--max-update", "60", "--log-interval", "20",
        "--save-interval-updates", "20"])
    assert stats["step"] == 60
    assert stats["ppl"] < 8.0, stats
    assert stats["valid_ppl"] < 10.0, stats
    # the first update (none kept yet) and every 20th, the newest 3 kept
    assert CheckpointManager(os.path.join(save_dir, "ckpt")).all_steps() == [20, 40, 60]
    result = eval_lm.cli_main(common + [
        "--optimizer", "adamw", "--lr-scheduler", "inverse_sqrt",
        "--max-update", "60", "--checkpoint", os.path.join(save_dir, "ckpt"),
        "--context-window", "8", "--split", "test"])
    assert math.isfinite(result["ppl"])
    assert result["ppl"] < 10.0, result


@pytest.mark.parametrize("extra", [
    ["--optimizer", "adam", "--lr", "1e-3"],
    ["--optimizer", "nag", "--lr", "0.05", "--store-ema", "--ema-decay", "0.9"],
    ["--optimizer", "adamw", "--lr", "1e-3", "--criterion", "adaptive_loss",
     "--adaptive-cutoffs", "50,120", "--adaptive-input", "--tie-adaptive-weights"],
], ids=["adam", "nag-ema", "adamw-adaptive"])
def test_lm_resume_is_bit_stable(tmp_path, extra):
    """``test_e2e_language.py``'s reproducibility test on the port: 20
    updates straight and 10 + resume + 10 at dropout 0.1 land on the same
    loss exactly (the optimizer, EMA and generator restored, the batch
    order replayed from the seed)."""
    common = [
        "--dummy-data", "--dummy-vocab", "200", "--tokens-per-sample", "32",
        "--max-tokens", "128", "--decoder-embed-dim", "32",
        "--decoder-ffn-embed-dim", "64", "--decoder-layers", "1",
        "--decoder-attention-heads", "2", "--dropout", "0.1",
        "--warmup-updates", "2", "--log-interval", "10",
        "--save-interval-updates", "10", "--seed", "7", "--device", "cpu",
    ] + extra
    straight = train_lm.cli_main(common + ["--max-update", "20",
                                           "--save-dir", str(tmp_path / "a")])
    first = train_lm.cli_main(common + ["--max-update", "10",
                                        "--save-dir", str(tmp_path / "b")])
    assert first["step"] == 10
    resumed = train_lm.cli_main(common + ["--max-update", "20",
                                          "--save-dir", str(tmp_path / "b")])
    assert resumed["step"] == 20 and straight["step"] == 20
    assert resumed["loss"] == straight["loss"], (straight, resumed)
    assert resumed["valid_loss"] == straight["valid_loss"]


def test_lm_finetune_from_model_with_layers_to_keep(tmp_path):
    """``test_e2e_language.py``'s warm start on the port: a full-depth
    checkpoint pruned to ``--decoder-layers-to-keep`` before loading, and
    the conflict with a checkpoint to resume."""
    common = [
        "--dummy-data", "--dummy-vocab", "100", "--tokens-per-sample", "16",
        "--max-tokens", "64", "--decoder-embed-dim", "32",
        "--decoder-ffn-embed-dim", "64", "--decoder-attention-heads", "2",
        "--dropout", "0.0", "--optimizer", "adam", "--lr", "1e-3",
        "--warmup-updates", "2", "--log-interval", "10",
        "--save-interval-updates", "2", "--seed", "11", "--device", "cpu",
    ]
    full = train_lm.cli_main(common + [
        "--decoder-layers", "2", "--max-update", "4",
        "--save-dir", str(tmp_path / "full")])
    assert full["step"] == 4
    pruned_argv = common + [
        "--decoder-layers", "2", "--decoder-layers-to-keep", "1",
        "--finetune-from-model", str(tmp_path / "full" / "ckpt"),
        "--max-update", "2", "--save-dir", str(tmp_path / "pruned")]
    pruned = train_lm.cli_main(pruned_argv)
    assert pruned["step"] == 2 and math.isfinite(pruned["loss"])
    saved = CheckpointManager(str(tmp_path / "pruned" / "ckpt")).restore_params()[1]
    assert not any(k.startswith("decoder.layers.1.") for k in saved)
    with pytest.raises(ValueError, match="resuming"):
        train_lm.cli_main(pruned_argv)


def test_tied_adaptive_weights_stay_one_tensor_after_restore(tmp_path):
    """With ``--tie-adaptive-weights`` the adaptive softmax reads the
    adaptive input's band embeddings and projections: the checkpoint holds
    them once, and after a restore into a fresh train state the softmax
    still reads the input's own tensors, equal to the saved ones bit for
    bit."""
    from efficient_attention_torch.training.optim import make_optimizer
    from efficient_attention_torch.training.train_state import TrainState

    argv = [
        "--dummy-data", "--dummy-vocab", "200", "--tokens-per-sample", "16",
        "--max-tokens", "64", "--decoder-embed-dim", "32",
        "--decoder-ffn-embed-dim", "32", "--decoder-layers", "1",
        "--decoder-attention-heads", "2", "--criterion", "adaptive_loss",
        "--adaptive-cutoffs", "50,120", "--adaptive-input", "--tie-adaptive-weights",
        "--max-update", "3", "--save-interval-updates", "3", "--warmup-updates", "1",
        "--device", "cpu", "--save-dir", str(tmp_path), "--disable-validation"]
    train_lm.cli_main(argv)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    saved = mgr.load()
    assert saved["step"] == 3
    assert not any(".adaptive_softmax.tail" in k for k in saved["params"])
    args = train_lm.parse_args(argv)
    model = train_lm.build_model(args, 200, dense_tokens=True)
    state = TrainState(model, make_optimizer("nag", model.named_parameters(),
                                             lambda s: 0.1, weight_decay=0.0))
    mgr.restore(state)
    assert state.step == 3 and state.optimizer.count == 3
    emb = model.decoder.embed_tokens
    embs, projs = emb.band_weights()
    for i, band in enumerate(emb.embeddings):
        assert embs[i] is band[0].weight and projs[i] is band[1].weight
        assert torch.equal(band[0].weight,
                           saved["params"][f"decoder.embed_tokens.embeddings.{i}.0.weight"])
    owned = {id(p) for p in model.decoder.adaptive_softmax.parameters()}
    assert not owned & {id(p) for p in embs + projs}
    # a change to the input's tensor reaches the softmax
    toks = torch.randint(4, 200, (2, 16), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        before = model.eval()(toks[:, :-1], toks[:, 1:]).clone()
        embs[0].mul_(2.0)
        assert not torch.equal(model(toks[:, :-1], toks[:, 1:]), before)


def test_eval_lm_applies_the_arch_preset_and_config():
    """The port's ``eval_lm`` reads ``--arch`` and ``--config`` as
    ``train_lm`` does, so it builds the model ``train_lm`` trained; JAX's
    ``eval_lm`` ignores ``--arch`` and refuses ``--config`` (a fault of the
    reference CLI, ROADMAP.md Queue 3); explicit flags still win."""
    config = os.path.join(os.path.dirname(__file__), "..", "configs",
                          "wikitext103_causal_eva.yaml")
    argv = ["--arch", "transformer_lm_wiki103", "--config", config,
            "--decoder-layers", "2", "--context-window", "256"]
    ours = eval_lm.parse_args(argv)
    theirs = jax_eval_lm.parse_args(argv[:2] + argv[4:])  # JAX's has no --config
    trained = train_lm.parse_args(argv[:-2])
    for key in ("adaptive_input", "tie_adaptive_weights", "no_decoder_final_norm",
                "attn_name_decoder", "decoder_layers", "criterion"):
        assert getattr(ours, key) == getattr(trained, key), key
    assert ours.adaptive_input and ours.attn_name_decoder == "causal_eva"
    assert ours.attn_args_decoder.window_size == 128 and ours.decoder_layers == 2
    assert ours.context_window == 256
    assert not theirs.adaptive_input and theirs.attn_name_decoder == "softmax"


def test_check_ported_takes_data_and_checkpoint_flags():
    """``--data``, ``--finetune-from-model`` and ``--decoder-layers-to-keep``
    pass ``check_ported``; every flag it still names raises."""
    train_lm.check_ported(train_lm.parse_args([
        "--data", "somewhere", "--finetune-from-model", "x",
        "--decoder-layers-to-keep", "0,1", "--device", "cpu"]))
    for extra in (["--pipeline-stages", "2"], ["--seq-parallel", "2"],
                  ["--base-layers", "1"], ["--heartbeat-timeout", "5"],
                  ["--tensorboard-logdir", "tb"], ["--wandb-project", "p"],
                  ["--azureml-logging"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train_lm.check_ported(train_lm.parse_args(extra + ["--device", "cpu"]))
    # the distributed flags are ported (tests/test_torch_distributed.py runs
    # them): check_ported takes them, and a world without a coordinator raises
    distributed = ["--distributed", "--coordinator-address", "localhost:1",
                   "--num-processes", "2", "--process-id", "0"]
    train_lm.check_ported(train_lm.parse_args(distributed + ["--device", "cpu"]))
    with pytest.raises(ValueError, match="coordinator-address"):
        train_lm.main(train_lm.parse_args(
            ["--distributed", "--num-processes", "2", "--device", "cpu"]))

"""MT training in the PyTorch port against the JAX package, on the CPU.

fairseq Adam, the inverse-sqrt and polynomial schedules, token-budget
batching, the epoch's batch sequence, the MT train and eval steps, the
shared layer runner (``--checkpoint-activations``, layerdrop), the
``trajectory_mt_adam.npz`` replay and ``cli.train_mt`` end to end.
Weights and inputs are drawn with numpy and handed to both packages (JAX at
``highest`` matmul precision, torch without TF32).  Tolerances:

* Adam over five steps of a moving lr: 1e-6 abs / 1e-5 rel (the NAG
  test's); the schedules 1e-6 rel (JAX's are float32, the port's float64);
* batching and the epoch's batches: exact;
* the train step (2 + 2 layers, dim 48, vocab 120, dropout 0; EVA and
  causal EVA with the same injected noise): loss and gradient norm 1e-5
  rel, the updated parameters 1e-5 abs; under ``--bf16`` the logits' dtype
  equal and the loss 1e-2 rel; the eval step's sums 1e-5 rel;
* the 60-step replay at ``TestMTTrajectory``'s tolerances (first 10 losses
  1e-4, all 2e-2; final parameters 2e-3 abs / 2e-2 rel);
* ``--checkpoint-activations`` against no remat at dropout 0.1, in float32
  and under ``--bf16``: gradients 1e-6 rel (the same products, summed into
  the shared embedding in another order), the generator's state equal.
"""
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import exact_float32, randomize, to_jax
from efficient_attention_tpu.attention.eva import EVA as JaxEVA
from efficient_attention_tpu.data import text_data as jax_text_data
from efficient_attention_tpu.models.transformer import TransformerModel as JaxModel
from efficient_attention_tpu.training import lm_steps as jax_lm_steps
from efficient_attention_tpu.training import optim as jax_optim
from efficient_attention_tpu.training.train_state import TrainState as JaxTrainState
from efficient_attention_torch.attention.causal_eva import CausalEVAttention
from efficient_attention_torch.attention.eva import EVA
from efficient_attention_torch.cli import train_mt
from efficient_attention_torch.data.text_data import (
    LanguagePairDataset,
    batch_by_size,
    collate_tokens,
)
from efficient_attention_torch.interop import (
    mt_state_dict_from_fairseq,
    mt_state_dict_from_jax,
)
from efficient_attention_torch.models.layers import set_generator
from efficient_attention_torch.models.transformer import (
    TransformerLM,
    TransformerModel,
)
from efficient_attention_torch.training import lm_steps, optim
from efficient_attention_torch.training.criterions import label_smoothed_nll_loss
from efficient_attention_torch.training.train_state import TrainState

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
STEP_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(atol=1e-5, rtol=0)
ENC_ARGS = dict(window_size=8, num_landmarks=8, overlap_window=True,
                use_t5_rpe=True, adaptive_proj="no-ln", attn_2d=False,
                use_rpe=False)
DEC_ARGS = dict(window_size=16, chunk_size=8, adaptive_proj="qk", causal=True)
SOFTMAX = dict(src_vocab_size=120, tgt_vocab_size=120, embed_dim=48,
               ffn_dim=96, num_layers=2, num_heads=3, dropout=0.0, max_len=256,
               share_all_embeddings=True)
EVA_MODEL = dict(SOFTMAX, attn_name_encoder="eva", attn_args_encoder=ENC_ARGS,
                 attn_name_decoder="causal_eva", attn_args_decoder=DEC_ARGS)
CLI_ARGV = [
    "--dummy-data", "--dummy-vocab", "120", "--encoder-embed-dim", "48",
    "--encoder-ffn-embed-dim", "96", "--encoder-layers", "2",
    "--encoder-attention-heads", "3", "--attn-name-encoder", "eva",
    "--encoder-attn-window-size", "8", "--encoder-attn-num-landmarks", "8",
    "--encoder-attn-overlap-window", "--encoder-attn-use-t5-rpe",
    "--encoder-attn-adaptive-proj", "no-ln", "--attn-name-decoder", "causal_eva",
    "--decoder-attn-window-size", "16", "--decoder-attn-chunk-size", "8",
    "--decoder-attn-adaptive-proj", "qk", "--decoder-attn-causal",
    "--share-all-embeddings", "--max-tokens", "512", "--device", "cpu",
]


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def _noise(shape):
    """The injected noise of a draw of ``shape``: the same numbers in both
    packages, a function of the shape alone."""
    seed = int(np.prod(shape)) + 7 * len(shape)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _inject_noise():
    """EVA's RF sample and causal EVA's proposal noise, the same numbers on
    both sides (the two packages draw ``[B, H, C, d]`` in both)."""
    def port_sample(self, mu):
        if not self.training:
            return mu
        return mu + torch.from_numpy(_noise(tuple(mu.shape))).to(mu.dtype)

    def jax_sample(self, mu, deterministic):
        return mu if deterministic else mu + jnp.asarray(_noise(mu.shape), mu.dtype)

    return (mock.patch.object(EVA, "_sample_weights", port_sample),
            mock.patch.object(JaxEVA, "_sample_weights", jax_sample),
            mock.patch.object(CausalEVAttention, "_proposal_noise",
                              lambda self, shape, like: torch.from_numpy(
                                  _noise(tuple(shape))).to(like.dtype)),
            mock.patch("jax.random.normal", lambda key, shape, dtype=None:
                       jnp.asarray(_noise(tuple(shape)), dtype)))


def _batch(seed=0, B=6):
    """A collated batch of the CLI's dummy pairs: (src, prev, tgt) numpy."""
    rng = np.random.default_rng(seed)
    pairs = LanguagePairDataset(train_mt.DummyPairs(rng, 120, B),
                                train_mt.DummyPairs(rng, 120, B))
    return tuple(t.numpy() for t in train_mt.collate_pairs(pairs, range(B), "cpu"))


def _model_pair(model_kw, seed=5):
    """The JAX model with numpy-drawn params and the port's carrying them."""
    jm = JaxModel(**model_kw)
    dummy = jnp.ones((1, 16), jnp.int32)
    params = to_jax(randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), dummy, dummy),
                              seed))
    tm = TransformerModel(**model_kw)
    tm.load_state_dict(mt_state_dict_from_jax(params), strict=True)
    return jm, params, tm


# ---- fairseq Adam and the schedules


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_matches_jax(clip, weight_decay):
    """Five steps of ``ClippedAdam`` against JAX ``make_optimizer("adam")``,
    betas (0.9, 0.98), a moving lr, masked decoupled weight decay (the 2-D
    ``w`` decayed, the 1-D ``b`` not), and a few gradients near zero, where
    fairseq's eps (on the uncorrected sqrt(v)) differs from optax's."""
    ref = jax_optim.inverse_sqrt_schedule(3e-3, warmup_steps=2, warmup_init_lr=1e-3)
    mine = optim.inverse_sqrt_schedule(3e-3, warmup_steps=2, warmup_init_lr=1e-3)
    rng = np.random.default_rng(6)
    p0 = {"w": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    for g in grads:
        g["w"][0] *= 1e-7
    tx = jax_optim.make_optimizer("adam", ref, weight_decay=weight_decay,
                                  clip_grad=clip, params_for_mask=to_jax(p0),
                                  betas=(0.9, 0.98))
    jp = to_jax(p0)
    js = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = optim.make_optimizer("adam", params.items(), mine,
                               weight_decay=weight_decay, clip_grad=clip,
                               betas=(0.9, 0.98))
    assert isinstance(opt, optim.ClippedAdam)
    for g in grads:
        upd, js = tx.update(to_jax(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    assert opt.count == 5
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name,kw", [
    ("inverse_sqrt", dict(base_lr=7e-4, warmup_steps=10, warmup_init_lr=1e-7)),
    ("inverse_sqrt", dict(base_lr=3e-3, warmup_steps=1, warmup_init_lr=1e-5)),
    ("polynomial", dict(base_lr=0.5, warmup_steps=10, total_steps=90)),
    ("polynomial", dict(base_lr=0.5, warmup_steps=0, total_steps=60, power=2.0,
                        end_lr=0.01)),
])
def test_schedules_match_jax(name, kw):
    mine = getattr(optim, f"{name}_schedule")(**kw)
    ref = getattr(jax_optim, f"{name}_schedule")(**kw)
    np.testing.assert_allclose([mine(i) for i in range(101)],
                               [float(ref(i)) for i in range(101)], rtol=1e-6)


# ---- batching


@pytest.mark.parametrize("seed", range(6))
def test_batch_by_size_matches_jax(seed):
    """Random orders, sizes, token budgets, sentence caps and multiples,
    against the JAX package's ``batch_by_size`` (its native library where
    built): the same batches."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n = int(rng.integers(1, 300))
        sizes = rng.integers(1, 120, n)
        order = rng.permutation(n)
        if rng.random() < 0.5:
            order = order[np.argsort(sizes[order], kind="stable")]
        kw = dict(max_tokens=int(rng.integers(120, 4096)),
                  max_sentences=[None, int(rng.integers(1, 64))][int(rng.integers(2))],
                  required_multiple=int(rng.choice([1, 2, 3, 8])))
        mine = batch_by_size(order, sizes, **kw)
        ref = jax_text_data.batch_by_size(order, sizes, **kw)
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, b)


def _jax_epoch(order_rng, sizes, train_ok, max_tokens, max_sentences, update_freq):
    """The batch sequence of one epoch as JAX ``cli/train_mt.py:540-563``
    builds it on one device."""
    order = order_rng.permutation(len(sizes))
    order = order[train_ok[order]]
    order = order[np.argsort(sizes[order], kind="stable")]
    quantum = max(1, update_freq)
    batches = jax_text_data.batch_by_size(order, sizes, max_tokens,
                                          max_sentences=max_sentences,
                                          required_multiple=quantum)
    order_rng.shuffle(batches)
    out = []
    for bidx in batches:
        if len(bidx) % quantum != 0:
            bidx = bidx[: len(bidx) - (len(bidx) % quantum)]
        if len(bidx):
            out.append(bidx)
    return out


@pytest.mark.parametrize("max_sentences,update_freq,max_len", [
    (None, 1, 1024), (None, 2, 1024), (24, 3, 20), (8, 8, 1024)])
def test_epoch_batches_match_jax(max_sentences, update_freq, max_len):
    """Three epochs of ``cli.train_mt.epoch_batches`` on the CLI's dummy
    pairs: the batches JAX's epoch loop trains on, in its order."""
    args = train_mt.parse_args(["--dummy-data", "--dummy-vocab", "120"])
    src, tgt, _, _ = train_mt.load_pairs(args)
    pairs = LanguagePairDataset(src, tgt)
    sizes = np.maximum(pairs.src_sizes, pairs.tgt_sizes)
    train_ok = sizes <= max_len
    mine_rng, ref_rng = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(3):
        mine = train_mt.epoch_batches(mine_rng, sizes, train_ok, 1024,
                                      max_sentences, update_freq)
        ref = _jax_epoch(ref_rng, sizes, train_ok, 1024, max_sentences, update_freq)
        assert len(mine) == len(ref) > 1
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, b)
            assert len(a) % update_freq == 0
    with pytest.raises(ValueError, match="update-freq"):
        train_mt.epoch_batches(mine_rng, sizes, train_ok, 1024, 1, 2)


# ---- the train and eval steps


def _jax_train(jm, params, step_kw, tx, batch, steps):
    step = jax.jit(jax_lm_steps.make_mt_train_step(pad_idx=1, **step_kw))
    state = JaxTrainState.create(jm.apply, params, tx)
    src, prev, tgt = (jnp.asarray(a) for a in batch)
    out = []
    for _ in range(steps):
        state, metrics = step(state, src, prev, tgt, jax.random.PRNGKey(3))
        out.append((float(metrics.loss), float(metrics.grad_norm)))
    return state, out


def _port_train(tm, step_kw, opt, batch, steps):
    step = lm_steps.make_mt_train_step(pad_idx=1, **step_kw)
    state = TrainState(tm, opt)
    src, prev, tgt = (torch.from_numpy(a) for a in batch)
    out = []
    for _ in range(steps):
        metrics = step(state, src, prev, tgt, torch.Generator().manual_seed(3))
        assert not bool(metrics.skipped)
        out.append((float(metrics.loss), float(metrics.grad_norm)))
    return state, out


@pytest.mark.parametrize("model,accum,sentence_avg", [
    ("softmax", 1, False), ("softmax", 2, True), ("eva", 1, True),
    ("eva", 2, False)])
def test_mt_train_step_matches_jax(model, accum, sentence_avg):
    """Two steps of fairseq Adam (clip 1.0, betas (0.9, 0.98)) on the same
    batch: loss and gradient norm of each, then every updated parameter.
    EVA + causal EVA run with the same injected noise on both sides.

    Adam moves a coordinate by about lr * sign(g) whatever its gradient's
    size, so a gradient at rounding level (softmax attention's k-projection
    biases get none in exact arithmetic: a shift of all of a row's logits)
    moves by up to ``lr |g| / eps`` in either package, in any direction.
    At lr 1e-4 that stays under 1e-5, where a wrong update (its sign, the
    bias correction, the clip, the microbatch average) moves parameters by
    about lr."""
    kw = SOFTMAX if model == "softmax" else EVA_MODEL
    jm, params, tm = _model_pair(kw)
    batch = _batch(seed=1, B=6 if accum == 1 else 8)
    step_kw = dict(label_smoothing=0.1, accum_steps=accum, sentence_avg=sentence_avg)
    tx = jax_optim.make_optimizer("adam", lambda s: 1e-4, weight_decay=0.0,
                                  clip_grad=1.0, params_for_mask=params,
                                  betas=(0.9, 0.98))
    opt = optim.make_optimizer("adam", tm.named_parameters(), lambda s: 1e-4,
                               weight_decay=0.0, clip_grad=1.0, betas=(0.9, 0.98))
    p0 = {n: p.detach().clone() for n, p in tm.named_parameters()}
    patches = _inject_noise()
    for p in patches:
        p.start()
    try:
        jstate, want = _jax_train(jm, params, step_kw, tx, batch, 2)
        state, got = _port_train(tm, step_kw, opt, batch, 2)
    finally:
        for p in patches:
            p.stop()
    np.testing.assert_allclose(got, want, **STEP_TOL)
    assert state.step == int(jstate.step) == 2
    named = dict(tm.named_parameters())
    for name, p in mt_state_dict_from_jax(jstate.params).items():
        if name in named:
            np.testing.assert_allclose(named[name].detach().numpy(), p.numpy(),
                                       **PARAM_TOL, err_msg=name)
    moved = max((p.detach() - p0[n]).abs().max().item() for n, p in named.items())
    assert moved > 1e-4


def test_mt_bf16_step_promotes_as_jax_does():
    """``--bf16``: the forward on a bfloat16 copy of the float32 masters.
    The logits' dtype is JAX's (no float32 table or buffer promotes the
    stream in one package and not the other), the loss within 1e-2 rel."""
    from efficient_attention_tpu.training.train_state import cast_params as jax_cast
    from efficient_attention_torch.training.train_state import cast_modules

    jm, params, tm = _model_pair(EVA_MODEL)
    batch = _batch(seed=2)
    src, prev, tgt = (jnp.asarray(a) for a in batch)
    jax_logits = jax.jit(jm.apply)(jax_cast(params, jnp.bfloat16), src, prev)
    with torch.no_grad(), cast_modules(tm.eval(), torch.bfloat16):
        logits = tm(*(torch.from_numpy(a) for a in batch[:2]))
    assert str(logits.dtype).split(".")[-1] == str(jax_logits.dtype)
    step_kw = dict(label_smoothing=0.1, compute_dtype=None)
    tx = jax_optim.make_optimizer("adam", lambda s: 1e-3, weight_decay=0.0,
                                  betas=(0.9, 0.98))
    opt = optim.make_optimizer("adam", tm.named_parameters(), lambda s: 1e-3,
                               weight_decay=0.0, betas=(0.9, 0.98))
    patches = _inject_noise()
    for p in patches:
        p.start()
    try:
        _, want = _jax_train(jm, params, dict(step_kw, compute_dtype=jnp.bfloat16),
                             tx, batch, 1)
        state, got = _port_train(tm, dict(step_kw, compute_dtype=torch.bfloat16),
                                 opt, batch, 1)
    finally:
        for p in patches:
            p.stop()
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-2)
    # the masters stay float32 parameters, the shared embedding too
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert tm.decoder.embed_tokens.weight is tm.encoder.embed_tokens.weight
    assert isinstance(tm.encoder.embed_tokens.weight, torch.nn.Parameter)
    assert state.step == 1


@pytest.mark.parametrize("model", ["softmax", "eva"])
def test_mt_eval_step_matches_jax(model):
    """Summed smoothed loss, NLL and tokens of the eval step (the encoder's
    EVA at eval: K4's plain version on the CPU)."""
    jm, params, tm = _model_pair(SOFTMAX if model == "softmax" else EVA_MODEL)
    batch = _batch(seed=3)
    want = jax.jit(lambda p, s, pv, t: jax_lm_steps.make_mt_eval_step(
        pad_idx=1, label_smoothing=0.1)(p, jm.apply, s, pv, t))(
            params, *(jnp.asarray(a) for a in batch))
    got = lm_steps.make_mt_eval_step(pad_idx=1, label_smoothing=0.1)(
        tm.eval(), *(torch.from_numpy(a) for a in batch))
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want],
                               **STEP_TOL)


# ---- the trajectory replay


def test_mt_trajectory_golden_replays():
    """60 steps of fairseq Adam (betas (0.9, 0.98), clip 5.0), inverse-sqrt,
    label smoothing 0.1, shared embeddings, EVA + causal EVA, from the
    reference's initial weights, as ``TestMTTrajectory`` replays them in
    JAX."""
    data = np.load(os.path.join(GOLDENS, "trajectory_mt_adam.npz"))
    sd0 = {k[len("sd0__"):]: data[k] for k in data.files if k.startswith("sd0__")}
    sdF = {k[len("sdF__"):]: data[k] for k in data.files if k.startswith("sdF__")}
    m = TransformerModel(
        120, 120, embed_dim=48, ffn_dim=96, num_layers=2, num_heads=2,
        attn_name_encoder="eva",
        attn_args_encoder=dict(ENC_ARGS, window_size=4, num_landmarks=4),
        attn_name_decoder="causal_eva",
        attn_args_decoder=dict(DEC_ARGS, window_size=4, chunk_size=2,
                               use_t5_rpe=True),
        dropout=0.0, max_len=1024, share_all_embeddings=True)
    m.load_state_dict(mt_state_dict_from_fairseq(sd0), strict=True)
    m.eval()  # the replay is deterministic, as the JAX one
    schedule = optim.inverse_sqrt_schedule(3e-3, warmup_steps=10, warmup_init_lr=1e-5)
    np.testing.assert_allclose([schedule(i) for i in range(60)], data["lrs"],
                               rtol=1e-5, atol=1e-9)
    opt = optim.make_optimizer("adam", m.named_parameters(), schedule,
                               weight_decay=0.0, clip_grad=5.0, betas=(0.9, 0.98),
                               eps=1e-8)
    src, tgt_full = torch.from_numpy(data["src"]), torch.from_numpy(data["tgt_full"])
    losses = []
    for i in range(src.shape[0]):
        opt.zero_grad()
        loss_sum, _, ntok = label_smoothed_nll_loss(
            m(src[i], tgt_full[i, :, :-1]), tgt_full[i, :, 1:], epsilon=0.1,
            pad_idx=1)
        loss = loss_sum / ntok
        loss.backward()
        opt.step()
        losses.append(loss.item())
    ref = data["losses"]
    np.testing.assert_allclose(losses[:10], ref[:10], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(losses, ref, rtol=2e-2, atol=2e-2)
    final = mt_state_dict_from_fairseq(sdF)
    for name, p in m.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(), atol=2e-3,
                                   rtol=2e-2, err_msg=name)


# ---- the layer runner


def _remat_pair(kind):
    """Two copies of a model at dropout 0.1, without and with
    ``--checkpoint-activations``, and its train step ``step(state,
    generator, compute_dtype)`` on a batch."""
    if kind == "mt":
        kw = dict(EVA_MODEL, dropout=0.1)
        models = [TransformerModel(**kw, checkpoint_activations=remat)
                  for remat in (False, True)]
        src, prev, tgt = (torch.from_numpy(a) for a in _batch(seed=4))

        def step(state, gen, dtype):
            return lm_steps.make_mt_train_step(compute_dtype=dtype)(
                state, src, prev, tgt, gen)
    else:
        kw = dict(vocab_size=120, embed_dim=48, ffn_dim=96, num_layers=2,
                  num_heads=3, attn_name="causal_eva",
                  attn_args=dict(window_size=8, chunk_size=4, adaptive_proj="qk",
                                 use_t5_rpe=True, causal=True),
                  dropout=0.1, adaptive_cutoffs=(40, 80), adaptive_input=True)
        models = [TransformerLM(**kw, checkpoint_activations=remat)
                  for remat in (False, True)]
        toks = torch.from_numpy(np.random.default_rng(4).integers(2, 120, (3, 33)))

        def step(state, gen, dtype):
            return lm_steps.make_lm_train_step(use_adaptive=True,
                                               compute_dtype=dtype)(
                state, toks[:, :-1], toks[:, 1:], gen)
    models[1].load_state_dict(models[0].state_dict())
    return models, step


@pytest.mark.parametrize("kind", ["mt", "lm"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_checkpoint_activations_keep_the_draws(kind, dtype):
    """With remat, the backward recomputes each layer with the forward's
    dropout masks and noise and, under ``--bf16``, its bfloat16 copies of
    the weights (their cast block has closed by the backward): the train
    step gives the loss and float32 gradients of the step without remat,
    and leaves the generator where that step leaves it."""
    models, step = _remat_pair(kind)
    gens, losses = [], []
    for m in models:
        gen = torch.Generator().manual_seed(11)
        metrics = step(TrainState(m, torch.optim.SGD(m.parameters(), lr=0.0)),
                       gen, dtype)
        gens.append(gen)
        losses.append(metrics.loss.item())
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    for (name, a), b in zip(models[0].named_parameters(), models[1].parameters()):
        assert a.grad.dtype == b.grad.dtype == torch.float32, name
        np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=name)


def test_layerdrop_one_is_the_identity_in_training_only():
    """Encoder and decoder layerdrop 1.0: in training every layer is the
    identity (the model is its embeddings and output layer); at eval every
    layer runs, as in a model without layerdrop."""
    kw = dict(EVA_MODEL)
    plain = TransformerModel(**kw)
    dropped = TransformerModel(**kw, encoder_layerdrop=1.0, decoder_layerdrop=1.0)
    dropped.load_state_dict(plain.state_dict())
    src, prev, _ = (torch.from_numpy(a) for a in _batch(seed=5))
    with torch.no_grad():
        set_generator(dropped.train(), torch.Generator().manual_seed(0))
        enc, pad = dropped.encoder(src)
        np.testing.assert_array_equal(enc.numpy(), dropped.encoder._embed(src).numpy())
        feats = dropped.decoder(prev, enc, pad)
        np.testing.assert_array_equal(feats.numpy(),
                                      dropped.decoder._embed(prev).numpy())
        np.testing.assert_array_equal(dropped.eval()(src, prev).numpy(),
                                      plain.eval()(src, prev).numpy())


# ---- the CLI


@pytest.mark.parametrize("precision", [[], ["--bf16"]], ids=["f32", "bf16"])
def test_train_mt_cli_runs_on_cpu(capsys, tmp_path, precision):
    """The CLI end to end at a tiny size, with ``--checkpoint-activations``
    and an EMA, in float32 and under ``--bf16``: 4 updates of 2
    microbatches, validation with BLEU every 2 updates and at the epoch's
    end, its checkpoints in a temporary --save-dir; the stats are JAX's
    keys, finite, and the last line printed."""
    stats = train_mt.cli_main(CLI_ARGV + [
        "--max-update", "4", "--update-freq", "2", "--validate-interval-updates",
        "2", "--eval-bleu", "--eval-bleu-args", '{"beam": 2, "lenpen": 0.6}',
        "--eval-bleu-subset-size", "12", "--log-interval", "1",
        "--checkpoint-activations", "--store-ema", "--save-dir", str(tmp_path)]
        + precision)
    assert set(stats) == {"step", "loss", "valid_loss", "valid_nll_loss",
                          "valid_ppl", "valid_bleu"}
    assert stats["step"] == 4
    assert all(np.isfinite(v) for v in stats.values())
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == stats
    assert sum(line.startswith("| valid ") for line in out) == 3


@pytest.mark.parametrize("extra", [
    ["--heartbeat-timeout", "5"], ["--tensorboard-logdir", "tb"],
    ["--wandb-project", "p"], ["--azureml-logging"],
    ["--distributed", "--num-processes", "2"],
    ["--distributed", "--coordinator-address", "localhost:1",
     "--num-processes", "2", "--process-id", "2"]])
def test_train_mt_unported_flags_raise(extra):
    """The flags of unported modules raise naming their ROADMAP.md item;
    the distributed flags are ported, and raise on a world without a
    coordinator or a rank outside the world."""
    if "--distributed" in extra:
        error, match = ValueError, "coordinator-address|outside a world"
    else:
        error, match = NotImplementedError, "ROADMAP"
    with pytest.raises(error, match=match):
        train_mt.main(train_mt.parse_args(CLI_ARGV + ["--max-update", "1"] + extra))


def test_collate_pairs_matches_jax():
    """Source, previous output tokens and target as the JAX epoch loop
    collates them."""
    rng = np.random.default_rng(8)
    pairs = LanguagePairDataset(train_mt.DummyPairs(rng, 120, 5),
                                train_mt.DummyPairs(rng, 120, 5))
    src, prev, tgt = train_mt.collate_pairs(pairs, [3, 0, 4], "cpu")
    samples = [pairs[i] for i in (3, 0, 4)]
    for got, (which, kw) in zip((src, prev, tgt), (
            (0, {}), (1, dict(move_eos_to_beginning=True)), (1, {}))):
        np.testing.assert_array_equal(got.numpy(), jax_text_data.collate_tokens(
            [s[which] for s in samples], pad_idx=1, **kw))
    np.testing.assert_array_equal(src.numpy(), collate_tokens(
        [s[0] for s in samples], pad_idx=1))

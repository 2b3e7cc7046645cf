"""The LM slice of the PyTorch port against the JAX package, on the CPU.

Weights and inputs are drawn with numpy and handed to both packages (JAX at
``highest`` matmul precision, torch without TF32).  Tolerances:

* ``CausalEVAttention``, eager and K3 routes, eval and training with the
  same injected proposal noise: 3e-5 abs / 1e-4 rel (``TestCausalPacked``'s
  module tolerance); input gradients 1e-4 / 1e-3;
* the ``causal_eva_parallel.npz`` golden: 3e-5 / 1e-4 (``test_goldens.py``);
* ``TransformerLM`` features and log-probs, against JAX and the two LM
  goldens: 1e-4 / 1e-4 (``test_interop.py``'s);
* the streamed vocabulary softmax over several chunks: 1e-5 / 1e-5, its
  gradients 1e-5 / 1e-4 (the same f32 sums in another order);
* schedule 1e-5 rel (JAX's is float32, the port's float64), NAG 1e-6 /
  1e-5 over five steps of a moving lr;
* the 60-step ``trajectory_lm_nag.npz`` replay at ``TestLMTrajectory``'s
  tolerances (first 10 losses 1e-4, all 2e-2; final parameters 2e-3 abs /
  2e-2 rel).
"""
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import exact_float32, randomize, to_jax
from efficient_attention_tpu.attention.causal_eva import (
    CausalEVAttention as JaxCausalEVA,
)
from efficient_attention_tpu.models.transformer import TransformerLM as JaxLM
from efficient_attention_torch import AttentionFactory
from efficient_attention_torch.attention.causal_eva import CausalEVAttention
from efficient_attention_torch.interop import (
    lm_state_dict_from_fairseq,
    lm_state_dict_from_jax,
)
from efficient_attention_torch.models.transformer import TransformerLM

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
MOD_TOL = dict(atol=3e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
LM_TOL = dict(atol=1e-4, rtol=1e-4)
# the K3 geometry of TestCausalPacked: 2 heads of 64, window 16, chunk 4
ATTN = dict(embed_dim=128, num_heads=2, window_size=16, chunk_size=4,
            causal=True, adaptive_proj="qk")


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def _golden(name, prefix="sd__"):
    data = np.load(os.path.join(GOLDENS, name))
    return data, {k[len(prefix):]: data[k] for k in data.files
                  if k.startswith(prefix)}


def _attn_pair(seed=0, T=64, **kw):
    """A JAX module with numpy-drawn params, the port's module carrying
    them (strict load), and an input ``[2, T, 128]``."""
    jm = JaxCausalEVA(impl="xla", **{**ATTN, **kw})
    x = np.random.default_rng(seed).standard_normal((2, T, 128)).astype(np.float32)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed + 1)
    tm = CausalEVAttention(**{**ATTN, **kw})
    tm.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return jm, params, tm, x


@pytest.mark.parametrize("impl", ["xla", "packed"])
@pytest.mark.parametrize("t5", [False, True])
def test_causal_eva_eval_matches_jax(impl, t5):
    jm, params, tm, x = _attn_pair(use_t5_rpe=t5)
    want = np.asarray(jm.apply(to_jax(params), jnp.asarray(x)))
    tm.impl = impl
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **MOD_TOL)


@pytest.mark.parametrize("kw,mask", [
    (dict(overlap_window=True, use_t5_rpe=True), False),
    (dict(use_t5_rpe=True), True),
    (dict(chunk_size=None, num_chunks=4), False),
])
def test_causal_eva_eager_halo_mask_and_padding_match_jax(kw, mask):
    """The eager path's halo, key-padding mask and right padding (T = 56,
    not a multiple of the window)."""
    jm, params, tm, x = _attn_pair(seed=2, T=56 if not mask else 64, **kw)
    kpm = None
    if mask:
        kpm = np.zeros((2, 64), bool)
        kpm[1, 50:] = True
    want = np.asarray(jm.apply(to_jax(params), jnp.asarray(x),
                               key_padding_mask=None if kpm is None
                               else jnp.asarray(kpm)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), key_padding_mask=None if kpm is None
                        else torch.from_numpy(kpm)).numpy()
    np.testing.assert_allclose(got, want, **MOD_TOL)


@pytest.mark.parametrize("impl", ["xla", "packed"])
def test_causal_eva_training_matches_jax_with_the_same_noise(impl):
    """Train mode, the proposal noise injected on both sides (head-major
    ``[B, H, C, d]``): outputs and input gradients."""
    jm, params, tm, x = _attn_pair(seed=3, use_t5_rpe=True)
    noise = np.random.default_rng(9).standard_normal((2, 2, 16, 64)).astype(np.float32)
    g = np.random.default_rng(10).standard_normal(x.shape).astype(np.float32)

    def jax_out(xx):
        return jm.apply(to_jax(params), xx, deterministic=False,
                        rngs={"sample": jax.random.PRNGKey(1),
                              "dropout": jax.random.PRNGKey(2)})

    with mock.patch("jax.random.normal",
                    lambda key, shape, dtype=None: jnp.asarray(noise)):
        want, vjp = jax.vjp(jax_out, jnp.asarray(x))
        (want_dx,) = vjp(jnp.asarray(g))
    tm.impl = impl
    xt = torch.from_numpy(x).requires_grad_()
    with mock.patch.object(CausalEVAttention, "_proposal_noise",
                           lambda self, shape, like: torch.from_numpy(noise)):
        got = tm.train()(xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MOD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **GRAD_TOL)


def test_causal_eva_parallel_golden():
    data = np.load(os.path.join(GOLDENS, "causal_eva_parallel.npz"))
    sd = {k[len("param:"):]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("param:")}
    m = CausalEVAttention(48, 4, window_size=8, chunk_size=4,
                          adaptive_proj="qk", use_t5_rpe=True, causal=True)
    m.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(data["x"])).numpy()
    np.testing.assert_allclose(out, data["out"], **MOD_TOL)


def test_dispatch_follows_the_jax_rule():
    """K3's route runs at eval and at dropout 0 in training (``impl='packed'``
    on CPU tensors, as the JAX package's interpret mode); at dropout > 0 in
    training, and for ``impl='auto'`` off the card, the eager path runs."""
    x = torch.zeros(1, 32, 128)
    routes = []
    packed = CausalEVAttention._forward_packed
    eager = CausalEVAttention._forward_eager
    with mock.patch.object(CausalEVAttention, "_forward_packed", autospec=True,
                           side_effect=lambda *a: routes.append("k3") or packed(*a)), \
         mock.patch.object(CausalEVAttention, "_forward_eager", autospec=True,
                           side_effect=lambda *a: routes.append("eager") or eager(*a)):
        for impl, dropout, train in [("packed", 0.1, False), ("packed", 0.0, True),
                                     ("packed", 0.1, True), ("auto", 0.0, False),
                                     ("xla", 0.0, False)]:
            m = CausalEVAttention(**ATTN, impl=impl, dropout=dropout).train(train)
            if impl == "packed" and dropout and train:
                with pytest.raises(ValueError, match="impl='packed'"):
                    m(x)
                routes.append("raised")
            else:
                m(x)
    assert routes == ["k3", "k3", "raised", "eager", "eager"]


def test_factory_builds_causal_eva_with_its_flags():
    import argparse

    from efficient_attention_torch import NestedNamespace

    parser = AttentionFactory.add_attn_specific_args(
        argparse.ArgumentParser(), "causal_eva", struct_name="attn_args_decoder",
        prefix="decoder-attn")
    args = parser.parse_args(["--decoder-attn-window-size", "16",
                              "--decoder-attn-chunk-size", "4",
                              "--decoder-attn-use-t5-rpe"],
                             namespace=NestedNamespace())
    m = AttentionFactory.build_attention(
        "causal_eva", {**vars(args.attn_args_decoder), "embed_dim": 128,
                       "num_heads": 2})
    assert isinstance(m, CausalEVAttention) and m.window_size == 16
    assert m.rel_pos_bias.relative_attention_bias.weight.shape == (16, 1)


_LM = dict(vocab_size=120, embed_dim=128, ffn_dim=96, num_layers=2,
           num_heads=2, dropout=0.0, max_len=256, adaptive_cutoffs=(40, 80),
           adaptive_input=True, tie_adaptive=True, final_norm=False)
_LM_ATTN = dict(window_size=16, chunk_size=4, adaptive_proj="qk",
                use_t5_rpe=True, causal=True)


@pytest.mark.parametrize("attn,impl", [("causal_eva", "xla"),
                                       ("causal_eva", "packed"),
                                       ("softmax", None)])
def test_transformer_lm_matches_jax(attn, impl):
    """Features, log-probs and the token NLL of a 2-layer wiki103-shaped LM
    (adaptive input, tied adaptive softmax, no final LN) with dense token
    blocks, the port carrying the JAX params."""
    attn_args = _LM_ATTN if attn == "causal_eva" else {}
    toks = np.random.default_rng(1).integers(2, 120, (2, 64))
    jm = JaxLM(attn_name=attn, attn_args=attn_args, dense_tokens=True, **_LM)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(toks[:1])), 3)
    jp, jt = to_jax(params), jnp.asarray(toks)
    feats = np.asarray(jm.apply(jp, jt, features_only=True))
    lp = np.asarray(jm.apply(jp, jt))
    nll = np.asarray(jm.apply(jp, jt, jt, method="loss"))
    tm = TransformerLM(attn_name=attn, dense_tokens=True,
                       attn_args=dict(attn_args, impl=impl) if impl else {}, **_LM)
    tm.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        tm.eval()
        np.testing.assert_allclose(tm(tt, features_only=True).numpy(), feats, **LM_TOL)
        np.testing.assert_allclose(tm(tt).numpy(), lp, **LM_TOL)
        np.testing.assert_allclose(tm.loss(tt, tt).numpy(), nll, **LM_TOL)


@pytest.mark.parametrize("name,attn,attn_args", [
    ("lm_softmax_adaptive.npz", "softmax", {}),
    ("lm_causal_eva_adaptive.npz", "causal_eva",
     dict(window_size=8, chunk_size=4, adaptive_proj="qk", use_t5_rpe=True,
          causal=True)),
])
def test_transformer_lm_matches_reference_golden(name, attn, attn_args):
    data, sd = _golden(name)
    m = TransformerLM(vocab_size=120, embed_dim=48, ffn_dim=96, num_layers=2,
                      num_heads=2, attn_name=attn, attn_args=attn_args,
                      dropout=0.0, max_len=1024, adaptive_cutoffs=(40, 80),
                      adaptive_input=True, tie_adaptive=True, final_norm=False)
    m.load_state_dict(lm_state_dict_from_fairseq(sd), strict=True)
    toks = torch.from_numpy(data["tokens"])
    with torch.no_grad():
        m.eval()
        np.testing.assert_allclose(m(toks, features_only=True).numpy(),
                                   data["features"], **LM_TOL)
        np.testing.assert_allclose(m(toks).numpy(), data["logprobs"], **LM_TOL)


def test_bf16_forward_promotes_to_f32_as_jax_does():
    """Under ``--bf16`` (parameters cast to bfloat16) the adaptive input sums
    into a float32 buffer in both packages, so the residual stream and every
    attention's q/k/v are float32, each layer computing in float32 with its
    bfloat16 weights cast up.  Features match JAX in float32: 99.5% of them
    to 1e-4 abs / 1e-4 rel (float32 arithmetic on the same bfloat16-rounded
    weights), and all to 1e-2 abs, for the adaptive input's band
    projections are bfloat16 products that the two packages may round one
    bfloat16 spacing apart; the mean NLL to 1e-4 rel."""
    from efficient_attention_tpu.training.train_state import (
        cast_params as jax_cast,
    )
    from efficient_attention_torch.training.train_state import cast_modules

    toks = np.random.default_rng(1).integers(2, 120, (2, 64))
    jm = JaxLM(attn_name="causal_eva", attn_args=_LM_ATTN, dense_tokens=True, **_LM)
    params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(toks[:1])), 3)
    jp, jt = jax_cast(to_jax(params), jnp.bfloat16), jnp.asarray(toks)
    feats, inter = jax.jit(lambda p, t: jm.apply(
        p, t, features_only=True, capture_intermediates=True,
        mutable=["intermediates"]))(jp, jt)
    jax_q = inter["intermediates"]["decoder"]["layer_0"]["self_attn"]["q_proj"]
    assert feats.dtype == jnp.float32 and jax_q["__call__"][0].dtype == jnp.float32
    nll = np.asarray(jax.jit(lambda p, t: jm.apply(p, t, t, method="loss"))(jp, jt))

    tm = TransformerLM(attn_name="causal_eva", dense_tokens=True,
                       attn_args=dict(_LM_ATTN, impl="packed"), **_LM)
    tm.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    seen = {}
    tm.decoder.layers[0].self_attn.q_proj.register_forward_hook(
        lambda m, i, o: seen.update(q=o.dtype))
    tt = torch.from_numpy(toks)
    with torch.no_grad(), cast_modules(tm.eval(), torch.bfloat16):
        assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
        got = tm(tt, features_only=True)
        got_nll = tm(tt, tt)
    assert got.dtype == torch.float32 and seen["q"] == torch.float32
    feats = np.asarray(feats)
    close = np.abs(got.numpy() - feats) <= 1e-4 + 1e-4 * np.abs(feats)
    assert close.mean() >= 0.995, close.mean()
    np.testing.assert_allclose(got.numpy(), feats, atol=1e-2, rtol=0)
    np.testing.assert_allclose(got_nll.mean().item(), nll.mean(), rtol=1e-4)


def test_lm_init_matches_jax_in_distribution():
    """``cli.train_lm.build_model`` draws the weights the JAX CLI's model
    would draw, in distribution: the wiki103 structure (adaptive input,
    tied adaptive softmax, causal EVA with T5) at a reduced width, leaf by
    leaf (pooled over layers) the same constants, and the same mean, std
    and largest magnitude within sampling error (mean 5 sigma, std 5 /
    sqrt(2n) relative, largest magnitude 12%, which parts a uniform
    (sqrt(3) std) from a 2-sigma truncated normal (2.27 std) and a normal);
    and on the same tokens the same initial loss, over three seeds a side,
    within 4 of its seed-to-seed standard errors."""
    import re

    from efficient_attention_tpu.cli import train_lm as jax_cli
    from efficient_attention_torch.cli import train_lm

    argv = ["--arch", "transformer_lm_wiki103", "--attn-name-decoder", "causal_eva",
            "--decoder-attn-window-size", "16", "--decoder-attn-chunk-size", "4",
            "--decoder-attn-adaptive-proj", "qk", "--decoder-attn-use-t5-rpe",
            "--decoder-attn-causal", "--adaptive-cutoffs", "500,2000",
            "--decoder-embed-dim", "256", "--decoder-ffn-embed-dim", "1024",
            "--decoder-layers", "2", "--decoder-attention-heads", "4",
            "--dropout", "0", "--tokens-per-sample", "64"]
    vocab = 4000
    jargs, targs = jax_cli.parse_args(argv), train_lm.parse_args(argv + ["--device", "cpu"])
    jm = jax_cli.build_model(jargs, vocab, dense_tokens=True)
    jinit = jax.jit(jm.init)
    toks = np.random.default_rng(0).integers(4, vocab, (4, 65))
    tin, ttg = toks[:, :-1], toks[:, 1:]
    losses, pooled = {"jax": [], "port": []}, {"jax": {}, "port": {}}
    for seed in range(3):
        jp = jinit(jax.random.PRNGKey(seed), jnp.zeros((1, 64), jnp.int32))
        losses["jax"].append(float(jnp.mean(jm.apply(
            jp, jnp.asarray(tin), jnp.asarray(ttg), method="loss"))))
        targs.seed = seed
        tm = train_lm.build_model(targs, vocab, dense_tokens=True).eval()
        with torch.no_grad():
            losses["port"].append(tm.loss(torch.from_numpy(tin),
                                          torch.from_numpy(ttg)).mean().item())
        if seed == 0:
            sds = {"jax": lm_state_dict_from_jax(jax.tree_util.tree_map(np.array, jp)),
                   "port": tm.state_dict()}
            assert set(sds["jax"]) == set(sds["port"])
            for side, sd in sds.items():
                for name, t in sd.items():
                    leaf = re.sub(r"layers\.\d+\.", "layers.*.", name)
                    pooled[side].setdefault(leaf, []).append(t.double().flatten())
    for leaf in pooled["jax"]:
        a, b = (torch.cat(pooled[s][leaf]) for s in ("jax", "port"))
        if a.std() == 0:
            assert torch.equal(a, b), leaf
            continue
        n, sd = a.numel(), a.std().item()
        assert abs(a.mean() - b.mean()) <= 5 * sd / n ** 0.5, leaf
        assert abs(b.std().item() / sd - 1) <= 5 / (2 * n) ** 0.5, leaf
        if n >= 1000:
            amax = a.abs().max().item()
            assert abs(b.abs().max().item() - amax) <= 0.12 * amax, leaf
    j, p = np.array(losses["jax"]), np.array(losses["port"])
    spread = np.sqrt((j.var(ddof=1) + p.var(ddof=1)) / 2)
    assert abs(j.mean() - p.mean()) <= 4 * spread * np.sqrt(2 / 3), (j, p)


def test_untied_fairseq_checkpoint_is_refused():
    data, sd = _golden("lm_softmax_adaptive.npz")
    sd["decoder.adaptive_softmax.tail.0.2.weight"] = (
        sd["decoder.adaptive_softmax.tail.0.2.weight"] + 1.0)
    with pytest.raises(ValueError, match="not tied"):
        lm_state_dict_from_fairseq(sd)


def test_chunked_lse_matches_jax_over_several_chunks():
    from efficient_attention_tpu.models.adaptive_softmax import (
        _chunked_lse_and_target as jax_chunked,
    )
    from efficient_attention_torch.models.adaptive_softmax import (
        chunked_lse_and_target,
    )

    rng = np.random.default_rng(5)
    h = rng.standard_normal((3, 7, 24)).astype(np.float32)
    w = rng.standard_normal((53, 24)).astype(np.float32)  # 4 chunks of 16
    tgt = rng.integers(0, 53, (3, 7))
    gl, gt = (rng.standard_normal((3, 7)).astype(np.float32) for _ in range(2))

    def jax_loss(hh, ww):
        lse, t = jax_chunked(hh, ww, jnp.asarray(tgt), chunk_size=16)
        return jnp.sum(lse * gl + t * gt), (lse, t)

    (_, (lse, t)), (dh, dw) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(w))
    ht, wt = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    lse2, t2 = chunked_lse_and_target(ht, wt, torch.from_numpy(tgt), chunk=16)
    (lse2 * torch.from_numpy(gl) + t2 * torch.from_numpy(gt)).sum().backward()
    for a, b in ((lse2, lse), (t2, t)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, rtol=1e-5)
    for a, b in ((ht.grad, dh), (wt.grad, dw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-4)


def test_token_blocks_match_jax():
    from efficient_attention_tpu.data.text_data import TokenBlockDataset as JaxTB
    from efficient_attention_torch.data.text_data import TokenBlockDataset

    toks = np.arange(4, 104)
    a, b = TokenBlockDataset(toks, 17), JaxTB(toks, 17)
    assert len(a) == len(b) == 6
    for i in range(len(a)):
        np.testing.assert_array_equal(a[i], b[i])
    assert a[5][-1] == 1 and (a.sizes == b.sizes).all()


def test_schedule_and_nag_match_jax():
    from efficient_attention_tpu.training.optim import (
        cosine_tmult_schedule as jax_cosine,
        make_optimizer as jax_make_optimizer,
    )
    from efficient_attention_torch.training.optim import (
        cosine_tmult_schedule,
        make_optimizer,
    )

    kw = dict(warmup_steps=3, period=4, t_mult=2.0, min_lr=1e-3,
              warmup_init_lr=1e-2, lr_shrink=0.75, max_steps=40)
    mine, ref = cosine_tmult_schedule(0.5, **kw), jax_cosine(0.5, **kw)
    np.testing.assert_allclose([mine(i) for i in range(40)],
                               [float(ref(i)) for i in range(40)], rtol=1e-5)
    rng = np.random.default_rng(6)
    p0 = {"w": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    tx = jax_make_optimizer("nag", ref, weight_decay=0.0, clip_grad=0.5)
    jp, js = to_jax(p0), tx.init(to_jax(p0))
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = make_optimizer("nag", params.items(), mine, weight_decay=0.0,
                         clip_grad=0.5)
    for g in grads:
        upd, js = tx.update(to_jax(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-5)


def test_lm_trajectory_golden_replays():
    """60 fairseq NAG steps (cosine t-mult with lr_shrink, adaptive loss,
    clip 0.1) of the wiki103-structured causal-EVA LM from the reference's
    initial weights, as ``TestLMTrajectory`` replays them in JAX."""
    from efficient_attention_torch.training.optim import (
        cosine_tmult_schedule,
        make_optimizer,
    )

    data, sd0 = _golden("trajectory_lm_nag.npz", "sd0__")
    _, sdF = _golden("trajectory_lm_nag.npz", "sdF__")
    kw = dict(vocab_size=120, embed_dim=48, ffn_dim=96, num_layers=2,
              num_heads=2, attn_name="causal_eva",
              attn_args=dict(window_size=8, chunk_size=4, adaptive_proj="qk",
                             use_t5_rpe=True, causal=True),
              dropout=0.0, max_len=1024, adaptive_cutoffs=(40, 80),
              adaptive_input=True, tie_adaptive=True, final_norm=False)
    m = TransformerLM(**kw)
    m.load_state_dict(lm_state_dict_from_fairseq(sd0), strict=True)
    m.eval()  # the replay is deterministic, as the JAX one
    schedule = cosine_tmult_schedule(0.05, warmup_steps=8, period=16, t_mult=2.0,
                                     min_lr=1e-4, warmup_init_lr=1e-3,
                                     lr_shrink=0.75, max_steps=200)
    np.testing.assert_allclose([schedule(i) for i in range(60)], data["lrs"],
                               rtol=1e-5, atol=1e-9)
    opt = make_optimizer("nag", m.named_parameters(), schedule,
                         weight_decay=0.0, clip_grad=0.1, momentum=0.99)
    tokens = torch.from_numpy(data["tokens"])
    losses = []
    for i in range(tokens.shape[0]):
        opt.zero_grad()
        loss = m.loss(tokens[i, :, :-1], tokens[i, :, 1:]).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    ref = data["losses"]
    np.testing.assert_allclose(losses[:10], ref[:10], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(losses, ref, rtol=2e-2, atol=2e-2)
    final = lm_state_dict_from_fairseq(sdF)
    for name, p in m.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(), atol=2e-3,
                                   rtol=2e-2, err_msg=name)


def test_train_lm_cli_runs_on_cpu(tmp_path):
    """The CLI end to end at a tiny size: the wiki103 arch and the causal-EVA
    config, overridden to 2 narrow layers, 4 steps with validation."""
    from efficient_attention_torch.cli import train_lm

    stats = train_lm.cli_main([
        "--arch", "transformer_lm_wiki103",
        "--config", os.path.join(os.path.dirname(__file__), "..", "configs",
                                 "wikitext103_causal_eva.yaml"),
        "--dummy-data", "--dummy-vocab", "500", "--adaptive-cutoffs", "100,300",
        "--decoder-embed-dim", "128", "--decoder-ffn-embed-dim", "64",
        "--decoder-layers", "2", "--decoder-attention-heads", "2",
        "--decoder-attn-window-size", "16", "--decoder-attn-chunk-size", "4",
        "--tokens-per-sample", "32", "--max-tokens", "128", "--dropout", "0",
        "--max-update", "4", "--warmup-updates", "2", "--lr", "0.1",
        "--validate-interval-updates", "2", "--device", "cpu", "--bf16",
        "--save-dir", str(tmp_path)])
    assert stats["step"] == 4 and stats["valid_batches"] == 4
    assert np.isfinite(stats["loss"]) and np.isfinite(stats["valid_loss"])


@pytest.mark.parametrize("precision", [[], ["--bf16"]], ids=["f32", "bf16"])
def test_train_lm_cli_runs_adam_with_remat_and_layerdrop(tmp_path, precision):
    """The CLI with fairseq Adam, the inverse-sqrt schedule,
    ``--checkpoint-activations`` and decoder layerdrop 0.5, at dropout 0.1,
    in float32 and under ``--bf16``: 4 finite steps and a validation."""
    from efficient_attention_torch.cli import train_lm

    stats = train_lm.cli_main([
        "--dummy-data", "--dummy-vocab", "200", "--criterion", "cross_entropy",
        "--attn-name-decoder", "causal_eva", "--decoder-attn-window-size", "16",
        "--decoder-attn-chunk-size", "4", "--decoder-attn-causal",
        "--decoder-embed-dim", "32", "--decoder-ffn-embed-dim", "32",
        "--decoder-layers", "2", "--decoder-attention-heads", "2",
        "--tokens-per-sample", "32", "--max-tokens", "64", "--max-update", "4",
        "--optimizer", "adam", "--lr-scheduler", "inverse_sqrt", "--lr", "1e-3",
        "--warmup-updates", "2", "--checkpoint-activations",
        "--decoder-layerdrop", "0.5", "--device", "cpu",
        "--save-dir", str(tmp_path)] + precision)
    assert stats["step"] == 4
    assert np.isfinite(stats["loss"]) and np.isfinite(stats["valid_loss"])


def test_train_lm_unported_flags_raise():
    from efficient_attention_torch.cli import train_lm

    for extra in (["--pipeline-stages", "2"], ["--seq-parallel", "2"],
                  ["--base-layers", "1"], ["--tensorboard-logdir", "tb"],
                  ["--heartbeat-timeout", "5"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train_lm.main(train_lm.parse_args(
                ["--dummy-vocab", "500", "--device", "cpu"] + extra))

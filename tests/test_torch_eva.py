"""Attention modules of the PyTorch port against the JAX package.

The port's ``EVA`` (both its paths), ``LocalAttention`` and
``MultiheadAttention`` take the JAX modules' weights through
``state_dict_from_jax`` and must give the JAX eager outputs in float32 to
3e-5 abs / 1e-4 rel; the recorded reference goldens load with
``load_state_dict`` and must match to the same tolerance (that of
``test_goldens.py``).  On the CPU, EVA's ``impl='auto'`` takes the
single-kernel path through the plain version of ``eva_single``.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32, jax_apply, randomize, to_jax, torch_apply
from efficient_attention_tpu import AttentionFactory as JaxFactory
from efficient_attention_torch import AttentionFactory
from efficient_attention_torch.interop import load_jax_params
from efficient_attention_torch.ops import windows as W
from efficient_attention_torch.ops.kernels import eva_single as K

ATOL, RTOL = 3e-5, 1e-4
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

# (grid side, window, landmarks, heads, head dim)
GEOMETRIES = {
    "8x8-w4-j4": (8, 4, 4, 3, 16),
    "8x8-w2-j2": (8, 2, 16, 3, 16),
    "14x14-w7-j2": (14, 7, 49, 4, 12),
}


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def _eva_args(geometry, adaptive_proj):
    side, ws, landmarks, nh, d = GEOMETRIES[geometry]
    return {"dim": nh * d, "num_heads": nh, "window_size": ws,
            "num_landmarks": landmarks, "attn_2d": True, "use_rpe": True,
            "adaptive_proj": adaptive_proj}


@functools.lru_cache(maxsize=None)
def _jax_eva(geometry, adaptive_proj):
    """(x, flax params, JAX eager output) for one configuration."""
    args = _eva_args(geometry, adaptive_proj)
    side = GEOMETRIES[geometry][0]
    x = np.random.default_rng(1).standard_normal(
        (2, side, side, args["dim"])).astype(np.float32)
    m = JaxFactory.build_attention("eva", dict(args, impl="xla"))
    params = randomize(m.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=2)
    return x, params, jax_apply(m, params, x)


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("adaptive_proj", ["default", "no-ln", "none"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_eva_matches_jax(geometry, adaptive_proj, impl):
    x, params, ref = _jax_eva(geometry, adaptive_proj)
    m = AttentionFactory.build_attention(
        "eva", dict(_eva_args(geometry, adaptive_proj), impl=impl))
    load_jax_params(m, params)
    np.testing.assert_allclose(torch_apply(m, x), ref, atol=ATOL, rtol=RTOL)


def test_eva_auto_takes_the_single_kernel_path(monkeypatch):
    """impl='auto' goes through the eva_single wrapper where the gate
    allows it; impl='xla' never does."""
    x, params, _ = _jax_eva("8x8-w4-j4", "default")
    calls = []
    wrapper = K.eva_attention_single

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return wrapper(*args, **kwargs)

    monkeypatch.setattr("efficient_attention_torch.attention.eva."
                        "eva_attention_single", spy)
    for impl, expected in (("auto", 1), ("xla", 1)):
        m = AttentionFactory.build_attention(
            "eva", dict(_eva_args("8x8-w4-j4", "default"), impl=impl))
        torch_apply(load_jax_params(m, params), x)
        assert len(calls) == expected
    assert calls == [(2, 64, 144)]


def _golden(name):
    data = np.load(os.path.join(GOLDEN_DIR, name))
    sd = {k[len("param:"):]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("param:")}
    return data["x"], data["out"], sd


def _load_golden(module, sd):
    missing, unexpected = module.load_state_dict(sd, strict=False)
    assert missing in ([], ["relative_position_index"]) and not unexpected
    return module


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_golden_eva_2d_rpe(impl):
    x, ref, sd = _golden("eva_2d_rpe.npz")
    m = AttentionFactory.build_attention("eva", {
        "dim": 48, "num_heads": 4, "window_size": 4, "num_landmarks": 4,
        "attn_2d": True, "use_rpe": True, "adaptive_proj": "default",
        "impl": impl})
    out = torch_apply(_load_golden(m, sd), x)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_golden_local_2d_rpe():
    x, ref, sd = _golden("local_2d_rpe.npz")
    m = AttentionFactory.build_attention("local", {
        "dim": 48, "num_heads": 4, "window_size": 4, "attn_2d": True,
        "use_rpe": True})
    out = torch_apply(_load_golden(m, sd), x)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_golden_softmax_mha():
    x, ref, sd = _golden("softmax_mha.npz")
    m = AttentionFactory.build_attention("softmax", {"dim": 48, "num_heads": 4})
    m.load_state_dict(sd)
    np.testing.assert_allclose(torch_apply(m, x), ref, atol=ATOL, rtol=RTOL)


def test_local_matches_jax_with_padding_mask():
    args = {"dim": 48, "num_heads": 4, "window_size": 4, "attn_2d": True,
            "use_rpe": True}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 48)).astype(np.float32)
    mask = rng.random((2, 64)) < 0.2
    jm = JaxFactory.build_attention("local", args)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=6)
    ref = np.asarray(jm.apply(to_jax(params),
                              jnp.asarray(x), key_padding_mask=jnp.asarray(mask)))
    m = load_jax_params(AttentionFactory.build_attention("local", args), params)
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fp32", [False, True])
def test_softmax_matches_jax_with_padding_mask(fp32):
    args = {"dim": 48, "num_heads": 4, "fp32": fp32}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 48)).astype(np.float32)
    mask = rng.random((2, 16)) < 0.25
    jm = JaxFactory.build_attention("softmax", args)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=8)
    ref = np.asarray(jm.apply(to_jax(params),
                              jnp.asarray(x), key_padding_mask=jnp.asarray(mask)))
    m = load_jax_params(AttentionFactory.build_attention("softmax", args), params)
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


_EVA = {"dim": 48, "num_heads": 4, "window_size": 4, "num_landmarks": 4,
        "attn_2d": True, "use_rpe": True}


@pytest.mark.parametrize("args,error", [
    # the K11/K12 impls reach no unported configuration either
    (dict(_EVA, attn_2d=False, impl="pallas", seq_axis="seq"),
     NotImplementedError),
    (dict(_EVA, seq_axis="seq"), NotImplementedError),      # seq-parallel
    (dict(_EVA, impl="fast"), ValueError),                   # unknown impl
    (dict(_EVA, adaptive_proj="mlp"), NotImplementedError),
    (dict(_EVA, use_t5_rpe=True), NotImplementedError),      # both biases
])
def test_eva_unported_configurations_raise(args, error):
    with pytest.raises(error, match="ROADMAP|impl|adaptive_proj|simultaneously"):
        AttentionFactory.build_attention("eva", args)


def test_eva_unported_forwards_raise():
    """A 2-D key-padding mask runs eager, as in JAX, in training and at
    eval: the strict kernel impls raise before any compute."""
    x = torch.zeros(1, 8, 8, 48)
    mask = torch.zeros(1, 64, dtype=torch.bool)
    for impl in ("packed", "pallas"):
        m = AttentionFactory.build_attention("eva", dict(_EVA, impl=impl))
        for mode in (m.train, m.eval):
            with pytest.raises(ValueError, match="padding mask"):
                mode()(x, mask)


@pytest.mark.parametrize("name,match", [("flash", "unknown"),
                                        ("linformer", "unknown"),
                                        ("reformer", "unknown")])
def test_factory_unported_names(name, match):
    """Every name the JAX factory registers builds; others are unknown."""
    with pytest.raises(KeyError, match=match):
        AttentionFactory.build_attention(name, {"dim": 48, "num_heads": 4})


def test_factory_drops_unknown_keys():
    m = AttentionFactory.build_attention(
        "eva", dict(_EVA, name="eva", flash_block_size=64))
    assert m.num_landmarks == 4 and m.impl == "auto"
    assert not hasattr(m, "flash_block_size")


def test_factory_passes_the_eval_toggles():
    """The four eval toggles reach ``EVA`` through the factory, as every
    dataclass field does in JAX (``efficient_attention_tpu/__init__.py``),
    with JAX's defaults where they are not given."""
    m = AttentionFactory.build_attention("eva", _EVA)
    assert (m.use_single_kernel, m.use_megakernel, m.use_pallas_summaries,
            m.fuse_output_proj) == (True, False, False, False)
    m = AttentionFactory.build_attention("eva", dict(
        _EVA, use_single_kernel=False, use_megakernel=True,
        use_pallas_summaries=True, fuse_output_proj=True))
    assert (m.use_single_kernel, m.use_megakernel, m.use_pallas_summaries,
            m.fuse_output_proj) == (False, True, True, True)


def test_windows_and_rpe_match_jax():
    from efficient_attention_tpu.ops import rpe as jax_rpe
    from efficient_attention_tpu.ops import windows as jax_windows
    from efficient_attention_torch.ops import rpe

    x = np.random.default_rng(9).standard_normal((2, 3, 14, 14, 5)).astype(np.float32)
    parts = W.window_2d_partition(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(
        parts.numpy(), np.asarray(jax_windows.window_2d_partition(jnp.asarray(x), 7)))
    np.testing.assert_array_equal(W.window_2d_merge(parts, 7, (14, 14)).numpy(), x)
    for w, e in ((7, 0), (4, 0), (4, 2)):
        idx, size = rpe.local_2d_rpe_index(w, e)
        jidx, jsize = jax_rpe.local_2d_rpe_index(w, e)
        np.testing.assert_array_equal(idx, jidx)
        assert size == jsize
    assert rpe.local_2d_rpe_index(7, 0)[1] == 97


# ---- the training forward (RF noise injected on both sides) ----

from efficient_attention_tpu.attention.eva import EVA as JaxEVA  # noqa: E402
from efficient_attention_torch.attention.eva import EVA  # noqa: E402
from efficient_attention_torch.interop import state_dict_from_jax  # noqa: E402

GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


def _inject_noise(monkeypatch, noise):
    """Both packages' ``_sample_weights`` add ``noise`` ([B, C, nh, d]; its
    transpose where the sample has the natural [B, nh, C, d] layout)."""
    def port_sample(self, mu):
        if not self.training:
            return mu
        n = torch.from_numpy(noise)
        return mu + (n if tuple(mu.shape) == n.shape else n.transpose(1, 2))

    def jax_sample(self, mu, deterministic):
        if deterministic:
            return mu
        n = jnp.asarray(noise)
        return mu + (n if mu.shape == n.shape else jnp.swapaxes(n, 1, 2))

    monkeypatch.setattr(EVA, "_sample_weights", port_sample)
    monkeypatch.setattr(JaxEVA, "_sample_weights", jax_sample)


def _noise(geometry, seed=21):
    side, _, landmarks, nh, d = GEOMETRIES[geometry]
    assert landmarks != nh  # the two layouts are told apart by shape
    return np.random.default_rng(seed).standard_normal(
        (2, landmarks, nh, d)).astype(np.float32)


@pytest.mark.parametrize("adaptive_proj", ["default", "none"])
@pytest.mark.parametrize("geometry", ["8x8-w4-j4", "14x14-w7-j2"])
def test_training_summaries_match_jax(monkeypatch, geometry, adaptive_proj):
    """The training form of the packed chunk summaries against JAX
    ``_chunk_summaries_packed(..., deterministic=False)``."""
    x, params, _ = _jax_eva(geometry, adaptive_proj)
    noise = _noise(geometry)
    _inject_noise(monkeypatch, noise)
    side = GEOMETRIES[geometry][0]
    j = side // int(np.sqrt(GEOMETRIES[geometry][2]))
    dim = _eva_args(geometry, adaptive_proj)["dim"]
    qkv = np.random.default_rng(22).standard_normal(
        (2, side * side, 3 * dim)).astype(np.float32)
    jm = JaxFactory.build_attention(
        "eva", dict(_eva_args(geometry, adaptive_proj), impl="xla"))
    want = jm.apply(to_jax(params), jnp.asarray(qkv), (side, side), j, False,
                    method=JaxEVA._chunk_summaries_packed)
    m = load_jax_params(AttentionFactory.build_attention(
        "eva", _eva_args(geometry, adaptive_proj)), params).train()
    with torch.no_grad():
        got = m._chunk_summaries_packed(torch.from_numpy(qkv), (side, side), j)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)


@functools.lru_cache(maxsize=None)
def _jax_train(geometry):
    """(output, parameter gradients, input gradient) of the JAX module at
    deterministic=False, with the noise ``_inject_noise`` put in place."""
    x, params, _ = _jax_eva(geometry, "default")
    cot = np.random.default_rng(23).standard_normal(x.shape).astype(np.float32)
    jm = JaxFactory.build_attention("eva", dict(_eva_args(geometry, "default"),
                                                impl="xla"))

    def loss(p, xx):
        out = jm.apply(p, xx, deterministic=False)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        to_jax(params), jnp.asarray(x))
    return np.asarray(ref), jax.tree_util.tree_map(np.array, gp), np.asarray(gx)


# the kernel wrapper each impl's training forward calls
TRAIN_ROUTES = {"auto": ["eva_attention_packed"], "xla": [],
                "pallas": ["eva_attention_fused"],
                "rowmajor": ["eva_attention_rowmajor"]}


@pytest.mark.parametrize("impl", list(TRAIN_ROUTES))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_eva_train_mode_matches_jax(monkeypatch, geometry, impl):
    """Train-mode output and every gradient (parameters and input) against
    the JAX module at deterministic=False with the same noise.  'auto'
    takes the packed path (K1's plain versions on the CPU), 'pallas' K11,
    'rowmajor' K12 (their autograd Functions over the plain versions),
    'xla' the eager one."""
    x, params, _ = _jax_eva(geometry, "default")
    _inject_noise(monkeypatch, _noise(geometry))
    cot = np.random.default_rng(23).standard_normal(x.shape).astype(np.float32)
    ref, gp, gx = _jax_train(geometry)
    m = load_jax_params(AttentionFactory.build_attention(
        "eva", dict(_eva_args(geometry, "default"), impl=impl)), params).train()
    xt = torch.from_numpy(x).requires_grad_()
    calls = _spy_wrappers(monkeypatch)
    out = m(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    assert calls == TRAIN_ROUTES[impl]
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), gx, **GRAD_TOL)
    want = state_dict_from_jax(gp)
    named = dict(m.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   **GRAD_TOL, err_msg=name)


def test_eva_dispatch_order(monkeypatch):
    """Eval: K2 where its gate holds, else K1 on the deterministic
    summaries; training: K1 (eva.py:542-593)."""
    import efficient_attention_torch.attention.eva as eva_module

    calls = []
    for name in ("eva_attention_single", "eva_attention_packed"):
        monkeypatch.setattr(
            eva_module, name,
            lambda *a, _n=name, _f=getattr(eva_module, name), **k:
            calls.append(_n) or _f(*a, **k))
    x = torch.from_numpy(_jax_eva("8x8-w4-j4", "default")[0])
    for adaptive_proj, train, expected in (
            ("default", False, "eva_attention_single"),
            ("none", False, "eva_attention_packed"),   # K2 takes Dense (+LN)
            ("default", True, "eva_attention_packed")):
        m = AttentionFactory.build_attention(
            "eva", _eva_args("8x8-w4-j4", adaptive_proj)).train(train)
        with torch.no_grad():
            m(x)
        assert calls.pop() == expected and not calls


def test_eva_packed_impl_raises_outside_the_gate():
    # head dim 24 is outside the kernels' head dims
    m = AttentionFactory.build_attention("eva", dict(_EVA, num_heads=2,
                                                     impl="packed"))
    x = torch.zeros(1, 8, 8, 48)
    with pytest.raises(ValueError, match="impl='packed'"):
        m.train()(x)
    auto = AttentionFactory.build_attention("eva", dict(_EVA, num_heads=2))
    assert auto.train()(x).shape == x.shape  # 'auto' falls back to eager
    packed = AttentionFactory.build_attention("eva", dict(_EVA, impl="packed"))
    assert packed.train()(x).shape == x.shape


def test_rf_noise_comes_from_the_generator():
    m = AttentionFactory.build_attention("eva", _EVA).train()
    x = torch.from_numpy(np.random.default_rng(24).standard_normal(
        (1, 8, 8, 48)).astype(np.float32))
    outs = []
    for seed in (0, 0, 1):
        m.generator = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            outs.append(m(x))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    with torch.no_grad():
        assert torch.equal(m.eval()(x), m(x))  # no noise at eval


# ---- the eval routes (JAX eva.py:567-585) ----

# the non-default routes: toggles -> the kernel wrappers each runs, in order
ROUTES = {
    "K1": (dict(use_single_kernel=False), ["eva_attention_packed"]),
    "K8+K1": (dict(use_single_kernel=False, use_pallas_summaries=True),
              ["eva_summaries_packed", "eva_attention_packed"]),
    "K9": (dict(use_single_kernel=False, fuse_output_proj=True),
           ["eva_attention_packed_out"]),
    "K8+K9": (dict(use_single_kernel=False, use_pallas_summaries=True,
                   fuse_output_proj=True),
              ["eva_summaries_packed", "eva_attention_packed_out"]),
    "K10": (dict(use_single_kernel=False, use_megakernel=True),
            ["eva_summaries_from_x", "eva_attention_from_x"]),
}
_WRAPPERS = ("eva_attention_single", "eva_attention_packed",
             "eva_attention_packed_out", "eva_summaries_packed",
             "eva_summaries_from_x", "eva_attention_from_x",
             "eva_attention_fused", "eva_attention_rowmajor")


def _spy_wrappers(monkeypatch):
    """Record, in order, which kernel wrappers the EVA module calls."""
    import efficient_attention_torch.attention.eva as eva_module

    calls = []
    for name in _WRAPPERS:
        monkeypatch.setattr(
            eva_module, name,
            lambda *a, _n=name, _f=getattr(eva_module, name), **k:
            calls.append(_n) or _f(*a, **k))
    return calls


@pytest.mark.parametrize("adaptive_proj", ["default", "no-ln"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_eva_eval_routes_match_jax(monkeypatch, route, adaptive_proj):
    """Each non-default route of the port's EVA (the kernels' plain versions
    on the CPU) against the JAX module built with the same toggles, which on
    the CPU takes its XLA path whatever the toggles; eval, f32."""
    geometry = "8x8-w4-j4"
    toggles, wrappers = ROUTES[route]
    x, params, _ = _jax_eva(geometry, adaptive_proj)
    args = dict(_eva_args(geometry, adaptive_proj), **toggles)
    jm = JaxFactory.build_attention("eva", args)
    ref = np.asarray(jax.jit(lambda p, xx: jm.apply(p, xx, deterministic=True))(
        to_jax(params), jnp.asarray(x)))
    m = load_jax_params(AttentionFactory.build_attention("eva", args), params)
    calls = _spy_wrappers(monkeypatch)
    np.testing.assert_allclose(torch_apply(m, x), ref, atol=ATOL, rtol=RTOL)
    assert calls == wrappers


def _route_calls(monkeypatch, toggles, adaptive_proj="default", train=False,
                 failing_gates=()):
    """The wrappers one forward of the 8x8 EVA calls, with the named gates
    of the eva module made to fail."""
    import efficient_attention_torch.attention.eva as eva_module

    for gate in failing_gates:
        monkeypatch.setattr(eva_module, gate, lambda *a, **k: False)
    calls = _spy_wrappers(monkeypatch)
    m = AttentionFactory.build_attention(
        "eva", dict(_eva_args("8x8-w4-j4", adaptive_proj), **toggles))
    x = torch.from_numpy(_jax_eva("8x8-w4-j4", "default")[0])
    with torch.no_grad():
        m.train(train)(x)
    return calls


_ALL = dict(use_single_kernel=True, use_megakernel=True,
            use_pallas_summaries=True, fuse_output_proj=True)


@pytest.mark.parametrize("toggles,adaptive_proj,failing,expected", [
    ({}, "default", (), ["eva_attention_single"]),
    # K2 is tried before K10: the megakernel toggle alone still runs K2
    (dict(use_megakernel=True), "default", (), ["eva_attention_single"]),
    (_ALL, "default", (), ["eva_attention_single"]),
    # where K2's gate fails, the megakernel takes over
    (dict(use_megakernel=True), "default", ("supports_single",),
     ["eva_summaries_from_x", "eva_attention_from_x"]),
    # a failing gate falls through to the next route, down to K11 (JAX's
    # auto fallback, eva.py:767-793), then eager
    (dict(_ALL, use_single_kernel=False), "default", ("supports_mega",),
     ["eva_summaries_packed", "eva_attention_packed_out"]),
    (dict(_ALL, use_single_kernel=False), "default",
     ("supports_mega", "supports_summaries", "supports_packed_out"),
     ["eva_attention_packed"]),
    (dict(_ALL, use_single_kernel=False), "default",
     ("supports_mega", "supports_packed"), ["eva_attention_fused"]),
    # K8 and K10 take the adaptive Dense (+LN) only: 'none' falls through
    (dict(_ALL, use_single_kernel=False), "none", (),
     ["eva_attention_packed_out"]),
    (dict(_ALL, use_single_kernel=False), "default",
     ("supports_mega", "supports_packed", "supports_fused"), []),
    (dict(impl="pallas"), "default", (), ["eva_attention_fused"]),
    (dict(_ALL, impl="rowmajor"), "default", (), ["eva_attention_rowmajor"]),
    # rowmajor falls back to K11 where K12's gate fails
    (dict(impl="rowmajor"), "default", ("supports_rowmajor",),
     ["eva_attention_fused"]),
    (dict(impl="rowmajor"), "default", ("supports_rowmajor", "supports_fused"),
     []),
    (dict(impl="xla"), "default", (), []),
])
def test_eva_eval_dispatch(monkeypatch, toggles, adaptive_proj, failing, expected):
    assert _route_calls(monkeypatch, toggles, adaptive_proj,
                        failing_gates=failing) == expected


@pytest.mark.parametrize("toggles", [_ALL, dict(_ALL, use_single_kernel=False)])
def test_eva_training_ignores_the_eval_toggles(monkeypatch, toggles):
    """In training every toggle is ignored, as in JAX: K1 alone."""
    assert _route_calls(monkeypatch, toggles, train=True) == [
        "eva_attention_packed"]


def test_eva_training_with_toggles_is_exactly_without():
    """Train-mode output and every gradient with all four toggles set equal
    those with none, bit for bit (the same RF noise from the generator)."""
    x = torch.from_numpy(_jax_eva("8x8-w4-j4", "default")[0])
    cot = torch.from_numpy(np.random.default_rng(25).standard_normal(
        x.shape).astype(np.float32))
    results = []
    for toggles in ({}, dict(_ALL, use_single_kernel=False)):
        torch.manual_seed(0)
        m = AttentionFactory.build_attention(
            "eva", dict(_eva_args("8x8-w4-j4", "default"), **toggles)).train()
        m.generator = torch.Generator().manual_seed(26)
        xt = x.clone().requires_grad_()
        out = m(xt)
        (out * cot).sum().backward()
        results.append([out.detach(), xt.grad]
                       + [p.grad for p in m.parameters()])
    for a, b in zip(*results):
        assert torch.equal(a, b)


# ---- the K11 and K12 routes (JAX eva.py:595-793) ----

@pytest.mark.parametrize("impl,wrapper", [("pallas", "eva_attention_fused"),
                                          ("rowmajor", "eva_attention_rowmajor")])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_eva_kernel_routes_match_jax(monkeypatch, geometry, impl, wrapper):
    """Eval: 'pallas' through K11 and 'rowmajor' through K12 (their plain
    versions on the CPU) against the JAX eager module, f32."""
    x, params, ref = _jax_eva(geometry, "default")
    m = load_jax_params(AttentionFactory.build_attention(
        "eva", dict(_eva_args(geometry, "default"), impl=impl)), params)
    calls = _spy_wrappers(monkeypatch)
    np.testing.assert_allclose(torch_apply(m, x), ref, atol=ATOL, rtol=RTOL)
    assert calls == [wrapper]


@pytest.mark.parametrize("train", [False, True])
def test_eva_auto_falls_back_to_k11(monkeypatch, train):
    """'auto' where the packed path does not engage (K1's and K2's gates
    made to fail) takes K11, in training and at eval."""
    assert _route_calls(monkeypatch, {}, train=train, failing_gates=(
        "supports_single", "supports_packed")) == ["eva_attention_fused"]


@pytest.mark.parametrize("args", [dict(_EVA, impl="pallas", attn_drop=0.1),
                                  dict(_EVA, impl="pallas", num_heads=16)])
def test_eva_pallas_raises_before_any_compute(monkeypatch, args):
    """impl='pallas' with attention dropout, or with a head dim K11 is not
    built for (3), raises ValueError before the projection runs."""
    m = AttentionFactory.build_attention("eva", args)
    monkeypatch.setattr(m, "qkv", None)  # any compute would fail otherwise
    for mode in (m.train, m.eval):
        with pytest.raises(ValueError, match="impl='pallas'"):
            mode()(torch.zeros(1, 8, 8, 48))


_EVA_1D = dict(dim=48, num_heads=3, window_size=8, num_landmarks=8,
               attn_2d=False, adaptive_proj="no-ln")


@functools.lru_cache(maxsize=None)
def _jax_eva_1d(bias_kind, train):
    """x [2, 64, 48], flax params, and the JAX eager module's output and
    gradients (train: deterministic=False with ``_inject_noise``'s noise)
    for 1-D EVA without halo, with the learned or the T5 bias."""
    args = dict(_EVA_1D, **{"learned": dict(use_rpe=True),
                            "t5": dict(use_t5_rpe=True)}[bias_kind])
    x = np.random.default_rng(31).standard_normal((2, 64, 48)).astype(np.float32)
    cot = np.random.default_rng(32).standard_normal(x.shape).astype(np.float32)
    jm = JaxEVA(impl="xla", **args)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 33)

    def loss(p, xx):
        out = jm.apply(p, xx, deterministic=not train)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(to_jax(params), jnp.asarray(x))
    return (args, x, cot, params, np.asarray(ref),
            jax.tree_util.tree_map(np.array, gp), np.asarray(gx))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("impl", ["pallas", "rowmajor"])
@pytest.mark.parametrize("bias_kind", ["learned", "t5"])
def test_eva_1d_k11_route_matches_jax(monkeypatch, bias_kind, impl, train):
    """1-D without halo or padding: 'pallas' and 'rowmajor' take K11 (not
    K4, at eval too) and match the JAX eager module's output and, in
    training with the same RF noise, every gradient."""
    import efficient_attention_torch.attention.eva as eva_module

    _inject_noise(monkeypatch, np.random.default_rng(34).standard_normal(
        (2, 8, 3, 16)).astype(np.float32))
    args, x, cot, params, ref, gp, gx = _jax_eva_1d(bias_kind, train)
    m = load_jax_params(AttentionFactory.build_attention(
        "eva", dict(args, impl=impl)), params).train(train)
    calls = _spy_wrappers(monkeypatch)
    monkeypatch.setattr(eva_module, "eva_attention_1d",
                        lambda *a, **k: calls.append("eva_attention_1d"))
    xt = torch.from_numpy(x).requires_grad_()
    out = m(xt)
    assert calls == ["eva_attention_fused"]
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL, rtol=RTOL)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), gx, **GRAD_TOL)
    named = dict(m.named_parameters())
    for name, g in state_dict_from_jax(gp).items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   **GRAD_TOL, err_msg=name)


def _1d_calls(monkeypatch, impl="auto", train=False, N=64, mask=False, **kw):
    import efficient_attention_torch.attention.eva as eva_module

    calls = _spy_wrappers(monkeypatch)
    real = eva_module.eva_attention_1d
    monkeypatch.setattr(eva_module, "eva_attention_1d", lambda *a, **k:
                        calls.append("eva_attention_1d") or real(*a, **k))
    m = AttentionFactory.build_attention(
        "eva", dict(_EVA_1D, use_rpe=True, impl=impl, **kw)).train(train)
    with torch.no_grad():
        m(torch.zeros(2, N, 48),
          torch.zeros(2, N, dtype=torch.bool) if mask else None)
    return calls


@pytest.mark.parametrize("kw,expected", [
    (dict(train=True), ["eva_attention_fused"]),
    (dict(train=True, N=60), []),          # padded to a window multiple
    (dict(train=True, mask=True), []),     # a padding mask given
    (dict(train=True, overlap_window=True), []),  # a halo
    (dict(train=True, attn_drop=0.1), []),
    (dict(), ["eva_attention_1d"]),        # eval: K4 first
    (dict(impl="pallas"), ["eva_attention_fused"]),
    (dict(impl="rowmajor", train=True), ["eva_attention_fused"]),
    (dict(impl="xla", train=True), []),
])
def test_eva_1d_dispatch(monkeypatch, kw, expected):
    """1-D: 'auto' in training takes K11 only on input free of padding,
    without halo or attention dropout; at eval K4 first; 'pallas' takes
    K11, not K4."""
    assert _1d_calls(monkeypatch, **kw) == expected


@pytest.mark.parametrize("kw", [dict(N=60), dict(mask=True),
                                dict(overlap_window=True), dict(attn_drop=0.1)])
def test_eva_1d_pallas_raises_where_k11_cannot_run(monkeypatch, kw):
    for train in (False, True):
        with pytest.raises(ValueError, match="impl='pallas'"):
            _1d_calls(monkeypatch, impl="pallas", train=train, **kw)


def test_factory_passes_impl():
    """``impl`` reaches ``EVA`` through the attention args dict, as the
    chip script sets it (no CLI flag, as in JAX)."""
    for impl in ("pallas", "rowmajor"):
        assert AttentionFactory.build_attention("eva", dict(_EVA, impl=impl)).impl == impl

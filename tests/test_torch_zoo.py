"""The rest of the attention zoo on the PyTorch port against the JAX
package, on the CPU, in float32 with numpy-drawn weights.

* ``ops/log_ops.py`` (with ``-inf`` inputs and the ``mask=(1, -1)``
  log-subtract) and ``ops/misc.future_mask``: to 1e-6;
* the halo'd window partitions, ``pad_val`` 0 and ``-inf``: exact;
* ``LocalAttention`` in 2-D with a halo (with and without RPE, with a
  mask) and in 1-D (a length that is not a window multiple, with and
  without a mask);
* 2-D ``EVA`` with a halo, with a key-padding mask and with T5 RPE, at
  eval and in training with the RF noise injected on both sides;
* ``ra`` (``RandomizedAttention``) at ``num_samples`` -1, 0 and 1, the
  last with the same key indices on both sides (``jax.random.categorical``
  patched, and the port's ``_sample_key_indices``), in training with the
  proposal noise injected, with and without a mask;
* ``scatterbrain`` in 1-D and 2-D, with and without RPE, with a mask, at
  eval (the JAX eval projection copied in) and in training with the
  projection injected; the recorded reference golden loaded strictly;
* the factory building both from parsed flags.

Forward outputs to 3e-5 abs / 1e-4 rel (``test_goldens.py``'s tolerance);
training outputs likewise, gradients of the input and every parameter to
1e-4 abs / 1e-3 rel.
"""
import argparse
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32, randomize, to_jax
from efficient_attention_tpu import AttentionFactory as JaxFactory
from efficient_attention_tpu.attention.eva import EVA as JaxEVA
from efficient_attention_tpu.attention.scatterbrain import ScatterBrain as JaxScatterBrain
from efficient_attention_tpu.ops.random_features import create_proj_matrix as jax_proj
from efficient_attention_torch import AttentionFactory, NestedNamespace, namespace_to_dict
from efficient_attention_torch.attention.eva import EVA
from efficient_attention_torch.attention.randomized import RandomizedAttention
from efficient_attention_torch.attention.scatterbrain import ScatterBrain
from efficient_attention_torch.interop import load_jax_params, state_dict_from_jax
from efficient_attention_torch.ops import log_ops, misc
from efficient_attention_torch.ops import windows as W

ATOL, RTOL = 3e-5, 1e-4
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "scatterbrain.npz")


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


# ---- ops


def test_log_ops_match_jax():
    from efficient_attention_tpu.ops import log_ops as jax_log_ops
    from efficient_attention_tpu.ops import misc as jax_misc

    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5, 7)).astype(np.float32)
    b = a - np.abs(rng.standard_normal(a.shape)).astype(np.float32) - 0.1
    b[0, 0] = -np.inf  # a log-density of 0, as a masked key gives
    for mask in (None, (1, -1)):
        got = log_ops.log_add_exp(torch.from_numpy(a), torch.from_numpy(b), mask=mask)
        want = jax_log_ops.log_add_exp(jnp.asarray(a), jnp.asarray(b), mask=mask)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    v1, v2 = a[0], rng.standard_normal((7, 4)).astype(np.float32)
    np.testing.assert_allclose(
        log_ops.log_matmul_exp(torch.from_numpy(v1), torch.from_numpy(v2)).numpy(),
        np.asarray(jax_log_ops.log_matmul_exp(jnp.asarray(v1), jnp.asarray(v2))),
        rtol=1e-6, atol=1e-6)
    keep = rng.random(a.shape) < 0.7
    for mask in (None, keep):
        for axis, keepdims in ((-1, False), (1, True)):
            got = log_ops.log_avg_exp(torch.from_numpy(a), None if mask is None
                                      else torch.from_numpy(mask), axis=axis,
                                      keepdims=keepdims)
            want = jax_log_ops.log_avg_exp(jnp.asarray(a), None if mask is None
                                           else jnp.asarray(mask), axis=axis,
                                           keepdims=keepdims)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-6)
    for n in (1, 5):
        np.testing.assert_array_equal(misc.future_mask(n), jax_misc.future_mask(n))


@pytest.mark.parametrize("pad_val", [0.0, -np.inf], ids=["zero", "neg-inf"])
def test_halo_partitions_match_jax(pad_val):
    from efficient_attention_tpu.ops import windows as jax_windows

    x = np.random.default_rng(1).standard_normal((2, 3, 8, 12, 5)).astype(np.float32)
    for w, e in ((4, 0), (4, 1), (4, 2), (2, 1)):
        np.testing.assert_array_equal(
            W.window_2d_partition(torch.from_numpy(x), w, e, pad_val).numpy(),
            np.asarray(jax_windows.window_2d_partition(jnp.asarray(x), w, e, pad_val)))
    s = x.reshape(2, 3, 96, 5)
    np.testing.assert_array_equal(
        W.window_1d_partition(torch.from_numpy(s), 8, 4, pad_val).numpy(),
        np.asarray(jax_windows.window_1d_partition(jnp.asarray(s), 8, 4, pad_val)))


# ---- the modules, at eval and in training


def _mask(shape, seed=3, p=0.2):
    """A key-padding mask of ``shape`` that leaves every row's first key."""
    m = np.random.default_rng(seed).random(shape) < p
    m[:, 0] = False
    return m


@functools.lru_cache(maxsize=None)
def _jax_case(name, items, shape, masked):
    """(x, mask, flax params, JAX module) of one configuration."""
    args = dict(items)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    n = int(np.prod(shape[1:-1]))
    mask = _mask((shape[0], n)) if masked else None
    jm = JaxFactory.build_attention(name, dict(args, impl="xla") if name in (
        "eva", "local") else args)
    params = randomize(jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0),
                         "sample": jax.random.PRNGKey(1)}, jnp.asarray(x))), seed=2)
    return x, mask, params, jm


def _jax_forward(jm, params, x, mask, train, cot):
    """(output, parameter gradients, input gradient) of the JAX module,
    jitted (the gradients only in training)."""
    kpm = None if mask is None else jnp.asarray(mask)
    rngs = {"sample": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)}
    if not train:
        out = jax.jit(lambda p, xx: jm.apply(p, xx, kpm, deterministic=True))(
            to_jax(params), jnp.asarray(x))
        return np.asarray(out), None, None

    def loss(p, xx):
        out = jm.apply(p, xx, kpm, deterministic=False, rngs=rngs)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(to_jax(params), jnp.asarray(x))
    return np.asarray(out), jax.tree_util.tree_map(np.array, gp), np.asarray(gx)


def _check(name, args, shape, masked, train, random_proj=None):
    """The port against the JAX module: the output, and in training every
    gradient."""
    x, mask, params, jm = _jax_case(name, tuple(sorted(args.items())), shape, masked)
    cot = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    ref, gp, gx = _jax_forward(jm, params, x, mask, train, cot)
    m = load_jax_params(AttentionFactory.build_attention(name, args), params,
                        random_proj=random_proj)
    m.train(train)
    xt = torch.from_numpy(x).requires_grad_(train)
    out = m(xt, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL, rtol=RTOL)
    if not train:
        return
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), gx, **GRAD_TOL)
    want = state_dict_from_jax(gp)
    named = dict(m.named_parameters())
    assert set(want) == set(named)
    for key, g in want.items():
        np.testing.assert_allclose(named[key].grad.numpy(), g.numpy(), **GRAD_TOL,
                                   err_msg=key)


LOCAL = {
    "2d-halo-rpe": (dict(dim=48, num_heads=4, window_size=4, attn_2d=True,
                         overlap_window=True, use_rpe=True), (2, 8, 8, 48)),
    "2d-halo": (dict(dim=48, num_heads=4, window_size=4, attn_2d=True,
                     overlap_window=True), (2, 8, 8, 48)),
    "1d-rpe": (dict(dim=48, num_heads=3, window_size=8, use_rpe=True), (2, 21, 48)),
    "1d-halo": (dict(dim=48, num_heads=3, window_size=8, overlap_window=True,
                     use_rpe=True), (2, 21, 48)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("case", list(LOCAL))
def test_local_attention_matches_jax(case, masked, train):
    args, shape = LOCAL[case]
    _check("local", args, shape, masked, train)


def test_local_halo_and_1d_stay_off_the_packed_kernel(monkeypatch):
    """K7's gate is JAX's: 2-D, no halo, no mask, no attention dropout."""
    calls = []
    monkeypatch.setattr("efficient_attention_torch.attention.local."
                        "local_attention_packed",
                        lambda *a, **k: calls.append(1))
    for case in ("2d-halo-rpe", "1d-rpe"):
        args, shape = LOCAL[case]
        m = AttentionFactory.build_attention("local", args).eval()
        with torch.no_grad():
            assert m(torch.zeros(shape)).shape == shape
    assert calls == []


EVA2D = dict(dim=48, num_heads=3, window_size=4, num_landmarks=4, attn_2d=True)
EVA_CASES = {
    "halo-rpe": (dict(EVA2D, overlap_window=True, use_rpe=True), False),
    "halo-none": (dict(EVA2D, overlap_window=True, adaptive_proj="none"), False),
    "mask-rpe": (dict(EVA2D, use_rpe=True), True),
    "t5": (dict(EVA2D, use_t5_rpe=True), False),
    "t5-halo-mask": (dict(EVA2D, use_t5_rpe=True, overlap_window=True), True),
}


def _inject_eva_noise(monkeypatch, shape):
    """Both packages' ``_sample_weights`` add the same noise: ``[B, H, C,
    d]``, transposed where the sample is packed ``[B, C, H, d]``."""
    noise = np.random.default_rng(21).standard_normal(shape).astype(np.float32)

    def port(self, mu):
        if not self.training:
            return mu
        n = torch.from_numpy(noise)
        return mu + (n if tuple(mu.shape) == n.shape else n.transpose(1, 2))

    def jax_(self, mu, deterministic):
        if deterministic:
            return mu
        n = jnp.asarray(noise)
        return mu + (n if mu.shape == n.shape else jnp.swapaxes(n, 1, 2))

    monkeypatch.setattr(EVA, "_sample_weights", port)
    monkeypatch.setattr(JaxEVA, "_sample_weights", jax_)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(EVA_CASES))
def test_eva_2d_halo_mask_t5_matches_jax(monkeypatch, case, train):
    """The eager masked route (halo or mask) and, for T5 alone, the
    kernels' plain versions (K2 at eval, K1 in training) with the T5
    bias."""
    args, masked = EVA_CASES[case]
    _inject_eva_noise(monkeypatch, (2, 3, 4, 16))
    _check("eva", args, (2, 8, 8, 48), masked, train)


def test_eva_2d_masked_route_raises_for_strict_impls():
    """A halo or a mask keeps every kernel off, as in JAX: ``packed`` and
    ``pallas`` raise, ``rowmajor`` and ``xla`` run eager."""
    x = torch.zeros(1, 8, 8, 48)
    mask = torch.zeros(1, 64, dtype=torch.bool)
    for impl, raises in (("packed", True), ("pallas", True), ("rowmajor", False),
                         ("xla", False)):
        for args, kpm in ((dict(EVA2D, overlap_window=True), None), (EVA2D, mask)):
            m = AttentionFactory.build_attention("eva", dict(args, impl=impl)).eval()
            if raises:
                with pytest.raises(ValueError, match="halo"):
                    m(x, kpm)
            else:
                assert m(x, kpm).shape == x.shape


RA_CASES = {"grid": ((2, 8, 8, 48), False), "seq-mask": ((2, 24, 48), True)}


def _inject_ra(monkeypatch, shape, heads):
    n = int(np.prod(shape[1:-1]))
    rng = np.random.default_rng(31)
    idx = rng.integers(0, n, (shape[0], heads, n))
    noise = rng.standard_normal((shape[0], heads, n, shape[-1] // heads)).astype(np.float32)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.asarray(idx))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    monkeypatch.setattr(RandomizedAttention, "_sample_key_indices",
                        lambda self, pi: torch.from_numpy(idx))
    monkeypatch.setattr(RandomizedAttention, "_proposal_noise",
                        lambda self, shape, like: torch.from_numpy(noise))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(RA_CASES))
@pytest.mark.parametrize("num_samples", [-1, 0, 1])
def test_ra_matches_jax(monkeypatch, num_samples, case, train):
    shape, masked = RA_CASES[case]
    _inject_ra(monkeypatch, shape, 3)
    _check("ra", dict(dim=48, num_heads=3, num_samples=num_samples), shape, masked,
           train)


def test_ra_draws_from_its_generator():
    """The key draw follows ``pi`` and its generator; without one a
    generator seeded 0 makes eval repeatable."""
    m = RandomizedAttention(48, 3)
    pi = torch.softmax(torch.randn(2, 3, 5, 7, generator=torch.Generator().manual_seed(0)),
                       dim=-1)
    assert torch.equal(m._sample_key_indices(pi), m._sample_key_indices(pi))
    m.generator = torch.Generator().manual_seed(5)
    a = m._sample_key_indices(pi)
    m.generator = torch.Generator().manual_seed(5)
    assert torch.equal(a, m._sample_key_indices(pi)) and a.shape == (2, 3, 5)
    onehot = torch.zeros(1, 1, 4, 6)
    onehot[..., 4] = 1.0
    assert (m._sample_key_indices(onehot) == 4).all()
    # the empirical frequencies of one row follow its probabilities
    row = torch.tensor([0.1, 0.6, 0.3]).expand(1, 1, 20000, 3)
    freq = torch.bincount(m._sample_key_indices(row).reshape(-1), minlength=3) / 20000
    np.testing.assert_allclose(freq.numpy(), [0.1, 0.6, 0.3], atol=0.02)


SB = dict(dim=48, num_heads=4, approx_attn_dim=32)
SB_CASES = {
    "2d": (dict(SB, window_size=4, attn_2d=True), (2, 8, 8, 48), False),
    "2d-rpe-mask": (dict(SB, window_size=4, attn_2d=True, use_rpe=True),
                    (2, 8, 8, 48), True),
    "2d-halo-rpe": (dict(SB, window_size=4, attn_2d=True, use_rpe=True,
                         overlap_window=True), (2, 8, 8, 48), False),
    "1d-rpe": (dict(SB, window_size=8, use_rpe=True), (2, 21, 48), False),
    "1d-halo-mask": (dict(SB, window_size=8, overlap_window=True), (2, 21, 48), True),
}


def _eval_projection(args):
    return np.asarray(jax_proj(jax.random.PRNGKey(0), args["num_heads"],
                               args["approx_attn_dim"],
                               args["dim"] // args["num_heads"], ortho=True))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(SB_CASES))
def test_scatterbrain_matches_jax(monkeypatch, case, train):
    args, shape, masked = SB_CASES[case]
    proj = _eval_projection(args)
    if train:  # the same training projection on both sides
        proj = (proj + np.random.default_rng(41).standard_normal(proj.shape)
                ).astype(np.float32)
        monkeypatch.setattr(JaxScatterBrain, "get_proj_matrix",
                            lambda self, deterministic, dtype: jnp.asarray(proj))
        monkeypatch.setattr(ScatterBrain, "get_proj_matrix",
                            lambda self, like: torch.from_numpy(proj))
    _check("scatterbrain", args, shape, masked, train, random_proj=proj)


def test_scatterbrain_golden_loads_strictly():
    """``scatterbrain.npz`` (``test_goldens.py``'s configuration: 2-D
    windows of 4, learnable favorp, 32 features) with
    ``load_state_dict(strict=True)``, within that test's tolerance."""
    data = np.load(GOLDEN)
    sd = {k[len("param:"):]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("param:")}
    m = AttentionFactory.build_attention("scatterbrain", {
        "dim": 48, "num_heads": 4, "window_size": 4, "attn_2d": True,
        "proj_method": "favorp", "sample_scheme": "learnable",
        "approx_attn_dim": 32})
    m.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(data["x"])).numpy()
    np.testing.assert_allclose(out, data["out"], atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("name,argv,expect", [
    ("ra", ["--attn-num-samples", "-1"], dict(num_samples=-1)),
    ("ra", [], dict(num_samples=1)),
    ("scatterbrain", ["--attn-window-size", "7", "--attn-attn-2d", "--attn-use-rpe",
                      "--attn-approx-attn-dim", "64"],
     dict(window_size=7, attn_2d=True, use_rpe=True, approx_attn_dim=64)),
    ("scatterbrain", ["--attn-overlap-window"],
     dict(window_size=4, overlap_window=True, ext_size=2, approx_attn_dim=64)),
])
def test_factory_builds_from_parsed_flags(name, argv, expect):
    """Both packages' ``add_attn_specific_args`` register the same flags
    with the same defaults, and the port's factory builds the module from
    the parsed namespace."""
    from efficient_attention_tpu import NestedNamespace as JaxNamespace
    from efficient_attention_tpu import namespace_to_dict as jax_to_dict

    ours = AttentionFactory.add_attn_specific_args(
        argparse.ArgumentParser(), name, struct_name="attn_args", prefix="attn")
    theirs = JaxFactory.add_attn_specific_args(
        argparse.ArgumentParser(), name, struct_name="attn_args", prefix="attn")
    assert ({a.dest: a.default for a in ours._actions}
            == {a.dest: a.default for a in theirs._actions})
    got = namespace_to_dict(ours.parse_args(argv, namespace=NestedNamespace()).attn_args)
    assert got == jax_to_dict(theirs.parse_args(argv, namespace=JaxNamespace()).attn_args)
    m = AttentionFactory.build_attention(name, dict(got, dim=48, num_heads=4))
    assert type(m).__name__ == {"ra": "RandomizedAttention",
                                "scatterbrain": "ScatterBrain"}[name]
    for key, value in expect.items():
        assert getattr(m, key) == value, key

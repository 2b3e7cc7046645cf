"""K9 ``eva_packed_out`` and K10 ``eva_mega`` of the PyTorch port against the
JAX package.

The port's plain versions (what the CUDA kernels are held against on the
card) must compute what the TPU kernels compute: each is compared with its
Pallas kernel in interpret mode on the same numpy inputs, in float32, at the
JAX package's own geometry of these kernels (``test_pallas.py:691, 716``:
B=2, an 8x8 grid, 3 heads of 16) and tolerance: 2e-5 abs / 1e-4 rel for K9
(``test_pallas.py:707``), 3e-5 / 1e-4 for K10 (``:747, 778``).  The CUDA
kernels run only on a card (``test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32
from efficient_attention_tpu.ops.pallas import eva_mega as jax_k10
from efficient_attention_tpu.ops.pallas import eva_packed as jax_k9
from efficient_attention_torch.ops.kernels import eva_mega as K10
from efficient_attention_torch.ops.kernels import eva_packed as K9

B, G, DIM, NH, WS = 2, 8, 48, 3, 4
D = DIM // NH


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def _rng(seed):
    rng = np.random.default_rng(seed)
    return lambda *s: rng.standard_normal(s).astype(np.float32)


def _tokens(seed=1):
    """x, Wqkv and bqkv as test_pallas.py:715-722 makes them."""
    f = _rng(seed)
    return (f(B, G * G, DIM), 0.1 * f(DIM, 3 * DIM),
            np.linspace(-0.1, 0.1, 3 * DIM).astype(np.float32))


def _attention_operands(seed, C, with_bias):
    f = _rng(seed)
    return (f(B, C, DIM), f(B, C, DIM), 0.1 * f(DIM, DIM), 0.1 * f(DIM),
            f(NH, WS * WS, WS * WS) if with_bias else None)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def test_summaries_from_x_matches_jax():
    """16 landmarks (2x2 chunks), Dense + LN with drawn weights."""
    x, wqkv, bqkv = _tokens()
    f = _rng(2)
    weights = [0.2 * f(D, D), 0.1 * f(D), 0.2 * f(D, D), 0.1 * f(D),
               1 + 0.1 * f(D), 0.1 * f(D), 1 + 0.1 * f(D), 0.1 * f(D)]
    got = K10.eva_summaries_from_x_ref(_t(x), _t(wqkv), _t(bqkv),
                                       *map(_t, weights), NH, G, 2, True)
    want = jax_k10.eva_summaries_from_x(_j(x), _j(wqkv), _j(bqkv),
                                        *map(_j, weights), nh=NH, gw=G, j=2,
                                        use_ln=True, interpret=True)
    for a, b in zip(got, want):
        assert a.shape == (B, 16, DIM)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_from_x_matches_jax(with_bias):
    x, wqkv, bqkv = _tokens()
    rf, beta, wo, bo, bias = _attention_operands(3, 16, with_bias)
    got = K10.eva_attention_from_x_ref(_t(x), _t(wqkv), _t(bqkv), _t(rf),
                                       _t(beta), _t(wo), _t(bo), D ** -0.5, NH,
                                       G, WS, bias=_t(bias))
    want = jax_k10.eva_attention_from_x(_j(x), _j(wqkv), _j(bqkv), _j(rf),
                                        _j(beta), _j(wo), _j(bo), D ** -0.5, NH,
                                        G, WS, bias=_j(bias), interpret=True)
    assert got.shape == (B, G * G, DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("with_bias", [False, True])
def test_packed_out_matches_jax(with_bias):
    """4 landmarks (4x4 chunks), as test_pallas.py:691."""
    qkv = _rng(4)(B, G * G, 3 * DIM)
    rf, beta, wo, bo, bias = _attention_operands(5, 4, with_bias)
    got = K9.eva_packed_out_ref(_t(qkv), _t(rf), _t(beta), _t(wo), _t(bo),
                                D ** -0.5, NH, G, WS, bias=_t(bias))
    want = jax_k9.eva_attention_packed_out(_j(qkv), _j(rf), _j(beta), _j(wo),
                                           _j(bo), D ** -0.5, NH, G, WS,
                                           bias=_j(bias), interpret=True)
    assert got.shape == (B, G * G, DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_cpu_tensors_take_plain_versions():
    x, wqkv, bqkv = _tokens()
    rf, beta, wo, bo, bias = map(_t, _attention_operands(6, 16, True))
    x, wqkv, bqkv = map(_t, (x, wqkv, bqkv))
    f = _rng(7)
    weights = [_t(0.2 * f(D, D)), _t(0.1 * f(D)), _t(0.2 * f(D, D)),
               _t(0.1 * f(D))] + [None] * 4
    qkv = K10.project_qkv(x, wqkv, bqkv)
    before = (K9.LAUNCHES_OUT, K10.LAUNCHES_SUMMARIES, K10.LAUNCHES_ATTENTION)
    pairs = [
        (K9.eva_attention_packed_out(qkv, rf, beta, wo, bo, 0.25, NH, G, WS, bias),
         K9.eva_packed_out_ref(qkv, rf, beta, wo, bo, 0.25, NH, G, WS, bias)),
        (K10.eva_attention_from_x(x, wqkv, bqkv, rf, beta, wo, bo, 0.25, NH, G,
                                  WS, bias),
         K10.eva_attention_from_x_ref(x, wqkv, bqkv, rf, beta, wo, bo, 0.25, NH,
                                      G, WS, bias)),
        (K10.eva_summaries_from_x(x, wqkv, bqkv, *weights, NH, G, 2, False)[1],
         K10.eva_summaries_from_x_ref(x, wqkv, bqkv, *weights, NH, G, 2, False)[1]),
    ]
    assert (K9.LAUNCHES_OUT, K10.LAUNCHES_SUMMARIES, K10.LAUNCHES_ATTENTION) == before
    for got, want in pairs:
        assert torch.equal(got, want)


@pytest.mark.parametrize("case,ok", [
    (dict(), True),
    (dict(itemsize=4), True),
    (dict(adaptive_proj="none"), False),     # no adaptive_mu_q to take
    (dict(ws=5), False),                     # window 5 does not divide 28
    (dict(dim=3 * 24), False),               # head dim 24: not built
])
def test_mega_gate(case, ok):
    """The cell (B=128, 28x28 tokens, dim 192, 3 heads, window 7, 49
    landmarks) in bf16 and f32, and where the gate fails."""
    geo = dict(B=128, gh=28, gw=28, ws=7, j=4, num_landmarks=49,
               adaptive_proj="default", dim=192, num_heads=3, itemsize=2)
    geo.update(case)
    assert K10.supports_mega(**geo) is ok


def test_packed_out_smem_at_the_cell():
    """K9's block (one window, every head) and K10's (with the window's x
    rows) fit Hopper's 227 KB in f32; in bf16 the tensor-core route's fit
    two to an SM's 228 KB (less 1 KB reserved a block)."""
    for itemsize in (2, 4):
        assert K9.plan_out(128, 784, 28, 7, 49, 3, 64, itemsize) is not None
        assert K9.plan_out(128, 784, 28, 7, 49, 3, 64, itemsize, xdim=192) <= \
            K9.SMEM_LIMIT
    assert K9.smem_bytes_out(64, 49, 49, 3, 4, 192) == 174976
    for xdim in (0, 192):
        assert K9.out_uses_mma(64, 2, xdim)
        assert 2 * (K9.smem_bytes_out(64, 49, 49, 3, 2, xdim) + 1024) <= 233472

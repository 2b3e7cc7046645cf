"""K1 ``eva_packed`` of the PyTorch port against the JAX package, on the CPU.

The plain forward must give JAX's dense ``_xla_reference`` and the Pallas
kernel in interpret mode to 3e-5 abs / 1e-4 rel in float32 (the tolerance
``TestPackedKernel`` holds the kernel to), over that class's geometries; the
plain backward in explicit formulas must give ``jax.grad`` through the
interpret-mode kernel to 1e-4 abs / 1e-3 rel (``test_grads_match_reference``'s
tolerance), and torch autograd through the plain forward to 1e-5 abs / 1e-4
rel (the same float32 arithmetic in another order).  On CPU tensors the
autograd Function takes the plain versions and launches nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32
from efficient_attention_tpu.ops.pallas.eva_packed import (
    _xla_reference,
    eva_attention_packed as jax_packed,
)
from efficient_attention_torch.ops.kernels import eva_packed as K

FWD_TOL = dict(atol=3e-5, rtol=1e-4)
JAX_GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
AUTOGRAD_TOL = dict(atol=1e-5, rtol=1e-4)

# (grid width, window, chunks, heads, head dim): TestPackedKernel's
GEOMETRIES = [(8, 4, 4, 3, 16), (8, 2, 4, 2, 8), (12, 4, 9, 3, 16),
              (16, 4, 16, 2, 8), (6, 3, 4, 4, 8)]


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def _inputs(W, ws, c, nh, d, B=2, seed=0):
    rng = np.random.default_rng(seed)
    N = W * W
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, N, 3 * nh * d), f(B, c, nh * d), f(B, c, nh * d),
            (0.1 * f(nh, ws * ws, ws * ws)).astype(np.float32),
            f(B, N, nh * d))


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_plain_forward_matches_jax(geometry, with_bias):
    W, ws, c, nh, d = geometry
    qkv, rf, beta, bias, _ = _inputs(W, ws, c, nh, d)
    bias = bias if with_bias else None
    scale = d ** -0.5
    jargs = [jnp.asarray(a) for a in (qkv, rf, beta)]
    jbias = None if bias is None else jnp.asarray(bias)
    ref = np.asarray(_xla_reference(*jargs, scale, nh, W, ws, jbias))
    pallas = np.asarray(jax_packed(*jargs, scale, nh, W, ws, bias=jbias,
                                   interpret=True))
    out = K.eva_packed_fwd_ref(*_torch(qkv, rf, beta), scale, nh, W, ws,
                               *_torch(bias)).numpy()
    np.testing.assert_allclose(out, ref, **FWD_TOL)
    np.testing.assert_allclose(out, pallas, **FWD_TOL)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("geometry", [GEOMETRIES[0], GEOMETRIES[2],
                                      GEOMETRIES[4]])
def test_plain_backward_matches_jax_grad(geometry, with_bias):
    """All four gradients, against jax.grad through the interpret-mode
    kernel's fused backward."""
    W, ws, c, nh, d = geometry
    qkv, rf, beta, bias, g = _inputs(W, ws, c, nh, d, seed=1)
    scale = d ** -0.5

    def loss(q, r, b, bi):
        out = jax_packed(q, r, b, scale, nh, W, ws,
                         bias=bi if with_bias else None, interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (qkv, rf, beta, bias)))
    got = K.eva_packed_bwd_ref(*_torch(qkv, rf, beta),
                               *_torch(bias if with_bias else None, g),
                               scale, nh, W, ws)
    for name, a, b in zip(("dqkv", "drf", "dbeta"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **JAX_GRAD_TOL,
                                   err_msg=name)
    if with_bias:
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                                   **JAX_GRAD_TOL, err_msg="dbias")
    else:
        assert got[3] is None


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_plain_backward_matches_autograd(geometry):
    W, ws, c, nh, d = geometry
    qkv, rf, beta, bias, g = _torch(*_inputs(W, ws, c, nh, d, seed=2))
    scale = d ** -0.5
    leaves = [t.clone().requires_grad_() for t in (qkv, rf, beta, bias)]
    out = K.eva_packed_fwd_ref(*leaves[:3], scale, nh, W, ws, leaves[3])
    want = torch.autograd.grad((out * g).sum(), leaves)
    got = K.eva_packed_bwd_ref(qkv, rf, beta, bias, g, scale, nh, W, ws)
    for name, a, b in zip(("dqkv", "drf", "dbeta", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **AUTOGRAD_TOL,
                                   err_msg=name)


def test_autograd_function_on_cpu_takes_the_plain_versions():
    W, ws, c, nh, d = GEOMETRIES[0]
    qkv, rf, beta, bias, g = _torch(*_inputs(W, ws, c, nh, d, seed=3))
    scale = d ** -0.5
    before = (K.LAUNCHES_FWD, K.LAUNCHES_BWD)
    leaves = [t.clone().requires_grad_() for t in (qkv, rf, beta, bias)]
    out = K.eva_attention_packed(*leaves[:3], scale, nh, W, ws, bias=leaves[3])
    torch.testing.assert_close(
        out, K.eva_packed_fwd_ref(qkv, rf, beta, scale, nh, W, ws, bias),
        rtol=0, atol=0)
    (out * g).sum().backward()
    want = K.eva_packed_bwd_ref(qkv, rf, beta, bias, g, scale, nh, W, ws)
    for leaf, b in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, b, rtol=0, atol=0)
    assert (K.LAUNCHES_FWD, K.LAUNCHES_BWD) == before
    # without a bias, no bias gradient is asked for
    leaves = [t.clone().requires_grad_() for t in (qkv, rf, beta)]
    K.eva_attention_packed(*leaves, scale, nh, W, ws).sum().backward()
    assert all(t.grad is not None for t in leaves)


def test_bf16_plain_versions_round_like_the_tpu_kernel():
    """In bfloat16 the output and dqkv come back in bfloat16 and drf/dbeta
    in the summaries' dtype, within bf16 rounding of the float32 result."""
    W, ws, c, nh, d = GEOMETRIES[0]
    qkv, rf, beta, bias, g = _torch(*_inputs(W, ws, c, nh, d, seed=4))
    scale = d ** -0.5
    lo = [t.to(torch.bfloat16) for t in (qkv, rf, beta, g)]
    out = K.eva_packed_fwd_ref(*lo[:3], scale, nh, W, ws, bias)
    assert out.dtype == torch.bfloat16
    ref = K.eva_packed_fwd_ref(*(t.float() for t in lo[:3]), scale, nh, W,
                               ws, bias)
    assert (out.float() - ref).abs().max() < 2 ** -5
    dqkv, drf, dbeta, dbias = K.eva_packed_bwd_ref(*lo[:3], bias, lo[3],
                                                   scale, nh, W, ws)
    assert dqkv.dtype == drf.dtype == dbeta.dtype == torch.bfloat16
    assert dbias.dtype == torch.float32


def test_gate():
    # the main path: B=128, 28x28 tokens, window 7, 49 chunks, 3 heads of 64
    assert K.supports_packed(128, 784, 28, 7, 49, 64, 2, 3)
    assert K.supports_packed(128, 784, 28, 7, 49, 64, 4, 3)
    assert K.plan(128, 784, 28, 7, 49, 3, 64, 2) == 4   # 16 windows, 4 a block
    assert K.plan(2, 196, 14, 7, 49, 4, 12, 4) == 4     # 4 windows
    assert K.plan(2, 36, 6, 3, 4, 4, 8, 4) is None      # head dim 8
    assert K.plan(2, 81, 9, 3, 9, 4, 16, 4) == 1        # 9 windows
    assert not K.supports_packed(2, 784, 28, 7, 49, 24, 4)   # head dim 24
    assert not K.supports_packed(2, 784, 28, 5, 49, 64, 4)   # window 5
    assert not K.supports_packed(2, 784, 28, 7, 49, 64, 1)   # element size
    assert not K.supports_packed(2, 784, 28, 7, 400, 64, 4)  # 400 chunks
    assert not K.supports_packed(70000, 784, 28, 7, 49, 64, 2)
    assert K.smem_bytes(True, 64, 49, 49) <= K.SMEM_LIMIT
    assert K.smem_bytes(False, 64, 49, 49) < K.smem_bytes(True, 64, 49, 49)


@pytest.mark.parametrize("d,itemsize,mma", [
    (16, 2, True), (32, 2, True), (64, 2, True),
    (16, 4, False), (32, 4, False), (64, 4, False),
    (12, 2, False), (12, 4, False),
])
def test_bwd_uses_mma_picks_the_route(d, itemsize, mma):
    """bf16 at head dims that are multiples of 16 takes the tensor-core
    backward; f32, and head dim 12, the CUDA-core one."""
    assert K.bwd_uses_mma(d, itemsize) is mma


@pytest.mark.parametrize("d,itemsize,mma", [
    (16, 2, True), (32, 2, True), (64, 2, True),
    (16, 4, False), (32, 4, False), (64, 4, False),
    (12, 2, False), (12, 4, False),
])
def test_fwd_uses_mma_picks_the_route(d, itemsize, mma):
    """bf16 at head dims that are multiples of 16 takes the tensor-core
    forward; f32, and head dim 12, the CUDA-core one."""
    assert K.fwd_uses_mma(d, itemsize) is mma


# Hopper: 228 KB of shared memory an SM, 1 KB of it reserved for each block
SM_SMEM = 233472
BLOCK_RESERVED = 1024


@pytest.mark.parametrize("what,d,S,C", [
    ("headline: 28x28 tokens, window 7, 49 chunks, heads of 64", 64, 49, 49),
    ("PVT-B3 stage 1: 56x56 tokens, window 7, 49 chunks, heads of 32", 32, 49, 49),
])
def test_mma_backward_layout_fits_two_blocks_an_sm(what, d, S, C):
    mma = K.smem_bytes(True, d, S, C, itemsize=2)
    assert mma <= K.SMEM_LIMIT, what
    assert 2 * (mma + BLOCK_RESERVED) <= SM_SMEM, what
    # the bf16 staging is smaller than the CUDA-core route's f32 one, which
    # the other types keep; the bf16 forward takes its own layout too
    assert mma < K.smem_bytes(True, d, S, C) == K.smem_bytes(True, d, S, C, 4)
    assert K.smem_bytes(False, d, S, C, 2) < K.smem_bytes(False, d, S, C)


def test_mma_backward_layout_counts_each_region():
    """The layout twin of ``make_mma_layout``: bf16 q, g [S][d+8], keys and
    values [S+C][d+8], P and dS [S][round16(S+C)+8], a zero row, then f32
    bias, dbias [S][S] and drf, dbeta [C][d], the int32 token table [4][S],
    each 128-byte aligned."""
    a = lambda n: -(-n // 128) * 128  # noqa: E731
    # S=16, C=4: 20 keys pad to 32 columns, rows of 40 bf16
    want = (2 * a(16 * 24 * 2) + 2 * a(20 * 24 * 2) + 2 * a(16 * 40 * 2)
            + a(40 * 2) + 2 * a(16 * 16 * 4) + 2 * a(4 * 16 * 4)
            + a(4 * 16 * 4))
    assert K.smem_bytes(True, 16, 16, 4, 2) == want
    # plan accepts the same geometries in both types: at window 7 and heads
    # of 64 the CUDA-core backward's f32 block bounds the chunks at 96
    for C, wpb in ((49, 4), (96, 4), (97, None), (170, None)):
        assert K.plan(128, 784, 28, 7, C, 3, 64, 2) == wpb
        assert K.plan(128, 784, 28, 7, C, 3, 64, 4) == wpb


@pytest.mark.parametrize("what,d,S,C", [
    ("headline: 28x28 tokens, window 7, 49 chunks, heads of 64", 64, 49, 49),
    ("PVT-B3 stage 1: 56x56 tokens, window 7, 49 chunks, heads of 32", 32, 49, 49),
])
def test_mma_forward_layout_fits_three_blocks_an_sm(what, d, S, C):
    fwd = K.smem_bytes(False, d, S, C, itemsize=2)
    assert 3 * (fwd + BLOCK_RESERVED) <= SM_SMEM, what
    # no logit matrix: smaller than the CUDA-core forward's f32 layout, which
    # f32 keeps
    assert fwd < K.smem_bytes(False, d, S, C) == K.smem_bytes(False, d, S, C, 4)


def test_mma_forward_layout_counts_each_region():
    """The layout twin of ``make_fwd_mma_layout``: bf16 q, k, v [S][d+8] in
    two buffers each, rf and beta [C][d+8], then the f32 bias [S][S] and the
    int32 token table [4][S], each 128-byte aligned."""
    a = lambda n: -(-n // 128) * 128  # noqa: E731
    # S=16, C=4, heads of 16: rows of 24 bf16
    want = (6 * a(16 * 24 * 2) + 2 * a(4 * 24 * 2) + a(16 * 16 * 4)
            + a(4 * 16 * 4))
    assert K.smem_bytes(False, 16, 16, 4, 2) == want
    # the headline: 49 + 49 keys, heads of 64
    assert K.smem_bytes(False, 64, 49, 49, 2) == (
        6 * 7168 + 2 * 7168 + 9728 + 896) == 67968
    # the two-pass geometry (49 + 196 keys) holds only the chunk rows more
    assert (K.smem_bytes(False, 16, 49, 196, 2) - K.smem_bytes(False, 16, 49, 49, 2)
            == 2 * (a(196 * 24 * 2) - a(49 * 24 * 2)))


@pytest.mark.parametrize("change,match", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(d=24), "cannot take"),
    (dict(W=10), "does not split"),
    (dict(rf_c=5), "beta"),
    (dict(bias=(3, 16, 9)), "bias must be"),
])
def test_forward_launch_checks_raise_before_any_launch(change, match, monkeypatch):
    """The forward's operand checks (run here on CPU tensors) raise before
    the library is loaded or anything is launched."""
    monkeypatch.setattr(K, "_lib", lambda: pytest.fail("loaded the library"))
    nh, W = 3, change.get("W", 8)
    d = change.get("d", 16)
    dtype = change.get("dtype", torch.bfloat16)
    qkv = torch.zeros(2, 64, 3 * nh * d, dtype=dtype)
    rf = torch.zeros(2, change.get("rf_c", 4), nh * d, dtype=dtype)
    beta = torch.zeros(2, 4, nh * d, dtype=dtype)
    bias = torch.zeros(change["bias"]) if "bias" in change else None
    before = (K.LAUNCHES_FWD, K.LAUNCHES_FWD_MMA)
    with pytest.raises(ValueError, match=match):
        K._fwd_operands(qkv, rf, beta, bias, nh, W, 4)
    assert (K.LAUNCHES_FWD, K.LAUNCHES_FWD_MMA) == before


@pytest.mark.parametrize("dtype,d,cuda_cores,mma", [
    (torch.bfloat16, 16, False, True), (torch.bfloat16, 64, False, True),
    (torch.bfloat16, 16, True, False), (torch.float32, 16, False, False),
    (torch.bfloat16, 12, False, False),
])
def test_forward_route_and_operands(dtype, d, cuda_cores, mma):
    """The route the forward takes, and its operands: contiguous, in qkv's
    type (the bias in f32), 16-byte aligned on the tensor-core route."""
    nh = 3
    qkv = torch.zeros(2, 64, 3 * nh * d, dtype=dtype)
    rf = torch.zeros(2, 4, nh * d)
    beta = torch.zeros(2, 4, nh * d)
    *ops, geometry, uses_mma = K._fwd_operands(
        qkv, rf, beta, torch.zeros(nh, 16, 16, dtype=torch.float64), nh, 8, 4,
        cuda_cores=cuda_cores)
    assert uses_mma is mma
    assert geometry == (2, 64, nh, d, 4, 4)
    assert [t.dtype for t in ops] == [dtype] * 3 + [torch.float32]
    assert all(t.is_contiguous() for t in ops)
    if mma:
        assert all(t.data_ptr() % 16 == 0 for t in ops[:3])


@pytest.mark.parametrize("change,match", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(d=24), "cannot take"),
    (dict(W=10), "does not split"),
    (dict(rf_c=5), "beta"),
])
def test_launch_checks_raise_before_any_launch(change, match):
    """The CUDA wrapper's operand checks (run here on CPU tensors)."""
    nh, W = 3, change.get("W", 8)
    d = change.get("d", 16)
    qkv = torch.zeros(2, 64, 3 * nh * d, dtype=change.get("dtype", torch.float32))
    rf = torch.zeros(2, change.get("rf_c", 4), nh * d)
    beta = torch.zeros(2, 4, nh * d)
    with pytest.raises(ValueError, match=match):
        K._cuda_operands(qkv, rf, beta, None, nh, W, 4)

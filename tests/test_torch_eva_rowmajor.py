"""K12 ``eva_rowmajor`` of the PyTorch port against the JAX package, on the CPU.

The plain version must give the Pallas ``eva_attention_rowmajor`` in
interpret mode and the Swin-partitioned reference of ``test_pallas.py::
TestRowMajorKernel`` to 3e-5 abs / 1e-4 rel in float32, on square and
rectangular grids, with and without the bias; the gradients of all six
inputs through the port's autograd Function must give ``jax.grad`` through
the interpret-mode kernel (whose VJP is ``_xla_reference_rowmajor``'s) to
5e-4 abs / 1e-3 rel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32
from efficient_attention_tpu.ops import windows as jax_windows
from efficient_attention_tpu.ops.pallas.eva_kernel import _xla_reference
from efficient_attention_tpu.ops.pallas.eva_rowmajor import (
    eva_attention_rowmajor as jax_rowmajor,
)
from efficient_attention_torch.ops.kernels import eva_kernel as K11
from efficient_attention_torch.ops.kernels import eva_rowmajor as K

FWD_TOL = dict(atol=3e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)
B, H, D = 2, 3, 16


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def _inputs(gh, W, ws, c, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    N = gh * W
    return (f(B, H, N, D), f(B, H, N, D), f(B, H, N, D), f(B, H, c, D),
            f(B, H, c, D), f(H, ws * ws, ws * ws), f(B, H, N, D))


# (grid rows, grid width, window, chunks): TestRowMajorKernel's, and a
# rectangular grid
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("gh,W,ws,c", [(16, 16, 4, 4), (8, 12, 4, 6)])
def test_plain_matches_jax(gh, W, ws, c, with_bias):
    *ops, bias, _ = _inputs(gh, W, ws, c)
    bias = bias if with_bias else None
    scale = D ** -0.5
    j = [jnp.asarray(a) for a in ops]
    jbias = None if bias is None else jnp.asarray(bias)

    def part(t):
        return jax_windows.window_2d_partition(t.reshape(B, H, gh, W, D), ws)

    swin = _xla_reference(*map(part, j[:3]), j[3], j[4], jbias, scale)
    ref = np.asarray(jax_windows.window_2d_merge(swin, ws, (gh, W))
                     ).reshape(B, H, gh * W, D)
    pallas = np.asarray(jax_rowmajor(*j, scale, W, ws, bias=jbias, interpret=True))
    out = K.eva_rowmajor_ref(*map(torch.from_numpy, ops), scale, W, ws,
                             None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), ref, **FWD_TOL)
    np.testing.assert_allclose(out.numpy(), pallas, **FWD_TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_grads_match_jax(with_bias):
    gh, W, ws, c = 8, 8, 4, 2
    *ops, bias, cot = _inputs(gh, W, ws, c, seed=1)
    scale = D ** -0.5

    def loss(q, k, v, r, b, bi):
        out = jax_rowmajor(q, k, v, r, b, scale, W, ws,
                           bias=bi if with_bias else None, interpret=True)
        return jnp.sum(out * jnp.asarray(cot))

    want = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        *map(jnp.asarray, ops), jnp.asarray(bias))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (*ops, bias)]
    before = K.LAUNCHES, K11.LAUNCHES
    out = K.eva_attention_rowmajor(*leaves[:5], scale, W, ws,
                                   bias=leaves[5] if with_bias else None)
    (out * torch.from_numpy(cot)).sum().backward()
    assert (K.LAUNCHES, K11.LAUNCHES) == before
    for leaf, w in zip(leaves[:5], want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **GRAD_TOL)
    if with_bias:
        np.testing.assert_allclose(leaves[5].grad.numpy(), np.asarray(want[5]),
                                   **GRAD_TOL)
    else:
        assert leaves[5].grad is None


def test_off_cuda_devices_raise():
    q = torch.zeros(1, 1, 16, 8, device="meta")
    rf = torch.zeros(1, 1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.eva_attention_rowmajor(q, q, q, rf, rf, 1.0, 4, 2)


def test_gate():
    # the headline cell: 28x28 tokens, window 7, 49 chunks, 3 heads of 64
    assert K.plan_rowmajor(128, 784, 28, 7, 49, 3, 64, 2) == 4
    # PVTv2-B3's EVA stages
    for N, W, nh in ((3136, 56, 2), (784, 28, 4), (196, 14, 10)):
        assert K.supports_rowmajor(128, N, W, 7, 49, 32, 2, nh)
    assert K.supports_rowmajor(2, 96, 12, 4, 6, 16, 4, 3)   # 8x12 grid
    assert not K.supports_rowmajor(2, 784, 28, 5, 49, 64)   # window 5
    assert not K.supports_rowmajor(2, 702, 26, 2, 49, 64)   # 27 rows
    assert not K.supports_rowmajor(2, 784, 28, 7, 49, 20)   # head dim 20
    assert not K.supports_rowmajor(2, 784, 28, 7, 49, 64, 1)


@pytest.mark.parametrize("what,B,N,W,ws,C,nh,d", [
    ("headline", 128, 784, 28, 7, 49, 3, 64),
    ("PVT-B3 stage 1", 128, 3136, 56, 7, 49, 2, 32),
    ("PVT-B3 stage 2", 128, 784, 28, 7, 49, 4, 32),
    ("PVT-B3 stage 3", 128, 196, 14, 7, 49, 10, 32),
    ("heads of 48", 16, 784, 28, 7, 49, 2, 48),
    ("two passes: window 8, 64 chunks", 8, 1024, 32, 8, 64, 2, 64),
    ("8x12 grid", 3, 96, 12, 4, 6, 3, 16),
])
def test_plan_fits_the_token_table(what, B, N, W, ws, C, nh, d):
    """Every geometry a path runs gets a windows-per-block count that
    divides its windows and fits the kernel's token table of 4 windows; the
    tensor-core route's shared memory is K11's."""
    wpb = K.plan_rowmajor(B, N, W, ws, C, nh, d, 2)
    assert wpb is not None and (N // (ws * ws)) % wpb == 0 and wpb <= 4, what
    assert K11.uses_mma(d, 2)


@pytest.mark.parametrize("change,match", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(d=20), "cannot take"),
    (dict(W=10), "cannot take"),
    (dict(rf_c=5), "beta"),
    (dict(bias=(3, 9, 9)), "bias must be"),
])
def test_launch_checks_raise_before_any_launch(change, match, monkeypatch):
    """The kernel's operand checks (run here on CPU tensors) raise before
    the library is loaded or anything is launched."""
    monkeypatch.setattr(K, "_lib", lambda: pytest.fail("loaded the library"))
    d, dtype = change.get("d", 16), change.get("dtype", torch.bfloat16)
    q = torch.zeros(2, 3, 96, d, dtype=dtype)
    rf = torch.zeros(2, 3, change.get("rf_c", 6), d, dtype=dtype)
    beta = torch.zeros(2, 3, 6, d, dtype=dtype)
    bias = torch.zeros(change["bias"]) if "bias" in change else None
    before = K.LAUNCHES, K11.LAUNCHES
    with pytest.raises(ValueError, match=match):
        K._operands(q, q, q, rf, beta, bias, change.get("W", 12), 4)
    assert (K.LAUNCHES, K11.LAUNCHES) == before


def test_launch_operands_and_geometry(monkeypatch):
    """The checked operands of an 8x12 grid in 4x4 windows: contiguous, in
    q's bf16, the bias in f32; the geometry (B, H, N, C, d, windows a
    block)."""
    monkeypatch.setattr(K, "_lib", lambda: pytest.fail("loaded the library"))
    q = torch.zeros(2, 3, 96, 16, dtype=torch.bfloat16)
    rf = torch.zeros(2, 3, 6, 16, dtype=torch.bfloat16)
    ops, bias, geometry = K._operands(q, q, q, rf, rf, torch.zeros(3, 16, 16), 12, 4)
    assert geometry == (2, 3, 96, 6, 16, 2)
    assert [t.dtype for t in ops] == [torch.bfloat16] * 5 and bias.dtype == torch.float32
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ops)

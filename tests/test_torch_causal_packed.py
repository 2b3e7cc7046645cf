"""K3 ``causal_packed`` of the PyTorch port against the JAX package, on the CPU.

The plain forward must give JAX's strip-form ``_xla_reference`` and the
Pallas kernel in interpret mode to 3e-5 abs / 1e-4 rel in float32 (the
tolerance ``TestCausalPacked`` holds the kernel to), at that class's geometry
(B 2, T 64, 2 heads of 64, window 16, chunk 4), with and without a T5-like
bias on the table, and at T = w (window 0 alone, whose first chunk-size rows
see no chunk); the plain backward in explicit formulas must give
``jax.grad`` through the interpret-mode kernel to 5e-4 abs / 1e-3 rel
(``test_grads_match_reference``'s tolerance), and torch autograd through the
plain forward to 1e-5 abs / 1e-4 rel (the same float32 arithmetic in another
order).  On CPU tensors the autograd Function takes the plain versions and
launches nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32
from efficient_attention_tpu.ops.pallas.causal_packed import (
    _xla_reference,
    causal_eva_packed as jax_packed,
)
from efficient_attention_torch.ops.kernels import causal_packed as K

FWD_TOL = dict(atol=3e-5, rtol=1e-4)
JAX_GRAD_TOL = dict(atol=5e-4, rtol=1e-3)
AUTOGRAD_TOL = dict(atol=1e-5, rtol=1e-4)
NH, D, W, CS = 2, 64, 16, 4
NAMES = ("dq", "dk", "dv", "drf", "dbeta", "dbias")


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def _inputs(T=64, t5=True, B=2, seed=0):
    """q, k, v, rf, beta, the [w, w] table and an output gradient."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    C = T // CS
    tri = np.triu(np.ones((W, W), np.float32), 1)
    tab = np.where(tri, -5e4, 0.0).astype(np.float32)
    if t5:
        tab = tab + 0.1 * f(W, W)
    return (f(B, T, NH * D), f(B, T, NH * D), f(B, T, NH * D), f(B, C, NH * D),
            f(B, C, NH * D), tab, f(B, T, NH * D))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("T,t5", [(64, False), (64, True), (W, True)])
def test_plain_forward_matches_jax(T, t5):
    *ops, _ = _inputs(T, t5)
    scale = D ** -0.5
    j = [jnp.asarray(a) for a in ops]
    ref = np.asarray(_xla_reference(*j, scale, NH, W, CS))
    pallas = np.asarray(jax_packed(*j[:5], scale, NH, W, CS, bias_tab=j[5],
                                   interpret=True))
    out = K.causal_packed_fwd_ref(*_torch(*ops), scale, NH, W, CS).numpy()
    np.testing.assert_allclose(out, ref, **FWD_TOL)
    np.testing.assert_allclose(out, pallas, **FWD_TOL)


@pytest.mark.parametrize("T,t5", [(64, False), (64, True), (W, True)])
def test_plain_backward_matches_jax_grad(T, t5):
    """All six gradients, against jax.grad through the interpret-mode
    kernel's fused backward."""
    *ops, g = _inputs(T, t5, seed=1)
    scale = D ** -0.5

    def loss(*a):
        out = jax_packed(*a[:5], scale, NH, W, CS, bias_tab=a[5], interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in ops))
    got = K.causal_packed_bwd_ref(*_torch(*ops, g), scale, NH, W, CS)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **JAX_GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("T", [64, W])
def test_plain_backward_matches_autograd(T):
    *ops, g = _torch(*_inputs(T, seed=2))
    scale = D ** -0.5
    leaves = [t.clone().requires_grad_() for t in ops]
    out = K.causal_packed_fwd_ref(*leaves, scale, NH, W, CS)
    want = torch.autograd.grad((out * g).sum(), leaves)
    got = K.causal_packed_bwd_ref(*ops, g, scale, NH, W, CS)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **AUTOGRAD_TOL,
                                   err_msg=name)


def test_autograd_function_on_cpu_takes_the_plain_versions():
    *ops, g = _torch(*_inputs(seed=3))
    scale = D ** -0.5
    before = (K.LAUNCHES_FWD, K.LAUNCHES_BWD)
    leaves = [t.clone().requires_grad_() for t in ops]
    out = K.causal_eva_packed(*leaves[:5], scale, NH, W, CS, bias_tab=leaves[5])
    torch.testing.assert_close(
        out, K.causal_packed_fwd_ref(*ops, scale, NH, W, CS), rtol=0, atol=0)
    (out * g).sum().backward()
    want = K.causal_packed_bwd_ref(*ops, g, scale, NH, W, CS)
    for leaf, b in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, b, rtol=0, atol=0)
    assert (K.LAUNCHES_FWD, K.LAUNCHES_BWD) == before
    # without a table, the causal triangle alone
    torch.testing.assert_close(
        K.causal_eva_packed(*ops[:5], scale, NH, W, CS),
        K.causal_packed_fwd_ref(*ops[:5], K.causal_table(W), scale, NH, W, CS),
        rtol=0, atol=0)


def test_bf16_plain_versions_round_like_the_tpu_kernel():
    """In bfloat16 the output and dq/dk/dv come back in bfloat16, drf/dbeta
    in the summaries' dtype and dbias in the table's, within bf16 rounding
    of the float32 result."""
    *ops, g = _torch(*_inputs(seed=4))
    scale = D ** -0.5
    lo = [t.to(torch.bfloat16) for t in ops[:5]]
    out = K.causal_packed_fwd_ref(*lo, ops[5], scale, NH, W, CS)
    assert out.dtype == torch.bfloat16
    ref = K.causal_packed_fwd_ref(*(t.float() for t in lo), ops[5], scale, NH, W, CS)
    assert (out.float() - ref).abs().max() < 2 ** -5
    grads = K.causal_packed_bwd_ref(*lo, ops[5], g.to(torch.bfloat16), scale,
                                    NH, W, CS)
    assert all(t.dtype == torch.bfloat16 for t in grads[:5])
    assert grads[5].dtype == torch.float32


def test_gate():
    # the main path: B=18, T=512, 8 heads of 128, window 128, chunk 8
    assert K.plan(18, 512, 128, 8, 64, 8, 128, 2) == (64, 32)
    assert K.supports_causal_packed(18, 512, 128, 8, 8, 128, 2)
    assert K.supports_causal_packed(18, 512, 128, 8, 8, 128, 4)
    assert K.plan(2, 64, 16, 4, 16, 2, 64, 4) == (16, 16)
    assert not K.supports_causal_packed(2, 64, 16, 4, 2, 48, 4)     # head dim
    assert not K.supports_causal_packed(2, 64, 16, 4, 2, 64, 1)     # dtype
    assert not K.supports_causal_packed(2, 60, 16, 4, 2, 64, 4)     # T % w
    assert not K.supports_causal_packed(2, 64, 16, 3, 2, 64, 4)     # w % cs
    assert not K.supports_causal_packed(2, 4096, 128, 8, 8, 128, 2)  # smem
    assert K.smem_bytes(True, 128, 128, 64, 32) <= K.SMEM_LIMIT
    assert K.smem_bytes(False, 128, 128, 64, 64) <= K.SMEM_LIMIT


@pytest.mark.parametrize("change,match", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(d=48), "cannot take"),
    (dict(T=60), "does not split"),
    (dict(rf_c=5), "beta"),
    (dict(tab=8), "bias_tab"),
])
def test_launch_checks_raise_before_any_launch(change, match):
    """The CUDA wrapper's operand checks (run here on CPU tensors)."""
    T, d = change.get("T", 64), change.get("d", 64)
    dtype = change.get("dtype", torch.float32)
    q = torch.zeros(2, T, NH * d, dtype=dtype)
    rf = torch.zeros(2, change.get("rf_c", 16), NH * d, dtype=dtype)
    beta = torch.zeros(2, 16, NH * d, dtype=dtype)
    tab = torch.zeros(change.get("tab", W), change.get("tab", W))
    with pytest.raises(ValueError, match=match):
        K._cuda_operands(q, q, q, rf, beta, tab, NH, W, CS)

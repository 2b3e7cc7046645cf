"""K11 ``eva_kernel`` of the PyTorch port against the JAX package, on the CPU.

The plain version must give the Pallas ``eva_attention_fused`` in interpret
mode and its ``_xla_reference`` to 2e-5 abs / 1e-4 rel in float32
(``test_pallas.py::test_kernel_matches_reference``'s tolerance and
geometries), with and without the bias; the gradients of all six inputs
through the port's autograd Function must give ``jax.grad`` through the
interpret-mode kernel (whose VJP is ``_xla_reference``'s) to 5e-4 abs /
1e-3 rel (``TestKernelGradients``' tolerance).  In bf16 the plain version
rounds the softmax numerators to bf16 before the value product, as the TPU
kernel does, and keeps the products in f32 where the summaries come in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32
from efficient_attention_tpu.ops.pallas.eva_kernel import (
    _xla_reference,
    eva_attention_fused as jax_fused,
)
from efficient_attention_torch.ops.kernels import eva_kernel as K

FWD_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)
B, H, D = 2, 3, 16


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def _inputs(g, s, c, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    shape = (B, H, g, s, D)
    return (f(*shape), f(*shape), f(*shape), f(B, H, c, D), f(B, H, c, D),
            f(H, s, s), f(*shape))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("g,s,c", [(8, 16, 4), (4, 8, 8)])
def test_plain_matches_jax(g, s, c, with_bias):
    *ops, bias, _ = _inputs(g, s, c)
    bias = bias if with_bias else None
    scale = D ** -0.5
    j = [jnp.asarray(a) for a in ops]
    jbias = None if bias is None else jnp.asarray(bias)
    ref = np.asarray(_xla_reference(*j, jbias, scale))
    pallas = np.asarray(jax_fused(*j, scale, jbias, interpret=True))
    out = K.eva_fused_ref(*map(torch.from_numpy, ops), scale,
                          None if bias is None else torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(out, ref, **FWD_TOL)
    np.testing.assert_allclose(out, pallas, **FWD_TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_grads_match_jax(with_bias):
    """All six gradients through the autograd Function (the plain version on
    the CPU, nothing launched) against jax.grad of the interpret-mode
    kernel."""
    *ops, bias, cot = _inputs(4, 8, 4, seed=1)
    scale = D ** -0.5

    def loss(q, k, v, r, b, bi):
        out = jax_fused(q, k, v, r, b, scale, bi if with_bias else None,
                        interpret=True)
        return jnp.sum(out * jnp.asarray(cot))

    want = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        *map(jnp.asarray, ops), jnp.asarray(bias))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (*ops, bias)]
    before = K.LAUNCHES
    out = K.eva_attention_fused(*leaves[:5], scale,
                                leaves[5] if with_bias else None)
    (out * torch.from_numpy(cot)).sum().backward()
    assert K.LAUNCHES == before
    for leaf, w in zip(leaves[:5], want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **GRAD_TOL)
    if with_bias:
        np.testing.assert_allclose(leaves[5].grad.numpy(), np.asarray(want[5]),
                                   **GRAD_TOL)
    else:
        assert leaves[5].grad is None


def test_bf16_rounds_the_numerators_like_the_tpu_kernel():
    """In bf16 the numerators meet [v | beta] rounded to bf16 (the TPU
    kernel's ``p.astype(vals.dtype)``), the denominator is the f32 sum of the
    unrounded ones; with f32 summaries beside bf16 q/k/v the products run
    in f32, as the TPU kernel's concatenation promotes them."""
    ops = [torch.from_numpy(a) for a in _inputs(4, 8, 4, seed=2)[:5]]
    lo = [t.to(torch.bfloat16) for t in ops]
    scale = D ** -0.5
    out = K.eva_fused_ref(*lo, scale)
    assert out.dtype == torch.bfloat16
    # by hand: f32 logits, rounded numerators, f32 denominators
    q, k, v, rf, beta = (t.float() for t in lo)
    logits = torch.cat([torch.einsum("bhgsd,bhgtd->bhgst", q, k),
                        torch.einsum("bhgsd,bhcd->bhgsc", q, rf)], -1) * scale
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    pr = p.to(torch.bfloat16).float()
    want = (torch.einsum("bhgst,bhgtd->bhgsd", pr[..., :8], v)
            + torch.einsum("bhgsc,bhcd->bhgsd", pr[..., 8:], beta)) / p.sum(-1, keepdim=True)
    torch.testing.assert_close(out, want.to(torch.bfloat16), atol=0, rtol=0)
    unrounded = (torch.einsum("bhgst,bhgtd->bhgsd", p[..., :8], v)
                 + torch.einsum("bhgsc,bhcd->bhgsd", p[..., 8:], beta)
                 ) / p.sum(-1, keepdim=True)
    assert not torch.equal(out, unrounded.to(torch.bfloat16))
    # f32 summaries: the numerators stay f32, the output is q's bf16
    mixed = K.eva_fused_ref(*lo[:3], rf, beta, scale)
    assert mixed.dtype == torch.bfloat16
    torch.testing.assert_close(mixed, unrounded.to(torch.bfloat16), atol=0, rtol=0)


def test_cuda_tensors_outside_the_gate_or_off_cuda_raise():
    """The wrapper takes CPU tensors by the plain version only; any other
    device raises, as does a head dim the kernel is not built for (checked
    before any launch)."""
    ops = [torch.zeros(1, 1, 2, 4, 8, device="meta") for _ in range(3)]
    rf = torch.zeros(1, 1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.eva_attention_fused(*ops, rf, rf, 1.0)


def test_gate():
    # the headline cell: B=128, 16 windows of 49, 49 chunks, 3 heads of 64
    assert K.plan(128, 16, 49, 49, 3, 64, 2) == 4
    assert K.supports_fused(128, 16, 49, 49, 64, 4, 3)
    # PVTv2-B3's EVA stages: 64/16/4 windows of 49, 49 chunks, head dim 32
    for G, nh in ((64, 2), (16, 4), (4, 10)):
        assert K.plan(128, G, 49, 49, nh, 32, 2) == 4
    # 1-D: 5 windows of 8; a head dim K1 is not built for
    assert K.plan(2, 5, 8, 5, 3, 16, 4) == 1
    assert K.supports_fused(2, 16, 49, 49, 48, 2, 2)
    assert K.supports_fused(2, 16, 49, 196, 64, 4, 3)   # non-square chunks
    assert not K.supports_fused(2, 16, 49, 49, 20, 4)   # head dim 20
    assert not K.supports_fused(2, 16, 49, 49, 64, 1)   # element size
    assert not K.supports_fused(2, 16, 49, 2000, 64, 4)  # shared memory
    assert not K.supports_fused(70000, 16, 49, 49, 64, 4)  # grid
    assert K.uses_mma(64, 2) and not K.uses_mma(24, 2) and not K.uses_mma(64, 4)
    # three blocks an SM on the tensor-core route at the headline shape
    assert 3 * (K.smem_bytes(64, 49, 49, 2) + 1024) <= 233472
    assert K.smem_bytes(128, 49, 49, 4) <= K.SMEM_LIMIT


@pytest.mark.parametrize("d,itemsize,mma", [
    (16, 2, True), (32, 2, True), (48, 2, True), (64, 2, True), (128, 2, True),
    (8, 2, False), (12, 2, False), (24, 2, False),
    (16, 4, False), (48, 4, False), (64, 4, False), (128, 4, False), (12, 4, False),
])
def test_uses_mma_picks_the_route(d, itemsize, mma):
    """bf16 at head dims that are multiples of 16 takes the tensor-core
    kernel (the twin of ``uses_mma`` in ``csrc/eva_window.cuh``); f32, and
    the other head dims, the CUDA-core one."""
    assert K.uses_mma(d, itemsize) is mma


def test_mma_layout_counts_each_region():
    """The layout twin of ``make_mma_layout``: bf16 q, k, v [S][d+8] in two
    buffers each, rf and beta [C][d+8], then the f32 bias [S][S] and the
    int32 token table [4][S], each 128-byte aligned."""
    a = lambda n: -(-n // 128) * 128  # noqa: E731
    # S=16, C=6, heads of 16: rows of 24 bf16
    assert K.smem_bytes(16, 16, 6, 2) == (6 * a(16 * 24 * 2) + 2 * a(6 * 24 * 2)
                                          + a(16 * 16 * 4) + a(4 * 16 * 4))
    # the headline: 49 + 49 keys, heads of 64 (K1's forward layout)
    assert K.smem_bytes(64, 49, 49, 2) == 6 * 7168 + 2 * 7168 + 9728 + 896 == 67968
    # head dim 48, the auto fallback's: rows of 56 bf16
    assert K.smem_bytes(48, 49, 49, 2) == (8 * a(49 * 56 * 2) + a(49 * 49 * 4)
                                           + a(4 * 49 * 4))
    # the chunk rows alone grow with C
    assert (K.smem_bytes(64, 64, 128, 2) - K.smem_bytes(64, 64, 64, 2)
            == 2 * (a(128 * 72 * 2) - a(64 * 72 * 2)))
    # f32 keeps the CUDA-core layout, larger at the headline
    assert K.smem_bytes(64, 49, 49, 4) > K.smem_bytes(64, 49, 49, 2)


# Hopper: 228 KB of shared memory an SM, 1 KB of it reserved for each block
SM_SMEM = 233472
BLOCK_RESERVED = 1024


@pytest.mark.parametrize("what,d,S,C", [
    ("headline: window 7, 49 chunks, heads of 64", 64, 49, 49),
    ("PVT-B3 stages 1-3: window 7, 49 chunks, heads of 32", 32, 49, 49),
])
def test_mma_layout_fits_three_blocks_an_sm(what, d, S, C):
    assert 3 * (K.smem_bytes(d, S, C, 2) + BLOCK_RESERVED) <= SM_SMEM, what


@pytest.mark.parametrize("what,B,G,S,C,nh,d,itemsize", [
    ("headline", 128, 16, 49, 49, 3, 64, 2),
    ("headline f32", 128, 16, 49, 49, 3, 64, 4),
    ("PVT-B3 stage 1", 128, 64, 49, 49, 2, 32, 2),
    ("PVT-B3 stage 2", 128, 16, 49, 49, 4, 32, 2),
    ("PVT-B3 stage 3", 128, 4, 49, 49, 10, 32, 2),
    ("1-D: 5 windows of 8", 2, 5, 8, 5, 3, 16, 2),
    ("auto fallback: heads of 48", 16, 16, 49, 49, 2, 48, 2),
    ("two passes: window 8, 64 chunks", 8, 16, 64, 64, 2, 64, 2),
])
def test_plan_fits_the_token_table(what, B, G, S, C, nh, d, itemsize):
    """Every geometry a path runs gets a windows-per-block count that
    divides its windows and fits the kernel's token table of 4 windows."""
    wpb = K.plan(B, G, S, C, nh, d, itemsize)
    assert wpb is not None and G % wpb == 0 and wpb <= 4, what
    assert max(K.WINDOWS_PER_BLOCK) == 4


def _cpu_operands(change):
    d = change.get("d", 16)
    dtype = change.get("dtype", torch.bfloat16)
    wins = [torch.zeros(2, 3, 4, 16, d, dtype=dtype) for _ in range(3)]
    rf = torch.zeros(2, 3, change.get("rf_c", 6), d, dtype=dtype)
    beta = torch.zeros(2, 3, 6, d, dtype=dtype)
    bias = torch.zeros(change["bias"]) if "bias" in change else None
    return wins, rf, beta, bias


@pytest.mark.parametrize("change,match", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(d=20), "cannot take"),
    (dict(rf_c=5), "beta"),
    (dict(bias=(3, 16, 9)), "bias must be"),
])
def test_launch_checks_raise_before_any_launch(change, match, monkeypatch):
    """The kernel's operand checks (run here on CPU tensors) raise before
    the library is loaded or anything is launched."""
    monkeypatch.setattr(K, "_lib", lambda: pytest.fail("loaded the library"))
    wins, rf, beta, bias = _cpu_operands(change)
    before = K.LAUNCHES
    with pytest.raises(ValueError, match=match):
        K._operands(*wins, rf, beta, bias)
    assert K.LAUNCHES == before


@pytest.mark.parametrize("dtype,d,rf_dtype", [
    (torch.bfloat16, 16, torch.bfloat16), (torch.bfloat16, 48, torch.float32),
    (torch.float32, 12, torch.float32),
])
def test_launch_operands_and_geometry(dtype, d, rf_dtype, monkeypatch):
    """The checked operands: contiguous, 16-byte aligned, in the promoted
    type of the inputs (f32 summaries promote bf16 q, k, v), the bias in
    f32; the geometry (B, H, G, S, C, d, windows a block)."""
    monkeypatch.setattr(K, "_lib", lambda: pytest.fail("loaded the library"))
    wins, rf, beta, _ = _cpu_operands(dict(dtype=dtype, d=d))
    bias = torch.zeros(3, 16, 16, dtype=torch.float64)
    ops, bias, geometry = K._operands(*wins, rf.to(rf_dtype), beta, bias)
    assert geometry == (2, 3, 4, 16, 6, d, 4)
    want = torch.promote_types(dtype, rf_dtype)
    assert [t.dtype for t in ops] == [want] * 5 and bias.dtype == torch.float32
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ops)

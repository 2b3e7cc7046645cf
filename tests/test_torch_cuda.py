"""Tests of the PyTorch port that need an NVIDIA GPU (marker ``cuda``): the
kernels eva_single (K2), eva_packed (K1), causal_packed (K3), eva_1d (K4),
lara_fused (K5), performer_fused (K6), local_packed (K7), eva_summaries (K8),
eva_packed_out (K9), eva_mega (K10), eva_kernel (K11) and eva_rowmajor (K12)
against their plain versions, the wrappers' refusal to fall back when a
library is missing, a small generation whose encoder runs K4, EVA's eval
routes on the card, and a 2-block model on K11.

They skip where ``torch.cuda.is_available()`` is false.  This file imports
neither JAX nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from efficient_attention_torch.ops.kernels import eva_single as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _k2_args(device, dtype, B, g, ws, j, nh, d, use_ln, seed=13):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    qkv = t(B, g * g, 3 * nh * d).to(dtype)
    dense = [0.2 * t(d, d), 0.1 * t(d), 0.2 * t(d, d), 0.1 * t(d)]
    ln = ([1 + 0.1 * t(d), 0.1 * t(d), 1 + 0.1 * t(d), 0.1 * t(d)]
          if use_ln else [None] * 4)
    return (qkv, *dense, *ln, d ** -0.5, nh, g, ws, j, use_ln), t(nh, ws * ws, ws * ws)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -6)])
@pytest.mark.parametrize("geometry", [(2, 28, 7, 4, 3, 64, True),
                                      (2, 14, 7, 2, 4, 12, True),
                                      (2, 8, 4, 4, 3, 16, False)])
def test_eva_single_kernel_matches_plain(cuda_device, geometry, dtype, tol):
    """Kernel vs plain version on the same card inputs: in f32 they differ
    only in summation order; in bf16 also by one rounding of outputs below
    4 (bf16 spacing 2**-6 there)."""
    args, bias = _k2_args(cuda_device, dtype, *geometry)
    before = K.LAUNCHES
    out = K.eva_attention_single(*args, bias=bias)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    ref = K.eva_attention_single_ref(*args, bias=bias)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("geometry", [(2, 28, 7, 4, 3, 64), (2, 28, 7, 4, 4, 32),
                                      (2, 14, 7, 2, 3, 64), (2, 8, 4, 4, 3, 16),
                                      (2, 12, 3, 4, 2, 16)])
def test_eva_single_mma_route_matches_plain(cuda_device, geometry, with_bias, use_ln):
    """bf16 at head dims 16, 32 and 64 takes the tensor-core kernel (counted
    by LAUNCHES_MMA) and matches the plain version to one rounding of
    outputs below 4 (2**-6); the CUDA-core kernel forced on the same inputs
    stays off the route and within the same limit."""
    args, bias = _k2_args(cuda_device, torch.bfloat16, *geometry, use_ln)
    bias = bias if with_bias else None
    ref = K.eva_attention_single_ref(*args, bias=bias)
    before = (K.LAUNCHES, K.LAUNCHES_MMA)
    out = K.eva_attention_single(*args, bias=bias)
    old = K.eva_attention_single(*args, bias=bias, cuda_cores=True)
    torch.cuda.synchronize()
    assert (K.LAUNCHES, K.LAUNCHES_MMA) == (before[0] + 2, before[1] + 1)
    for got in (out, old):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert (got.float() - ref.float()).abs().max().item() <= 2 ** -6


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_eva_single_large_norm_keys_match_plain(cuda_device, dtype):
    """Keys x40 and zero queries: every member lies far from mu, so only a
    chunk softmax at its true maximum stays finite; bf16 on the tensor-core
    kernel, f32 on the CUDA-core one."""
    args, bias = _k2_args(cuda_device, torch.float32, 1, 8, 4, 4, 2, 16, True)
    qkv = args[0].clone()
    qkv[..., :32] = 0.0
    qkv[..., 32:64] *= 40.0
    args = (qkv.to(dtype), *args[1:])
    before = K.LAUNCHES_MMA
    out = K.eva_attention_single(*args, bias=bias)
    torch.cuda.synchronize()
    assert K.LAUNCHES_MMA - before == int(dtype == torch.bfloat16)
    ref = K.eva_attention_single_ref(*args, bias=bias)
    assert torch.isfinite(out.float()).all()
    tol = 2 ** -6 if dtype == torch.bfloat16 else 1e-5
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_eva_single_off_the_mma_route(cuda_device):
    """f32, head dim 12, and bf16 whose padded rows fit a block at no cluster
    size (21x21 tokens in one-token chunks, head dim 16) keep the CUDA-core
    kernel: no LAUNCHES_MMA, and the plain version's result."""
    before = (K.LAUNCHES, K.LAUNCHES_MMA)
    geometries = ((torch.float32, (2, 28, 7, 4, 3, 64), 1e-5),
                  (torch.bfloat16, (2, 14, 7, 2, 4, 12), 2 ** -6),
                  (torch.bfloat16, (2, 21, 7, 1, 2, 16), 2 ** -6))
    for dtype, geometry, tol in geometries:
        B, g, ws, j, nh, d = geometry
        assert K.plan(B, nh, g, g, ws, j, d, torch.finfo(dtype).bits // 8)[2] is False
        args, bias = _k2_args(cuda_device, dtype, *geometry, True)
        out = K.eva_attention_single(*args, bias=bias)
        torch.cuda.synchronize()
        ref = K.eva_attention_single_ref(*args, bias=bias)
        assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (K.LAUNCHES, K.LAUNCHES_MMA) == (before[0] + len(geometries), before[1])


def test_eva_single_kernel_raises_outside_its_gate(cuda_device):
    args, bias = _k2_args(cuda_device, torch.float32, 1, 8, 4, 4, 2, 24, True)
    with pytest.raises(ValueError, match="cannot take"):  # head dim 24
        K.eva_attention_single(*args, bias=bias)
    args, bias = _k2_args(cuda_device, torch.float16, 1, 8, 4, 4, 3, 16, True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K.eva_attention_single(*args, bias=bias)


def _k1_args(device, dtype, B, g, ws, C, nh, d, seed=17):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    return (t(B, g * g, 3 * nh * d).to(dtype), t(B, C, nh * d).to(dtype),
            t(B, C, nh * d).to(dtype), 0.5 * t(nh, ws * ws, ws * ws),
            t(B, g * g, nh * d).to(dtype))


def _k1_tol(dtype, ref):
    """f32: summation order (and atomics order in the backward's sums)
    only; bf16: one rounding of the output, one bf16 spacing (2**-7
    relative) at the output's largest magnitude."""
    scale = max(1.0, ref.float().abs().max().item())
    return (1e-5 if dtype == torch.float32 else 2 ** -7) * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry", [(2, 28, 7, 49, 3, 64),
                                      (2, 14, 7, 49, 4, 12),
                                      (3, 8, 4, 4, 3, 16)])
def test_eva_packed_kernels_match_plain(cuda_device, geometry, dtype):
    from efficient_attention_torch.ops.kernels import eva_packed as K1

    B, g, ws, C, nh, d = geometry
    qkv, rf, beta, bias, grad = _k1_args(cuda_device, dtype, *geometry)
    scale = d ** -0.5
    counters = lambda: (K1.LAUNCHES_FWD, K1.LAUNCHES_FWD_MMA,  # noqa: E731
                        K1.LAUNCHES_BWD, K1.LAUNCHES_BWD_MMA)
    before = counters()
    leaves = [t.clone().requires_grad_() for t in (qkv, rf, beta, bias)]
    out = K1.eva_attention_packed(*leaves[:3], scale, nh, g, ws, bias=leaves[3])
    out.backward(grad)
    torch.cuda.synchronize()
    # bf16 at head dims 16 and 64 takes the tensor-core forward and backward
    mma = int(dtype == torch.bfloat16 and d % 16 == 0)
    assert counters() == (before[0] + 1, before[1] + mma, before[2] + 1,
                          before[3] + mma)
    ref = K1.eva_packed_fwd_ref(qkv, rf, beta, scale, nh, g, ws, bias)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(dtype, ref)
    want = K1.eva_packed_bwd_ref(qkv, rf, beta, bias, grad, scale, nh, g, ws)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == w.dtype and leaf.grad.shape == w.shape
        tol = _k1_tol(w.dtype, w)
        assert (leaf.grad.float() - w.float()).abs().max().item() <= tol


@pytest.mark.parametrize("geometry,with_bias", [
    ((2, 56, 7, 49, 2, 32), True),    # PVT-B3 stage 1: heads of 32
    ((3, 8, 4, 4, 3, 16), False),     # S + C = 20, not a multiple of 16
    ((2, 28, 7, 49, 3, 64), False),   # the headline geometry without a bias
    ((2, 28, 7, 196, 2, 16), True),   # 245 keys: a strip takes two passes
])
def test_eva_packed_mma_backward_matches_plain(cuda_device, geometry, with_bias):
    """The tensor-core backward (bf16, head dims multiples of 16) against
    the plain version, to one bf16 rounding of each output."""
    from efficient_attention_torch.ops.kernels import eva_packed as K1

    B, g, ws, C, nh, d = geometry
    qkv, rf, beta, bias, grad = _k1_args(cuda_device, torch.bfloat16, *geometry)
    bias = bias if with_bias else None
    scale = d ** -0.5
    before = (K1.LAUNCHES_BWD, K1.LAUNCHES_BWD_MMA)
    got = K1._backward(qkv, rf, beta, bias, grad, scale, nh, g, ws)
    torch.cuda.synchronize()
    assert (K1.LAUNCHES_BWD, K1.LAUNCHES_BWD_MMA) == (before[0] + 1, before[1] + 1)
    want = K1.eva_packed_bwd_ref(qkv, rf, beta, bias, grad, scale, nh, g, ws)
    for name, a, w in zip(("dqkv", "drf", "dbeta", "dbias"), got, want):
        if w is None:
            assert a is None, name
            continue
        assert a.dtype == w.dtype and a.shape == w.shape, name
        err = (a.float() - w.float()).abs().max().item()
        assert err <= _k1_tol(w.dtype, w), (name, err)


def test_eva_packed_cuda_core_backward_takes_bf16_when_asked(cuda_device):
    """``cuda_cores=True`` runs the CUDA-core backward on bf16 (timed beside
    the tensor-core route)."""
    from efficient_attention_torch.ops.kernels import eva_packed as K1

    geometry = (2, 8, 4, 4, 3, 16)
    qkv, rf, beta, bias, grad = _k1_args(cuda_device, torch.bfloat16, *geometry)
    before = (K1.LAUNCHES_BWD, K1.LAUNCHES_BWD_MMA)
    got = K1._backward(qkv, rf, beta, bias, grad, 0.25, 3, 8, 4, cuda_cores=True)
    torch.cuda.synchronize()
    assert (K1.LAUNCHES_BWD, K1.LAUNCHES_BWD_MMA) == (before[0] + 1, before[1])
    want = K1.eva_packed_bwd_ref(qkv, rf, beta, bias, grad, 0.25, 3, 8, 4)
    for a, w in zip(got, want):
        assert (a.float() - w.float()).abs().max().item() <= _k1_tol(w.dtype, w)


@pytest.mark.parametrize("geometry,with_bias", [
    ((2, 28, 7, 49, 3, 64), True),    # the headline geometry
    ((2, 56, 7, 49, 2, 32), True),    # PVT-B3 stage 1: heads of 32
    ((3, 8, 4, 4, 3, 16), False),     # S + C = 20, not a multiple of 16
    ((2, 28, 7, 196, 2, 16), True),   # 245 keys: a strip takes two passes
])
def test_eva_packed_mma_forward_matches_plain(cuda_device, geometry, with_bias):
    """The tensor-core forward (bf16, head dims multiples of 16) against the
    plain version, to one bf16 rounding of the output."""
    from efficient_attention_torch.ops.kernels import eva_packed as K1

    B, g, ws, C, nh, d = geometry
    qkv, rf, beta, bias, _ = _k1_args(cuda_device, torch.bfloat16, *geometry)
    bias = bias if with_bias else None
    scale = d ** -0.5
    before = (K1.LAUNCHES_FWD, K1.LAUNCHES_FWD_MMA)
    out = K1._forward(qkv, rf, beta, bias, scale, nh, g, ws)
    torch.cuda.synchronize()
    assert (K1.LAUNCHES_FWD, K1.LAUNCHES_FWD_MMA) == (before[0] + 1, before[1] + 1)
    ref = K1.eva_packed_fwd_ref(qkv, rf, beta, scale, nh, g, ws, bias)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref.dtype, ref)


def test_eva_packed_cuda_core_forward_takes_bf16_when_asked(cuda_device):
    """``cuda_cores=True`` runs the CUDA-core forward on bf16 (timed beside
    the tensor-core route)."""
    from efficient_attention_torch.ops.kernels import eva_packed as K1

    geometry = (2, 28, 7, 49, 3, 64)
    qkv, rf, beta, bias, _ = _k1_args(cuda_device, torch.bfloat16, *geometry)
    before = (K1.LAUNCHES_FWD, K1.LAUNCHES_FWD_MMA)
    out = K1._forward(qkv, rf, beta, bias, 0.125, 3, 28, 7, cuda_cores=True)
    torch.cuda.synchronize()
    assert (K1.LAUNCHES_FWD, K1.LAUNCHES_FWD_MMA) == (before[0] + 1, before[1])
    ref = K1.eva_packed_fwd_ref(qkv, rf, beta, 0.125, 3, 28, 7, bias)
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref.dtype, ref)


def test_eva_packed_kernel_raises_outside_its_gate(cuda_device):
    from efficient_attention_torch.ops.kernels import eva_packed as K1

    qkv, rf, beta, bias, _ = _k1_args(cuda_device, torch.float32, 1, 8, 4, 4,
                                      2, 24)
    with pytest.raises(ValueError, match="cannot take"):  # head dim 24
        K1.eva_attention_packed(qkv, rf, beta, 24 ** -0.5, 2, 8, 4, bias=bias)
    qkv, rf, beta, bias, _ = _k1_args(cuda_device, torch.float16, 1, 8, 4, 4,
                                      3, 16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K1.eva_attention_packed(qkv, rf, beta, 0.25, 3, 8, 4, bias=bias)


def _k3_args(device, dtype, B, T, nh, d, w, cs, seed=19):
    from efficient_attention_torch.ops.kernels import causal_packed as K3

    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    C = T // cs
    return ([t(B, T, nh * d).to(dtype) for _ in range(3)]
            + [t(B, C, nh * d).to(dtype), t(B, C, nh * d).to(dtype),
               K3.causal_table(w, 0.3 * t(w, w), device=device)],
            t(B, T, nh * d).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry", [(2, 512, 8, 128, 128, 8),
                                      (2, 64, 2, 64, 16, 4),
                                      (3, 16, 2, 64, 16, 4),
                                      (2, 96, 2, 64, 48, 8),
                                      (1, 256, 3, 128, 64, 16)])
def test_causal_packed_kernels_match_plain(cuda_device, geometry, dtype):
    """K3 forward and all six backward outputs against the plain versions:
    f32 to summation order (and the order of the backward's f32 atomics;
    the split-TF32 products drop about 2^-20 of each term), bf16 to one
    rounding (_k1_tol).  Every geometry here sends f32 through the
    forward's and the backward's split-TF32 routes and bf16 through the
    CUDA-core kernels."""
    from efficient_attention_torch.ops.kernels import causal_packed as K3

    B, T, nh, d, w, cs = geometry
    ops, grad = _k3_args(cuda_device, dtype, *geometry)
    scale = d ** -0.5
    counters = ("LAUNCHES_FWD", "LAUNCHES_BWD", "LAUNCHES_FWD_TF32", "LAUNCHES_BWD_TF32")
    before = [getattr(K3, c) for c in counters]
    leaves = [t.clone().requires_grad_() for t in ops]
    out = K3.causal_eva_packed(*leaves[:5], scale, nh, w, cs, bias_tab=leaves[5])
    out.backward(grad)
    torch.cuda.synchronize()
    tf32 = int(dtype == torch.float32)
    assert K3.fwd_uses_tf32x3(d, w, ops[0].element_size()) == bool(tf32)
    assert K3.bwd_uses_tf32x3(d, w, ops[0].element_size()) == bool(tf32)
    assert [getattr(K3, c) - b for c, b in zip(counters, before)] == [1, 1, tf32, tf32]
    ref = K3.causal_packed_fwd_ref(*ops, scale, nh, w, cs)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(dtype, ref)
    want = K3.causal_packed_bwd_ref(*ops, grad, scale, nh, w, cs)
    for leaf, w_ in zip(leaves, want):
        assert leaf.grad.dtype == w_.dtype and leaf.grad.shape == w_.shape
        err = (leaf.grad.float() - w_.float()).abs().max().item()
        assert err <= _k1_tol(dtype, w_)


@pytest.mark.parametrize("geometry", [(2, 512, 8, 128, 128, 8),
                                      (2, 96, 2, 64, 48, 8)])
def test_causal_packed_cuda_core_backward_takes_f32_when_asked(cuda_device, geometry):
    """``cuda_cores=True`` forces the CUDA-core backward on f32 inside the
    split-TF32 route's gate; it holds the same limit as that route."""
    from efficient_attention_torch.ops.kernels import causal_packed as K3

    B, T, nh, d, w, cs = geometry
    ops, grad = _k3_args(cuda_device, torch.float32, *geometry)
    scale = d ** -0.5
    before = (K3.LAUNCHES_BWD, K3.LAUNCHES_BWD_TF32)
    got = K3._backward(*ops, grad, scale, nh, w, cs, cuda_cores=True)
    torch.cuda.synchronize()
    assert (K3.LAUNCHES_BWD, K3.LAUNCHES_BWD_TF32) == (before[0] + 1, before[1])
    want = K3.causal_packed_bwd_ref(*ops, grad, scale, nh, w, cs)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert (a - b).abs().max().item() <= _k1_tol(torch.float32, b)


def test_causal_packed_kernel_raises_outside_its_gate(cuda_device):
    from efficient_attention_torch.ops.kernels import causal_packed as K3

    ops, _ = _k3_args(cuda_device, torch.float32, 1, 64, 2, 48, 16, 4)
    with pytest.raises(ValueError, match="cannot take"):  # head dim 48
        K3.causal_eva_packed(*ops[:5], 48 ** -0.5, 2, 16, 4, bias_tab=ops[5])
    ops, _ = _k3_args(cuda_device, torch.float16, 1, 64, 2, 64, 16, 4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K3.causal_eva_packed(*ops[:5], 0.125, 2, 16, 4, bias_tab=ops[5])


# ---- K5 lara_fused, K6 performer_fused, K7 local_packed ----

def _lin_args(device, dtype, B, g, nh, d, C, m, ws, seed=23):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    logits = t(B, nh, C)
    return dict(qkv=t(B, g * g, 3 * nh * d).to(dtype), w=0.5 * t(B, nh, C, d),
                qb=0.5 * t(B, nh, C, d), bal=torch.softmax(logits, -1),
                lp=t(B, nh, C), proj=t(nh, m, d),
                bias=0.5 * t(nh, ws * ws, ws * ws))


LIN_GEOMETRIES = [(2, 28, 3, 64, 49, 64, 7), (2, 14, 4, 12, 4, 16, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry", LIN_GEOMETRIES)
def test_linear_attention_kernels_match_plain(cuda_device, geometry, dtype):
    """K5, K6 and K7 against their plain versions on the same card inputs
    (_k1_tol: f32 to summation order, bf16 to one rounding), one launch
    each; K7's backward (autograd over its plain version) runs on the
    card."""
    from efficient_attention_torch.ops.kernels import lara_fused as K5
    from efficient_attention_torch.ops.kernels import local_packed as K7
    from efficient_attention_torch.ops.kernels import performer_fused as K6

    B, g, nh, d, C, m, ws = geometry
    a = _lin_args(cuda_device, dtype, *geometry)
    scale = d ** -0.5
    before = (K5.LAUNCHES, K6.LAUNCHES, K7.LAUNCHES, K7.LAUNCHES_MMA)
    pairs = [
        (K5.lara_attention_fused(a["qkv"], a["w"], a["qb"], a["bal"], a["lp"],
                                 scale, nh, alpha_coeff=2.0),
         K5.lara_fused_ref(a["qkv"], a["w"], a["qb"], a["bal"], a["lp"], scale,
                           nh, 2.0)),
        (K6.performer_attention_fused(a["qkv"], a["proj"], nh),
         K6.performer_fused_ref(a["qkv"], a["proj"], nh)),
    ]
    if d in K7.HEAD_DIMS:
        qkv = a["qkv"].clone().requires_grad_()
        out = K7.local_attention_packed(qkv, scale, nh, g, ws, bias=a["bias"])
        out.float().sum().backward()
        assert qkv.grad is not None and torch.isfinite(qkv.grad.float()).all()
        pairs.append((out.detach(), K7.local_packed_ref(a["qkv"], scale, nh, g,
                                                        ws, a["bias"])))
    torch.cuda.synchronize()
    assert (K5.LAUNCHES, K6.LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert K7.LAUNCHES == before[2] + (d in K7.HEAD_DIMS)
    # bf16 at head dim 64 on the tensor-core route; f32 and head dim 12 off it
    assert K7.LAUNCHES_MMA == before[3] + (dtype == torch.bfloat16 and d == 64)
    for out, ref in pairs:
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(dtype, ref)


def _k5_tol(ref):
    """One bf16 spacing (2^-7) of K5's largest output, with no floor at 1:
    its outputs are means of v rows, well below 1."""
    return 2 ** -7 * ref.float().abs().max().item()


@pytest.mark.parametrize("key_scale", [1.0, 30.0])
@pytest.mark.parametrize("geometry", [(4, 28, 3, 64, 49), (4, 14, 3, 64, 49),
                                      (2, 8, 2, 32, 17), (2, 28, 4, 16, 1),
                                      (1, 56, 1, 64, 64)])
def test_lara_fused_cluster_route_matches_plain(cuda_device, geometry, key_scale):
    """K5's bf16 cluster route (head dims 16, 32, 64; 1 to 64 landmarks;
    one to eight blocks a cluster) against the plain version on the same
    card inputs, to one bf16 spacing (2^-7) of the output's largest value,
    also with keys scaled x30; one launch, counted on the route."""
    from efficient_attention_torch.ops.kernels import lara_fused as K5

    B, g, nh, d, C = geometry
    a = _lin_args(cuda_device, torch.bfloat16, B, g, nh, d, C, 16, 7, seed=41 + C)
    a["qkv"][..., nh * d:2 * nh * d] *= key_scale
    assert K5.plan(B, g * g, nh, d, C, 2)[2] == "cluster"
    before = (K5.LAUNCHES, K5.LAUNCHES_MMA)
    out = K5.lara_attention_fused(a["qkv"], a["w"], a["qb"], a["bal"], a["lp"],
                                  d ** -0.5, nh, alpha_coeff=2.0)
    torch.cuda.synchronize()
    assert (K5.LAUNCHES, K5.LAUNCHES_MMA) == (before[0] + 1, before[1] + 1)
    ref = K5.lara_fused_ref(a["qkv"], a["w"], a["qb"], a["bal"], a["lp"],
                            d ** -0.5, nh, 2.0)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _k5_tol(ref)


@pytest.mark.parametrize("geometry", [(2, 784, 1, 512, 16), (2, 784, 2, 128, 49),
                                      (2, 196, 3, 64, 100), (1, 3200, 1, 48, 17)])
def test_lara_fused_wmma_route_matches_plain(cuda_device, geometry):
    """K5's bf16 wmma kernel at geometries the cluster route leaves it (head
    dims 512, 128 and 48, 100 landmarks) against the plain version, to one
    bf16 spacing of the output's largest value; one launch, not counted on
    the cluster route."""
    from efficient_attention_torch.ops.kernels import lara_fused as K5

    B, N, nh, d, C = geometry
    rng = np.random.default_rng(43 + d)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda_device)
    qkv = t(B, N, 3 * nh * d).to(torch.bfloat16)
    w, qb = 0.5 * t(B, nh, C, d), 0.5 * t(B, nh, C, d)
    bal, lp = torch.softmax(t(B, nh, C), -1), t(B, nh, C)
    assert K5.plan(B, N, nh, d, C, 2)[2] == "wmma"
    before = (K5.LAUNCHES, K5.LAUNCHES_MMA)
    out = K5.lara_attention_fused(qkv, w, qb, bal, lp, d ** -0.5, nh, alpha_coeff=2.0)
    torch.cuda.synchronize()
    assert (K5.LAUNCHES, K5.LAUNCHES_MMA) == (before[0] + 1, before[1])
    ref = K5.lara_fused_ref(qkv, w, qb, bal, lp, d ** -0.5, nh, 2.0)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _k5_tol(ref)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("geometry", [(2, 8, 3, 16, 4), (2, 9, 2, 32, 3),
                                      (2, 14, 3, 64, 7), (2, 22, 2, 64, 11)])
def test_local_packed_mma_route_matches_plain(cuda_device, geometry, with_bias):
    """K7's bf16 tensor-core route (head dims 16, 32, 64; ws 11 takes two
    passes) against the plain version on the same card inputs, to one bf16
    rounding (_k1_tol), with and without the bias; one launch, counted on
    the route."""
    from efficient_attention_torch.ops.kernels import local_packed as K7

    B, g, nh, d, ws = geometry
    a = _lin_args(cuda_device, torch.bfloat16, B, g, nh, d, 4, 16, ws,
                  seed=31 + ws)
    bias = a["bias"] if with_bias else None
    before = (K7.LAUNCHES, K7.LAUNCHES_MMA)
    out = K7.local_attention_packed(a["qkv"], d ** -0.5, nh, g, ws, bias=bias)
    torch.cuda.synchronize()
    assert (K7.LAUNCHES, K7.LAUNCHES_MMA) == (before[0] + 1, before[1] + 1)
    ref = K7.local_packed_ref(a["qkv"], d ** -0.5, nh, g, ws, bias)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(torch.bfloat16, ref)


# K6's bf16 ring route (B, tokens, heads, head dim, features, key scale):
# the cell's width, DeiT-tiny-p16's 196 tokens, 3136 tokens, head dims 16
# and 32, 16 and 128 features, one image (fewer items than SMs), 49 tokens
# (a ragged last tile), keys x30 (every k' near 1e-4)
K6_RING_GEOMETRIES = [(4, 784, 3, 64, 64, 1.0), (4, 196, 3, 64, 64, 1.0),
                      (1, 3136, 3, 64, 64, 1.0), (2, 784, 12, 16, 64, 1.0),
                      (2, 784, 6, 32, 64, 1.0), (2, 784, 3, 64, 16, 1.0),
                      (2, 784, 3, 64, 128, 1.0), (1, 784, 3, 64, 64, 1.0),
                      (3, 49, 3, 64, 64, 1.0), (4, 784, 3, 64, 64, 30.0)]


def _k6_args(device, B, N, nh, d, m, key_scale=1.0, dtype=torch.bfloat16, seed=47):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * nh * d)).astype(np.float32)
    qkv[..., nh * d:2 * nh * d] *= key_scale
    proj = rng.standard_normal((nh, m, d)).astype(np.float32)
    return (torch.from_numpy(qkv).to(device).to(dtype), torch.from_numpy(proj).to(device))


def _k6_check(K6, qkv, proj, nh, on_ring, tol, config=None):
    """One launch of K6, counted on the ring route or off it, against the
    plain version within ``tol`` of the output's largest value."""
    before = (K6.LAUNCHES, K6.LAUNCHES_RING)
    out = K6.performer_attention_fused(qkv, proj, nh, config=config)
    torch.cuda.synchronize()
    assert (K6.LAUNCHES, K6.LAUNCHES_RING) == (before[0] + 1, before[1] + on_ring)
    ref = K6.performer_fused_ref(qkv, proj, nh)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    peak = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol * peak


@pytest.mark.parametrize("geometry", K6_RING_GEOMETRIES)
def test_performer_fused_ring_route_matches_plain(cuda_device, geometry):
    """K6's bf16 ring route at the layout plan picks, against the plain
    version on the same card inputs, to one bf16 rounding (2^-7) of the
    output's largest value; one launch, counted on the route."""
    from efficient_attention_torch.ops.kernels import performer_fused as K6

    B, N, nh, d, m, key_scale = geometry
    assert K6.plan(B, N, nh, d, m, 2) is not None
    qkv, proj = _k6_args(cuda_device, B, N, nh, d, m, key_scale)
    _k6_check(K6, qkv, proj, nh, 1, 2 ** -7)


@pytest.mark.parametrize("layout", [(4, 64, 4, 3), (4, 32, 8, 3), (8, 128, 4, 1),
                                    (8, 64, 6, 1), (4, 16, 5, 2)])
def test_performer_fused_ring_layouts_match_plain(cuda_device, layout):
    """Every kind of ring layout (4 and 8 warps, 16- to 128-row tiles, 4 to
    8 slots) forced at 200 tokens (a ragged last tile), against the plain
    version to one bf16 rounding."""
    from efficient_attention_torch.ops.kernels import performer_fused as K6

    qkv, proj = _k6_args(cuda_device, 3, 200, 3, 64, 64, seed=48)
    _k6_check(K6, qkv, proj, 3, 1, 2 ** -7, config=layout)


def test_performer_fused_old_kernels_serve_the_rest(cuda_device):
    """Where plan names no ring layout, the launch takes the kernel that took
    it before and is not counted on the ring route: bf16 at head dim 48 the
    wmma kernel, f32 the CUDA-core kernel; ``config=0`` forces the wmma
    kernel at the cell's width."""
    from efficient_attention_torch.ops.kernels import performer_fused as K6

    assert K6.plan(2, 784, 2, 48, 64, 2) is None and K6.uses_mma(48, 64, 2)
    qkv, proj = _k6_args(cuda_device, 2, 784, 2, 48, 64)
    _k6_check(K6, qkv, proj, 2, 0, 2 ** -7)
    qkv, proj = _k6_args(cuda_device, 2, 784, 3, 64, 64, dtype=torch.float32)
    assert K6.plan(2, 784, 3, 64, 64, 4) is None
    before = K6.LAUNCHES_RING
    out = K6.performer_attention_fused(qkv, proj, 3)
    ref = K6.performer_fused_ref(qkv, proj, 3)
    assert K6.LAUNCHES_RING == before
    assert (out - ref).abs().max().item() <= _k1_tol(torch.float32, ref)
    qkv, proj = _k6_args(cuda_device, 2, 784, 3, 64, 64)
    _k6_check(K6, qkv, proj, 3, 0, 2 ** -7, config=0)


def test_performer_fused_ring_layout_and_occupancy(cuda_device):
    """The wrapper's copy of the ring layout, grid and gate against the
    kernel's (``performer_fused_ring_smem_bytes``, ``..._ring_blocks``),
    the headline plan's blocks an SM fit on the card, and a layout the
    route does not take is refused by the launcher and the wrapper alike."""
    from efficient_attention_torch.ops.kernels import performer_fused as K6

    lib = K6._lib()
    for layout in ((64, 64, 784, 4, 64, 4), (64, 64, 784, 8, 128, 4),
                   (16, 16, 49, 4, 16, 4), (32, 128, 3136, 8, 64, 8),
                   (64, 64, 784, 4, 64, 3), (64, 64, 60000, 8, 128, 4)):
        want = K6.ring_smem_bytes(*layout) if K6.ring_config_ok(*layout) else -1
        assert lib.performer_fused_ring_smem_bytes(*layout) == want
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, nh, bps in ((128, 3, 3), (1, 3, 3), (7, 12, 1), (128, 12, 3)):
        assert lib.performer_fused_ring_blocks(B, nh, bps) == K6.ring_blocks(B, nh, bps, sms)
    cfg = K6.plan(128, 784, 3, 64, 64, 2)
    assert lib.performer_fused_ring_blocks_per_sm(64, 64, cfg.warps, cfg.smem) >= cfg.bps
    qkv, proj = _k6_args(cuda_device, 2, 196, 3, 64, 64)
    with pytest.raises(ValueError, match="ring layout"):
        K6.performer_attention_fused(qkv, proj, 3, config=(4, 64, 3, 3))
    out = torch.empty(2, 196, 192, dtype=torch.bfloat16, device=cuda_device)
    rc = lib.performer_fused_launch(qkv.data_ptr(), proj.data_ptr(), out.data_ptr(), 2, 196,
                                    3, 64, 64, 1, 64 ** -0.25, 0.5 / 8, 0.125, 4, 64, 3, 3,
                                    torch.cuda.current_stream().cuda_stream)
    assert rc != 0


def test_linear_attention_wrappers_raise_without_their_library(
        cuda_device, monkeypatch, tmp_path):
    """Where a kernel's library cannot be built, its wrapper raises for a
    CUDA tensor; it never takes the plain version."""
    from efficient_attention_torch.ops.kernels import _build
    from efficient_attention_torch.ops.kernels import lara_fused as K5
    from efficient_attention_torch.ops.kernels import local_packed as K7
    from efficient_attention_torch.ops.kernels import performer_fused as K6

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    kernels = (K5, K6, K7)
    for k in kernels:
        k._lib.cache_clear()
    try:
        a = _lin_args(cuda_device, torch.float32, *LIN_GEOMETRIES[0])
        before = [k.LAUNCHES for k in kernels]
        calls = [
            lambda: K5.lara_attention_fused(a["qkv"], a["w"], a["qb"], a["bal"],
                                            a["lp"], 0.125, 3),
            lambda: K6.performer_attention_fused(a["qkv"], a["proj"], 3),
            lambda: K7.local_attention_packed(a["qkv"], 0.125, 3, 28, 7,
                                              bias=a["bias"]),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="nvcc"):
                call()
        assert [k.LAUNCHES for k in kernels] == before
    finally:
        for k in kernels:
            k._lib.cache_clear()


# ---- K4 eva_1d ----

def _k4_args(device, dtype, B, N, nh, d, ws, ext, C, seed=29):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    lens = np.maximum(1, N - rng.integers(0, N, B))
    lens[0] = N
    mask = torch.from_numpy(np.arange(N)[None] >= lens[:, None]).to(device)
    return (t(B, N, 3 * nh * d).to(dtype), t(B, C, nh * d).to(dtype),
            t(B, C, nh * d).to(dtype), mask, 0.5 * t(nh, ws, ws + 2 * ext))


K4_GEOMETRIES = [(8, 32, 8, 64, 8, 4, 8), (2, 256, 8, 64, 8, 4, 8), (3, 40, 3, 16, 8, 4, 5),
                 (2, 24, 2, 32, 4, 2, 6), (4, 64, 4, 128, 16, 8, 8), (3, 40, 4, 32, 4, 0, 5)]


def _k4_check(K4, args, geometry, config=None):
    """One launch against the plain version at non-pad rows of
    random-length sentences (_k1_tol: f32 to summation order, bf16 to one
    rounding); returns the launch's (LAUNCHES, LAUNCHES_TF32) counts."""
    B, N, nh, d, ws, ext, C = geometry
    qkv, rf, beta, mask, bias = args
    before = (K4.LAUNCHES, K4.LAUNCHES_TF32)
    with torch.no_grad():
        out = K4.eva_attention_1d(qkv, rf, beta, mask, d ** -0.5, nh, ws, ext,
                                  bias=bias, config=config)
        torch.cuda.synchronize()
        ref = K4.eva_1d_ref(qkv, rf, beta, mask, d ** -0.5, nh, ws, ext, bias)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    keep = ~mask
    err = (out.float() - ref.float())[keep].abs().max().item()
    assert err <= _k1_tol(qkv.dtype, ref[keep])
    return K4.LAUNCHES - before[0], K4.LAUNCHES_TF32 - before[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry", K4_GEOMETRIES)
def test_eva_1d_kernel_matches_plain(cuda_device, geometry, dtype):
    """K4 against its plain version on its default route: f32 on the
    split-TF32 route, bf16 on the CUDA-core kernel."""
    from efficient_attention_torch.ops.kernels import eva_1d as K4

    args = _k4_args(cuda_device, dtype, *geometry)
    assert _k4_check(K4, args, geometry) == (1, int(dtype == torch.float32))


@pytest.mark.parametrize("geometry", K4_GEOMETRIES)
def test_eva_1d_cuda_core_kernel_takes_f32_when_asked(cuda_device, geometry):
    from efficient_attention_torch.ops.kernels import eva_1d as K4

    args = _k4_args(cuda_device, torch.float32, *geometry)
    assert _k4_check(K4, args, geometry, config=0) == (1, 0)


@pytest.mark.parametrize("geometry,rows", [
    ((2, 256, 8, 64, 8, 4, 8), 16), ((2, 256, 8, 64, 8, 4, 8), 32),
    ((2, 256, 8, 64, 8, 4, 8), 64), ((2, 256, 8, 64, 8, 4, 8), 128),
    ((3, 72, 2, 64, 24, 5, 9), 16), ((3, 72, 2, 64, 24, 5, 9), 32),
    ((3, 72, 2, 64, 24, 5, 9), 48), ((5, 40, 3, 16, 8, 4, 5), 16),
    ((5, 40, 3, 16, 8, 4, 5), 32), ((5, 40, 3, 16, 8, 4, 5), 128)])
def test_eva_1d_tf32_layouts_match_plain(cuda_device, geometry, rows):
    """The f32 route at items of 16 to 128 query rows (1 to 8 warps) at the
    long shape, a window of 24 whose windows straddle the 16-row strips,
    and a ragged last strip (items longer than the sentence included)."""
    from efficient_attention_torch.ops.kernels import eva_1d as K4

    args = _k4_args(cuda_device, torch.float32, *geometry)
    assert _k4_check(K4, args, geometry, config=rows) == (1, 1)


def test_eva_1d_tf32_layout_and_occupancy(cuda_device):
    """The wrapper's copy of the f32 route's layout and gate against the
    kernel's (``eva_1d_tf32_smem_bytes``), and an item size the route does
    not take is refused by the launcher and the wrapper alike."""
    from efficient_attention_torch.ops.kernels import eva_1d as K4

    lib = K4._lib()
    for args in ((64, 8, 4, 8, 32), (16, 8, 4, 5, 16), (128, 16, 8, 8, 64), (32, 24, 5, 9, 48),
                 (64, 8, 4, 8, 128), (64, 8, 4, 8, 40), (64, 8, 4, 8, 144),
                 (48, 8, 4, 8, 32), (128, 256, 128, 8, 128)):
        want = K4.tf32_smem_bytes(*args) if K4.tf32_config_ok(*args) else -1
        assert lib.eva_1d_tf32_smem_bytes(*args) == want, args
    args = _k4_args(cuda_device, torch.float32, 2, 32, 2, 64, 8, 4, 4)
    with torch.no_grad(), pytest.raises(ValueError, match="do not fit"):
        K4.eva_attention_1d(*args[:4], 0.125, 2, 8, 4, bias=args[4], config=40)
    qkv, rf, beta, mask, bias = args
    out = torch.empty(2, 32, 128, device=cuda_device)
    rc = lib.eva_1d_launch(qkv.data_ptr(), rf.data_ptr(), beta.data_ptr(), mask.data_ptr(),
                           bias.data_ptr(), out.data_ptr(), 2, 32, 2, 64, 8, 4, 4, 0, 0,
                           0.125, 40, torch.cuda.current_stream().cuda_stream)
    assert rc != 0


def test_eva_1d_kernel_raises_outside_its_gate_or_without_its_library(
        cuda_device, monkeypatch, tmp_path):
    from efficient_attention_torch.ops.kernels import _build
    from efficient_attention_torch.ops.kernels import eva_1d as K4

    args = _k4_args(cuda_device, torch.float32, 1, 16, 2, 24, 8, 4, 2)
    with torch.no_grad(), pytest.raises(ValueError, match="cannot take"):
        K4.eva_attention_1d(*args[:4], 24 ** -0.5, 2, 8, 4, bias=args[4])  # head dim 24
    args = _k4_args(cuda_device, torch.float16, 1, 16, 2, 16, 8, 4, 2)
    with torch.no_grad(), pytest.raises(ValueError, match="float32 or bfloat16"):
        K4.eva_attention_1d(*args[:4], 0.25, 2, 8, 4, bias=args[4])

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    K4._lib.cache_clear()
    try:
        args = _k4_args(cuda_device, torch.float32, 2, 32, 2, 16, 8, 4, 4)
        before = K4.LAUNCHES
        with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc"):
            K4.eva_attention_1d(*args[:4], 0.25, 2, 8, 4, bias=args[4])
        assert K4.LAUNCHES == before
    finally:
        K4._lib.cache_clear()


def test_small_generation_runs_k4_in_every_encoder_layer(cuda_device, capsys):
    """``cli.generate`` on the card at a small width: 2 encoder layers, one
    batch, so 2 K4 launches; its f32 encoder states match the eager path."""
    import copy
    import json

    from efficient_attention_torch.cli import generate
    from efficient_attention_torch.ops.kernels import eva_1d as K4

    argv = ["--dummy-data", "--dummy-vocab", "120", "--encoder-embed-dim", "64",
            "--encoder-ffn-embed-dim", "128", "--encoder-layers", "2",
            "--encoder-attention-heads", "4", "--attn-name-encoder", "eva",
            "--encoder-attn-window-size", "8", "--encoder-attn-num-landmarks", "8",
            "--encoder-attn-overlap-window", "--encoder-attn-use-t5-rpe",
            "--encoder-attn-adaptive-proj", "no-ln",
            "--attn-name-decoder", "causal_eva", "--decoder-attn-window-size", "16",
            "--decoder-attn-chunk-size", "8", "--decoder-attn-adaptive-proj", "qk",
            "--decoder-attn-causal", "--share-all-embeddings", "--beam", "4",
            "--gen-batch", "8", "--gen-subset-size", "8", "--max-len-b", "16"]
    before = K4.LAUNCHES
    result = generate.cli_main(argv)
    assert K4.LAUNCHES == before + 2
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["sentences"] == 8 and np.isfinite(line["bleu"])
    args = generate.parse_args(argv)
    model = generate.build_model(args, 120, 120).to(cuda_device).eval()
    eager = copy.deepcopy(model)
    for layer in eager.encoder.layers:
        layer.self_attn.attn.impl = "xla"
    src, _, _, _ = generate.load_pairs(args)
    _, src_b, _, _, _ = next(generate.generation_batches(args, src))
    with torch.no_grad():
        (enc, pad), (want, _) = (m.encode(torch.from_numpy(src_b).to(cuda_device))
                                 for m in (model, eager))
    assert (enc - want)[~pad].abs().max().item() <= 1e-4
    assert result["sentences"] == 8


# ---- K8 eva_summaries, K9 eva_packed_out, K10 eva_mega ----

def _eval_operands(device, dtype, B, g, ws, j, nh, d, seed=31):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    dim, C = nh * d, (g // j) ** 2
    adaptive = [0.2 * t(d, d), 0.1 * t(d), 0.2 * t(d, d), 0.1 * t(d),
                1 + 0.1 * t(d), 0.1 * t(d), 1 + 0.1 * t(d), 0.1 * t(d)]
    return dict(qkv=t(B, g * g, 3 * dim).to(dtype), x=t(B, g * g, dim).to(dtype),
                wqkv=t(dim, 3 * dim) / dim ** 0.5, bqkv=0.1 * t(3 * dim),
                adaptive=adaptive, rf=t(B, C, dim).to(dtype),
                beta=t(B, C, dim).to(dtype), wo=t(dim, dim) / dim ** 0.5,
                bo=0.1 * t(dim), bias=0.5 * t(nh, ws * ws, ws * ws))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry", [(2, 28, 7, 4, 3, 64), (2, 8, 4, 2, 3, 16),
                                      (2, 14, 7, 2, 4, 12)])
def test_eval_kernels_match_plain(cuda_device, geometry, dtype):
    """K8, K9 and both K10 entry points against their plain versions on the
    same card inputs (_k1_tol: f32 to summation order, bf16 to one
    rounding), one launch each; head dim 64 and 16 take the tensor-core
    projections in bf16, 12 the CUDA-core ones."""
    from efficient_attention_torch.ops.kernels import eva_mega as K10
    from efficient_attention_torch.ops.kernels import eva_packed as K9
    from efficient_attention_torch.ops.kernels import eva_summaries as K8

    B, g, ws, j, nh, d = geometry
    a = _eval_operands(cuda_device, dtype, *geometry)
    scale = d ** -0.5
    counts = lambda: (K8.LAUNCHES, K9.LAUNCHES_OUT, K10.LAUNCHES_SUMMARIES,  # noqa: E731
                      K10.LAUNCHES_ATTENTION)
    before = counts()
    got = [*K8.eva_summaries_packed(a["qkv"], *a["adaptive"], nh, g, j, True),
           K9.eva_attention_packed_out(a["qkv"], a["rf"], a["beta"], a["wo"],
                                       a["bo"], scale, nh, g, ws, a["bias"]),
           *K10.eva_summaries_from_x(a["x"], a["wqkv"], a["bqkv"], *a["adaptive"],
                                     nh, g, j, True),
           K10.eva_attention_from_x(a["x"], a["wqkv"], a["bqkv"], a["rf"],
                                    a["beta"], a["wo"], a["bo"], scale, nh, g, ws,
                                    a["bias"])]
    torch.cuda.synchronize()
    assert counts() == tuple(n + 1 for n in before)
    want = [*K8.eva_summaries_packed_ref(a["qkv"], *a["adaptive"], nh, g, j, True),
            K9.eva_packed_out_ref(a["qkv"], a["rf"], a["beta"], a["wo"], a["bo"],
                                  scale, nh, g, ws, a["bias"]),
            *K10.eva_summaries_from_x_ref(a["x"], a["wqkv"], a["bqkv"],
                                          *a["adaptive"], nh, g, j, True),
            K10.eva_attention_from_x_ref(a["x"], a["wqkv"], a["bqkv"], a["rf"],
                                         a["beta"], a["wo"], a["bo"], scale, nh, g,
                                         ws, a["bias"])]
    for out, ref in zip(got, want):
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(dtype, ref)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("geometry", [(2, 28, 7, 4, 3, 64), (2, 56, 7, 8, 2, 32),
                                      (2, 14, 7, 2, 10, 32), (2, 28, 7, 2, 2, 16),
                                      (3, 8, 4, 4, 3, 16), (2, 18, 9, 3, 2, 32),
                                      (2, 28, 7, 4, 6, 64), (2, 14, 7, 2, 12, 64)])
def test_eval_out_mma_route_matches_plain(cuda_device, geometry, with_bias):
    """K9 and K10's attention on their bf16 tensor-core route against their
    plain versions (_k1_tol: one rounding), with the RPE bias and without:
    the DeiT-tiny-p8 shape, PVT-B3's first and third stages (heads of 32;
    the third's 10 heads staged a few at a time, Wo streamed), strips of
    two passes (196 chunks of head dim 16), an 8x8 grid of windows of 4,
    windows of 81 rows (more than a product pass's 64), and the small and
    base EVA ViTs (6 and 12 heads of 64, the window rows staged a few heads
    at a time, the base's K10 on the small ring); one launch each, on the
    route."""
    from efficient_attention_torch.ops.kernels import eva_mega as K10
    from efficient_attention_torch.ops.kernels import eva_packed as K9

    B, g, ws, j, nh, d = geometry
    a = _eval_operands(cuda_device, torch.bfloat16, *geometry)
    att = (a["rf"], a["beta"], a["wo"], a["bo"], d ** -0.5, nh, g, ws,
           a["bias"] if with_bias else None)
    tok = (a["x"], a["wqkv"], a["bqkv"])
    before = (K9.LAUNCHES_OUT_MMA, K10.LAUNCHES_ATTENTION_MMA)
    got = [K9.eva_attention_packed_out(a["qkv"], *att), K10.eva_attention_from_x(*tok, *att)]
    torch.cuda.synchronize()
    assert (K9.LAUNCHES_OUT_MMA, K10.LAUNCHES_ATTENTION_MMA) == tuple(n + 1 for n in before)
    want = [K9.eva_packed_out_ref(a["qkv"], *att), K10.eva_attention_from_x_ref(*tok, *att)]
    for out, ref in zip(got, want):
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(torch.bfloat16, ref)


def test_eval_out_mma_layout_and_occupancy(cuda_device):
    """The kernels' shared-memory layouts equal the wrappers' copies at the
    tensor-core route's geometries, and a block of the route fits an SM."""
    from efficient_attention_torch.ops.kernels import eva_mega as K10
    from efficient_attention_torch.ops.kernels import eva_packed as K9

    for d, S, C, nh in ((64, 49, 49, 3), (32, 49, 49, 2), (32, 49, 49, 10),
                        (16, 49, 196, 2), (16, 16, 4, 3), (64, 49, 49, 6),
                        (64, 49, 49, 12)):
        xdim = nh * d
        assert (K9._lib_out().eva_packed_out_smem_bytes(d, S, C, nh, 2, 0)
                == K9.smem_bytes_out(d, S, C, nh, 2))
        assert (K10._lib().eva_mega_attention_smem_bytes(d, S, C, nh, 2, xdim)
                == K9.smem_bytes_out(d, S, C, nh, 2, xdim))
        assert K9._lib_out().eva_packed_out_mma_blocks_per_sm(d, S, C, nh) >= 1
        assert K10._lib().eva_mega_attention_mma_blocks_per_sm(d, S, C, nh, xdim) >= 1


def test_eval_kernels_raise_outside_their_gates(cuda_device):
    from efficient_attention_torch.ops.kernels import eva_mega as K10
    from efficient_attention_torch.ops.kernels import eva_packed as K9
    from efficient_attention_torch.ops.kernels import eva_summaries as K8

    a = _eval_operands(cuda_device, torch.float32, 1, 8, 4, 4, 2, 24)  # head dim 24
    with pytest.raises(ValueError, match="cannot take"):
        K8.eva_summaries_packed(a["qkv"], *a["adaptive"][:4], *[None] * 4, 2, 8, 4,
                                False)
    with pytest.raises(ValueError, match="cannot take"):
        K9.eva_attention_packed_out(a["qkv"], a["rf"], a["beta"], a["wo"], a["bo"],
                                    0.2, 2, 8, 4, a["bias"])
    with pytest.raises(ValueError, match="cannot take"):
        K10.eva_attention_from_x(a["x"], a["wqkv"], a["bqkv"], a["rf"], a["beta"],
                                 a["wo"], a["bo"], 0.2, 2, 8, 4, a["bias"])
    a = _eval_operands(cuda_device, torch.float16, 1, 8, 4, 4, 3, 16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K10.eva_summaries_from_x(a["x"], a["wqkv"], a["bqkv"], *a["adaptive"], 3,
                                 8, 4, True)


def _sum_calls(a, nh, g, j, use_ln, **kw):
    """K8's and K10a's wrapper calls, their plain versions, their launch
    counters (all, persistent route) and the x width."""
    from efficient_attention_torch.ops.kernels import eva_mega as K10
    from efficient_attention_torch.ops.kernels import eva_summaries as K8

    summ = (*a["adaptive"][:4], *(a["adaptive"][4:] if use_ln else [None] * 4), nh, g, j,
            use_ln)
    tok = (a["x"], a["wqkv"], a["bqkv"])
    return {
        "K8": (lambda: K8.eva_summaries_packed(a["qkv"], *summ, **kw),
               lambda: K8.eva_summaries_packed_ref(a["qkv"], *summ),
               lambda: (K8.LAUNCHES, K8.LAUNCHES_MMA), 0),
        "K10a": (lambda: K10.eva_summaries_from_x(*tok, *summ, **kw),
                 lambda: K10.eva_summaries_from_x_ref(*tok, *summ),
                 lambda: (K10.LAUNCHES_SUMMARIES, K10.LAUNCHES_SUMMARIES_MMA), a["x"].shape[-1])}


@pytest.mark.parametrize("name", ["K8", "K10a"])
@pytest.mark.parametrize("geometry,use_ln,large", [
    ((2, 28, 7, 4, 3, 64), True, False),      # the headline's strips
    ((2, 28, 7, 4, 3, 64), False, False),     # no-ln
    ((2, 56, 7, 8, 2, 32), True, False),      # PVT-B3 stage 1: 448 rows, 64 members
    ((2, 28, 7, 4, 4, 32), True, False),      # stage 2
    ((2, 14, 7, 2, 10, 32), True, False),     # stage 3 (K8: the first kernel)
    ((2, 14, 7, 2, 3, 64), True, False),      # DeiT-tiny-p16 (K8: the first kernel)
    ((2, 28, 7, 4, 12, 16), True, False),     # head dim 16
    ((1, 28, 7, 4, 3, 64), True, False),      # a batch of 1
    ((2, 28, 7, 4, 3, 64), True, True),       # keys x40, zero queries
    ((1, 8, 4, 4, 2, 16), True, True),        # LARGE_KEYS (K8: the first kernel)
])
def test_eval_summaries_mma_route_matches_plain(cuda_device, name, geometry, use_ln, large):
    """K8 and K10a in bf16 on the route mma_plan picks (one launch, counted
    on LAUNCHES_MMA / LAUNCHES_SUMMARIES_MMA exactly where the plan takes
    the persistent route), each output within 2**-7 of its peak of the
    plain version; where the plan leaves K8 to the first kernel, the
    persistent route forced on the same inputs within the same limit."""
    from efficient_attention_torch.ops.kernels import eva_summaries as K8

    B, g, ws, j, nh, d = geometry
    a = _eval_operands(cuda_device, torch.float32, *geometry)
    hd = nh * d
    if large:
        a["qkv"][..., :hd] = 0.0
        a["qkv"][..., hd:2 * hd] *= 40.0
        for w in (a["wqkv"].T, a["bqkv"]):
            w[:hd] = 0.0
            w[hd:2 * hd] *= 40.0
    a["qkv"], a["x"] = a["qkv"].to(torch.bfloat16), a["x"].to(torch.bfloat16)
    route = K8.mma_plan(B, nh, g, g, j, d, 2, xdim=hd if name == "K10a" else 0)
    configs = [None] + ([(8, 2, 2, 1)] if route is None and name == "K8" else [])
    for config in configs:
        kernel, plain, counts, _ = _sum_calls(a, nh, g, j, use_ln, config=config)[name]
        before = counts()
        with torch.no_grad():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
        on_route = config is not None or route is not None
        assert counts() == (before[0] + 1, before[1] + int(on_route))
        for out, ref in zip(got, want):
            assert out.dtype == ref.dtype and out.shape == ref.shape
            assert torch.isfinite(out.float()).all()
            assert ((out.float() - ref.float()).abs().max().item()
                    <= 2 ** -7 * ref.float().abs().max().item())


def test_eval_summaries_route_gate_and_layout(cuda_device):
    """Which launches take the persistent route: bf16 at the headline does;
    f32, head dim 12, K10a at x of width 768 and ``config=0`` run the first
    kernel, which still serves them within its limits.  The kernel's layout
    equals the wrapper's copy, and the plan's blocks fit an SM."""
    from efficient_attention_torch.ops.kernels import eva_mega as K10
    from efficient_attention_torch.ops.kernels import eva_summaries as K8

    cases = [((2, 28, 7, 4, 3, 64), torch.bfloat16, {}, (True, True)),
             ((2, 28, 7, 4, 3, 64), torch.bfloat16, {"config": 0}, (False, False)),
             ((2, 28, 7, 4, 3, 64), torch.float32, {}, (False, False)),
             ((2, 14, 7, 2, 4, 12), torch.bfloat16, {}, (False, False)),
             ((1, 14, 7, 2, 12, 64), torch.bfloat16, {}, (False, False))]
    for geometry, dtype, kw, want in cases:
        B, g, ws, j, nh, d = geometry
        a = _eval_operands(cuda_device, dtype, *geometry)
        for (name, (kernel, plain, counts, xdim)), mma in zip(
                _sum_calls(a, nh, g, j, True, **kw).items(), want):
            before = counts()
            with torch.no_grad():
                got = kernel()
                torch.cuda.synchronize()
                want_out = plain()
            assert counts() == (before[0] + 1, before[1] + int(mma)), (name, geometry, kw)
            for out, ref in zip(got, want_out):
                assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(dtype, ref)
    for B, g, j, nh, d, xdim in ((128, 28, 4, 3, 64, 0), (128, 28, 4, 3, 64, 192),
                                 (16, 56, 8, 2, 32, 64), (16, 14, 2, 10, 32, 320),
                                 (16, 28, 4, 12, 16, 192)):
        cfg = K8.mma_plan(B, nh, g, g, j, d, 2, xdim=xdim)
        lib = K10._lib() if xdim else K8._lib()
        pre = "eva_mega_summaries" if xdim else "eva_summaries"
        args = (j * g, d, xdim, g // j, j * j, cfg.stages, cfg.teams)
        assert getattr(lib, f"{pre}_mma_smem_bytes")(*args) == K8.mma_smem_bytes(*args)
        assert (getattr(lib, f"{pre}_mma_blocks_per_sm")(d, cfg.warps, cfg.teams, cfg.smem)
                >= cfg.bps)


@pytest.mark.parametrize("toggles,counter", [
    (dict(use_single_kernel=False, use_pallas_summaries=True), "K8"),
    (dict(use_single_kernel=False, fuse_output_proj=True), "K9"),
    (dict(use_single_kernel=False, use_megakernel=True), "K10"),
])
def test_eva_eval_routes_on_the_card(cuda_device, toggles, counter):
    """A small 2-D EVA in f32 at eval on each kernel route: one launch of
    the route's kernel, the output within 1e-4 of the eager path."""
    from efficient_attention_torch import AttentionFactory
    from efficient_attention_torch.ops.kernels import eva_mega as K10
    from efficient_attention_torch.ops.kernels import eva_packed as K9
    from efficient_attention_torch.ops.kernels import eva_summaries as K8

    args = {"dim": 48, "num_heads": 3, "window_size": 4, "num_landmarks": 4,
            "attn_2d": True, "use_rpe": True}
    torch.manual_seed(0)
    m = AttentionFactory.build_attention("eva", dict(args, **toggles))
    eager = AttentionFactory.build_attention("eva", dict(args, impl="xla"))
    eager.load_state_dict(m.state_dict())
    m, eager = m.to(cuda_device).eval(), eager.to(cuda_device).eval()
    x = torch.randn(2, 8, 8, 48, device=cuda_device)
    count = {"K8": lambda: K8.LAUNCHES, "K9": lambda: K9.LAUNCHES_OUT,
             "K10": lambda: K10.LAUNCHES_ATTENTION}[counter]
    before = count()
    with torch.no_grad():
        out, want = m(x), eager(x)
    torch.cuda.synchronize()
    assert count() == before + 1
    assert (out - want).abs().max().item() <= 1e-4


# ---- K11 eva_kernel and K12 eva_rowmajor ----

def _k11_args(device, dtype, B, H, gh, gw, ws, C, d, seed=37):
    """Windows [B, H, G, S, d] of a gh x gw grid (and the same q, k, v in
    token order), chunk summaries and an RPE bias."""
    from efficient_attention_torch.ops import windows

    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    rows = [t(B, H, gh * gw, d).to(dtype) for _ in range(3)]
    wins = [windows.window_2d_partition(r.reshape(B, H, gh, gw, d), ws) for r in rows]
    return wins, rows, [t(B, H, C, d).to(dtype), t(B, H, C, d).to(dtype)], \
        0.5 * t(H, ws * ws, ws * ws)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry", [
    (2, 3, 28, 28, 7, 49, 64),    # the headline's windows
    (2, 2, 8, 12, 4, 6, 24),      # a head dim off the tensor-core route
    (2, 2, 28, 28, 7, 49, 48),    # the auto fallback's heads of 48
    (2, 2, 32, 32, 8, 64, 64),    # S + C = 128: two-pass strips
    (2, 4, 28, 28, 7, 49, 32),    # PVT-B3 stage 2
    (2, 10, 14, 14, 7, 49, 32),   # PVT-B3 stage 3
])
def test_eva_window_kernels_match_plain(cuda_device, geometry, dtype):
    """K11 on the windows and K12 on the tokens against their plain versions
    (relative to the largest output, as K1's); K11's output merged to token
    order equals K12's bit for bit (the same device code on the same
    rows)."""
    from efficient_attention_torch.ops import windows
    from efficient_attention_torch.ops.kernels import eva_kernel as K11
    from efficient_attention_torch.ops.kernels import eva_rowmajor as K12

    B, H, gh, gw, ws, C, d = geometry
    wins, rows, summ, bias = _k11_args(cuda_device, dtype, *geometry)
    before = K11.LAUNCHES, K12.LAUNCHES
    pairs = [(K11.eva_attention_fused(*wins, *summ, d ** -0.5, bias),
              K11.eva_fused_ref(*wins, *summ, d ** -0.5, bias)),
             (K12.eva_attention_rowmajor(*rows, *summ, d ** -0.5, gw, ws, bias),
              K12.eva_rowmajor_ref(*rows, *summ, d ** -0.5, gw, ws, bias))]
    torch.cuda.synchronize()
    assert (K11.LAUNCHES, K12.LAUNCHES) == (before[0] + 1, before[1] + 1)
    for out, ref in pairs:
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(dtype, ref)
    merged = windows.window_2d_merge(pairs[0][0], ws, (gh, gw)).reshape(B, H, -1, d)
    assert torch.equal(merged, pairs[1][0])


def test_eva_window_mma_route_gate_and_occupancy(cuda_device):
    """The tensor-core route's gate in the kernels equals its Python twin,
    and at 49 + 49 keys three blocks fit an SM at head dims 64 and 32."""
    from efficient_attention_torch.ops.kernels import eva_kernel as K11
    from efficient_attention_torch.ops.kernels import eva_rowmajor as K12

    for k, prefix in ((K11, "eva_kernel"), (K12, "eva_rowmajor")):
        lib = k._lib()
        for d in K11.HEAD_DIMS:
            for itemsize in (2, 4):
                assert (bool(getattr(lib, f"{prefix}_uses_mma")(d, itemsize))
                        == K11.uses_mma(d, itemsize))
                assert (getattr(lib, f"{prefix}_smem_bytes")(d, 49, 49, int(itemsize == 2))
                        == K11.smem_bytes(d, 49, 49, itemsize))
        for d in (64, 32):
            assert getattr(lib, f"{prefix}_mma_blocks_per_sm")(d, 49, 49) >= 3


def test_eva_window_kernels_raise_outside_their_gates_or_without_their_library(
        cuda_device, monkeypatch, tmp_path):
    from efficient_attention_torch.ops.kernels import _build
    from efficient_attention_torch.ops.kernels import eva_kernel as K11
    from efficient_attention_torch.ops.kernels import eva_rowmajor as K12

    wins, rows, summ, bias = _k11_args(cuda_device, torch.float32, 1, 2, 8, 8, 4,
                                       4, 20)  # head dim 20
    with pytest.raises(ValueError, match="cannot take"):
        K11.eva_attention_fused(*wins, *summ, 0.2, bias)
    with pytest.raises(ValueError, match="cannot take"):
        K12.eva_attention_rowmajor(*rows, *summ, 0.2, 8, 4, bias)
    wins, rows, summ, bias = _k11_args(cuda_device, torch.float16, 1, 2, 8, 8, 4,
                                       4, 16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K11.eva_attention_fused(*wins, *summ, 0.25, bias)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    for k in (K11, K12):
        k._lib.cache_clear()
    try:
        wins, rows, summ, bias = _k11_args(cuda_device, torch.float32, 1, 2, 8, 8,
                                           4, 4, 16)
        before = K11.LAUNCHES, K12.LAUNCHES
        with pytest.raises(RuntimeError, match="nvcc"):
            K11.eva_attention_fused(*wins, *summ, 0.25, bias)
        with pytest.raises(RuntimeError, match="nvcc"):
            K12.eva_attention_rowmajor(*rows, *summ, 0.25, 8, 4, bias)
        assert (K11.LAUNCHES, K12.LAUNCHES) == before
    finally:
        for k in (K11, K12):
            k._lib.cache_clear()


def test_two_block_headline_model_runs_k11_in_each_block(cuda_device):
    """A 2-block DeiT-tiny-p8 + EVA with impl='pallas' at 224 px, f32: one
    K11 launch a block, the logits within 1e-4 of the eager path."""
    from efficient_attention_torch.models import create_model
    from efficient_attention_torch.models.layers import init_weights
    from efficient_attention_torch.ops.kernels import eva_kernel as K11

    args = {"window_size": 7, "num_landmarks": 49, "attn_2d": True,
            "use_rpe": True, "adaptive_proj": "default"}
    m = create_model("evit_tiny_p8", attn_name="eva", depth=2,
                     attn_args=dict(args, impl="pallas"))
    eager = create_model("evit_tiny_p8", attn_name="eva", depth=2,
                         attn_args=dict(args, impl="xla"))
    init_weights(m, torch.Generator().manual_seed(0))
    eager.load_state_dict(m.state_dict())
    m, eager = m.to(cuda_device).eval(), eager.to(cuda_device).eval()
    x = torch.randn(4, 224, 224, 3, device=cuda_device)
    before = K11.LAUNCHES
    with torch.no_grad():
        out, want = m(x), eager(x)
    torch.cuda.synchronize()
    assert K11.LAUNCHES == before + 2
    assert (out - want).abs().max().item() <= 1e-4

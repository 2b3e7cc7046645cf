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
launches nothing.  The split-TF32 routes of the forward and the backward
(whose kernels run on the card only) are held here by their gates,
shared-memory layouts and tile walks, and by their arithmetic emulated with
TF32-rounded operands against the f32 limit the card holds them to.
"""
from unittest import mock

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


# ---- the forward's split-TF32 route: its gate, layout, tile walk and
# arithmetic (the kernel itself runs on the card only)


def test_fwd_uses_tf32x3_gate():
    """float32 at head dims 64 and 128 with whole 16-row strips takes the
    route; bfloat16, other head dims and windows of 8 keep the CUDA-core
    kernel."""
    for d, w in ((64, 16), (128, 128), (128, 48), (64, 96)):
        assert K.fwd_uses_tf32x3(d, w, 4)
    assert not K.fwd_uses_tf32x3(128, 128, 2)   # bf16
    assert not K.fwd_uses_tf32x3(48, 128, 4)    # head dim
    assert not K.fwd_uses_tf32x3(64, 8, 4)      # window of 8
    # the LM shape and every f32 geometry the card checks take it
    for B, T, nh, d, w, cs in ((18, 512, 8, 128, 128, 8), (2, 16, 2, 64, 16, 4),
                               (2, 96, 2, 64, 48, 8), (1, 256, 3, 128, 64, 16)):
        assert K.plan(B, T, w, cs, T // cs, nh, d, 4) is not None
        assert K.fwd_uses_tf32x3(d, w, 4)


def test_tf32_smem_layout():
    """The q rows and a ring of two 16-row key/value stages, f32: the same
    bytes whatever C, three blocks an SM within Hopper's shared memory at
    head dim 128, and less than the CUDA-core forward takes at the LM
    shape."""
    assert K.tf32_smem_bytes(128) == (64 * 144 + 2 * 16 * (144 + 132)) * 4
    assert K.tf32_smem_bytes(64) == (64 * 80 + 2 * 16 * (80 + 68)) * 4
    for d in K.HEAD_DIMS:
        assert 3 * K.tf32_smem_bytes(d) <= K.SMEM_LIMIT
        assert all(K.tf32_smem_bytes(d) < K.smem_bytes(False, d, 128, C, 64)
                   for C in (8, 64, 512))


def _tf32_visited(T, w, cs, qt):
    """[G, w, w + C] bool: the columns the split-TF32 forward computes for
    each window row, by ``tf32_tiles`` (a block's walk, then each 16-row
    strip's own tiles)."""
    C, G, n = T // cs, T // w, K.TF32_KEYS
    seen = torch.zeros(G, w, w + C, dtype=torch.bool)
    for g in range(G):
        for r0 in range(0, w, qt):
            b_loc, b_ch = K.tf32_tiles(g, r0 + qt - 1, w, cs, C)
            for rs in range(r0, r0 + qt, 16):
                s_loc, s_ch = K.tf32_tiles(g, rs + 15, w, cs, C)
                assert s_loc <= b_loc and s_ch <= b_ch
                seen[g, rs:rs + 16, :min(w, n * s_loc)] = True
                seen[g, rs:rs + 16, w:w + min(C, n * s_ch)] = True
    return seen


@pytest.mark.parametrize("T,w,cs", [(64, 16, 4), (96, 48, 8), (256, 64, 16),
                                    (512, 128, 8)])
def test_tf32_tile_walk_drops_only_masked_columns(T, w, cs):
    """Every column the route skips is masked for every row of its strip,
    and the plain forward with the skipped columns taken out entirely (at
    -inf) equals the full plain forward bit for bit in f32."""
    nh, d = 1, 16
    rng = np.random.default_rng(5)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    C = T // cs
    qt = K.plan(1, T, w, cs, C, nh, 64, 4)[0]
    seen = _tf32_visited(T, w, cs, qt)
    tab = K.causal_table(w, 0.3 * f(w, w))
    add = K._joint_add(tab, T // w, w, cs, C)
    assert bool((add[~seen] <= K.MASK_VAL / 2).all())
    # local key 0, which every row sees, is in every strip's first tile
    assert bool(seen[:, :, 0].all())
    ops = [f(1, T, nh * d), f(1, T, nh * d), f(1, T, nh * d), f(1, C, nh * d),
           f(1, C, nh * d)]
    full = K.causal_packed_fwd_ref(*ops, tab, d ** -0.5, nh, w, cs)
    dropped = add.masked_fill(~seen, float("-inf"))
    with mock.patch.object(K, "_joint_add", lambda *a: dropped):
        walked = K.causal_packed_fwd_ref(*ops, tab, d ** -0.5, nh, w, cs)
    torch.testing.assert_close(walked, full, rtol=0, atol=0)


def _tf32(x):
    """x rounded to TF32: nearest, ties away from zero, 10 mantissa bits (the
    kernel's ``split_tf32`` hi, ``cvt.rna.tf32.f32``'s bits)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32x3(a, b):
    """a @ b as the kernel's split-TF32 products take it: hi = tf32(x),
    lo = x - hi read by the mma at TF32 width (its low 13 bits dropped),
    hi hi + hi lo + lo hi with f32 sums."""
    def split(x):
        hi = _tf32(x)
        lo = ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
        return hi, lo
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _fwd_products(q, k, v, rf, beta, tab, scale, nh, w, cs, mm):
    """The plain forward with both products taken by ``mm``."""
    qw, kw, vw = (K._windows(t, w, nh) for t in (q, k, v))
    rfh, bth = K._heads(rf, nh), K._heads(beta, nh)
    G, C = qw.shape[2], rfh.shape[2]
    keys = torch.cat([kw, rfh[:, :, None].expand(-1, -1, G, -1, -1)], dim=3)
    vals = torch.cat([vw, bth[:, :, None].expand(-1, -1, G, -1, -1)], dim=3)
    logits = mm(qw, keys.transpose(-1, -2)) * scale + K._joint_add(tab, G, w, cs, C)
    p = torch.softmax(logits, dim=-1)
    return K._merge(mm(p, vals)), logits


def test_split_tf32_products_hold_the_f32_limit_and_one_tf32_product_does_not():
    """The route's precision argument on the CPU: with keys scaled so that
    logits reach about 10, the forward with both products in split TF32 is
    within the card's f32 limit (1e-5 relative to the output's largest
    value) of the plain forward, and with one TF32 product each it is not."""
    B, T, nh, d, w, cs = 2, 64, 2, 64, 16, 4
    rng = np.random.default_rng(6)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    C = T // cs
    q, v, beta = f(B, T, nh * d), f(B, T, nh * d), f(B, C, nh * d)
    k, rf = 4 * f(B, T, nh * d), 4 * f(B, C, nh * d)
    tab = K.causal_table(w, 0.3 * f(w, w))
    scale = d ** -0.5
    ref = K.causal_packed_fwd_ref(q, k, v, rf, beta, tab, scale, nh, w, cs)
    tol = 1e-5 * max(1.0, ref.abs().max().item())
    split, logits = _fwd_products(q, k, v, rf, beta, tab, scale, nh, w, cs,
                                  _mm_tf32x3)
    assert 8.0 < logits[logits > K.MASK_VAL / 2].abs().max().item() < 40.0
    assert (split - ref).abs().max().item() <= tol / 3
    one, _ = _fwd_products(q, k, v, rf, beta, tab, scale, nh, w, cs,
                           lambda a, b: _tf32(a) @ _tf32(b))
    assert (one - ref).abs().max().item() > 10 * tol


# ---- the backward's split-TF32 route: its gate, layout, tile walk and
# arithmetic (the kernel itself runs on the card only)


def test_bwd_uses_tf32x3_gate():
    """The forward's gate, for windows of at most 128 rows (a block takes a
    window, a warp each 16-row strip): bfloat16, other head dims, windows
    of 8 and windows wider than 128 keep the CUDA-core kernel."""
    for d, w in ((64, 16), (128, 128), (128, 48), (64, 96), (64, 128)):
        assert K.bwd_uses_tf32x3(d, w, 4)
    assert not K.bwd_uses_tf32x3(128, 128, 2)   # bf16
    assert not K.bwd_uses_tf32x3(48, 128, 4)    # head dim
    assert not K.bwd_uses_tf32x3(64, 8, 4)      # window of 8
    assert not K.bwd_uses_tf32x3(64, 144, 4)    # wider than a block
    assert K.fwd_uses_tf32x3(64, 144, 4)
    # the LM shape and every f32 geometry the card checks take it
    for B, T, nh, d, w, cs in ((18, 512, 8, 128, 128, 8), (2, 16, 2, 64, 16, 4),
                               (2, 32, 2, 64, 16, 4), (2, 96, 2, 64, 48, 8),
                               (1, 256, 3, 128, 64, 16)):
        assert K.plan(B, T, w, cs, T // cs, nh, d, 4) is not None
        assert K.bwd_uses_tf32x3(d, w, 4)


def test_tf32_bwd_smem_layout():
    """The window's q and g rows, two 16-row key/value stages and the P and
    dS tiles, f32: one block an SM within Hopper's shared memory at head
    dim 128 and every window the route takes, and less than the CUDA-core
    backward takes at the LM shape."""
    assert K.tf32_bwd_smem_bytes(128, 128) == (2 * 128 * 128 + 2 * 16 * 256
                                               + 2 * 16 * 136) * 4 == 181248
    assert K.tf32_bwd_smem_bytes(64, 128) == 99328
    for d in K.HEAD_DIMS:
        for w in range(16, K.TF32_BWD_MAX_W + 1, 16):
            assert K.tf32_bwd_smem_bytes(d, w) <= K.SMEM_LIMIT
    assert K.tf32_bwd_smem_bytes(128, 128) < K.smem_bytes(True, 128, 128, 64, 32)


def _tf32_bwd_visited(T, w, cs):
    """Two [G, w, w + C] bools: the columns the split-TF32 backward computes
    for each window row in its strip's products (P, dS, dq) and in the
    tiles' dk/dv (drf/dbeta) products, by ``tf32_bwd_walk`` and
    ``tf32_tiles``; each tile of the walk is walked once."""
    C, G, n = T // cs, T // w, K.TF32_KEYS
    rows = torch.zeros(G, w, w + C, dtype=torch.bool)
    cols = torch.zeros_like(rows)
    for g in range(G):
        walk = K.tf32_bwd_walk(g, w, cs, C)
        assert len(set((local, u) for local, u, _ in walk)) == len(walk)
        for rs in range(0, w, 16):
            s_loc, s_ch = K.tf32_tiles(g, rs + 15, w, cs, C)
            assert [(True, u) for u in range(s_loc)] + [(False, u) for u in range(s_ch)] == [
                (local, u) for local, u, first in walk if first <= rs]
            rows[g, rs:rs + 16, :min(w, n * s_loc)] = True
            rows[g, rs:rs + 16, w:w + min(C, n * s_ch)] = True
        for local, u, first in walk:
            at = n * u + (0 if local else w)
            cols[g, first:, at:min(at + n, w if local else w + C)] = True
    return rows, cols


@pytest.mark.parametrize("T,w,cs", [(64, 16, 4), (96, 48, 8), (256, 64, 16),
                                    (512, 128, 8)])
def test_tf32_bwd_tile_walk_drops_only_masked_columns(T, w, cs):
    """Every column a row can see is computed once for its dq and once for
    the dk/dv of the column's key; every column the route skips is masked
    for every row of its strip, and the plain backward with the skipped
    columns taken out entirely (at -inf) equals the full plain backward
    bit for bit in f32."""
    nh, d = 1, 16
    rng = np.random.default_rng(7)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    C = T // cs
    rows, cols = _tf32_bwd_visited(T, w, cs)
    assert bool((rows == cols).all())
    tab = K.causal_table(w, 0.3 * f(w, w))
    add = K._joint_add(tab, T // w, w, cs, C)
    assert bool((add[~rows] <= K.MASK_VAL / 2).all())
    assert bool(rows[:, :, 0].all())
    ops = [f(1, T, nh * d), f(1, T, nh * d), f(1, T, nh * d), f(1, C, nh * d),
           f(1, C, nh * d), tab, f(1, T, nh * d)]
    full = K.causal_packed_bwd_ref(*ops, d ** -0.5, nh, w, cs)
    dropped = add.masked_fill(~rows, float("-inf"))
    with mock.patch.object(K, "_joint_add", lambda *a: dropped):
        walked = K.causal_packed_bwd_ref(*ops, d ** -0.5, nh, w, cs)
    for name, a, b in zip(NAMES, walked, full):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def _bwd_products(q, k, v, rf, beta, tab, g, scale, nh, w, cs, mm):
    """The route's backward with its five products, and pass 1's S and
    dP, taken by ``mm``: the row max m, l = sum exp(s - m) and
    D = sum exp(s - m) dP first, then P = exp(s - m) / l,
    dS = P (dP - D / l) and dq, dk, dv, drf, dbeta, dbias."""
    qw, kw, vw, gw = (K._windows(t, w, nh) for t in (q, k, v, g))
    rfh, bth = K._heads(rf, nh), K._heads(beta, nh)
    G, C = qw.shape[2], rfh.shape[2]
    keys = torch.cat([kw, rfh[:, :, None].expand(-1, -1, G, -1, -1)], dim=3)
    vals = torch.cat([vw, bth[:, :, None].expand(-1, -1, G, -1, -1)], dim=3)
    s = mm(qw, keys.transpose(-1, -2)) * scale + K._joint_add(tab, G, w, cs, C)
    dP = mm(gw, vals.transpose(-1, -2))
    x = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = x.sum(dim=-1, keepdim=True)  # noqa: E741
    P = x / l
    dS = P * (dP - (x * dP).sum(dim=-1, keepdim=True) / l)
    dq = scale * mm(dS, keys)
    dkc = scale * mm(dS.transpose(-1, -2), qw)
    dvc = mm(P.transpose(-1, -2), gw)

    def packed(t):  # [B, nh, C, d] summed over windows -> [B, C, nh*d]
        return t.sum(dim=2).transpose(1, 2).reshape(t.shape[0], C, -1)

    return (K._merge(dq), K._merge(dkc[..., :w, :]), K._merge(dvc[..., :w, :]),
            packed(dkc[..., w:, :]), packed(dvc[..., w:, :]),
            dS[..., :w].sum(dim=(0, 1, 2)), s)


def test_split_tf32_backward_holds_the_f32_limit_and_one_tf32_product_does_not():
    """The backward route's precision argument on the CPU: with keys scaled
    so that logits reach about 10, the backward with pass 1's statistics
    and all five products in split TF32 holds each of the six gradients
    within the card's f32 limit (1e-5 relative to its largest value) of the
    plain backward, and with one TF32 product each every one misses it."""
    B, T, nh, d, w, cs = 2, 64, 2, 64, 16, 4
    rng = np.random.default_rng(8)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    C = T // cs
    q, v, beta, g = f(B, T, nh * d), f(B, T, nh * d), f(B, C, nh * d), f(B, T, nh * d)
    k, rf = 4 * f(B, T, nh * d), 4 * f(B, C, nh * d)
    tab = K.causal_table(w, 0.3 * f(w, w))
    scale = d ** -0.5
    ref = K.causal_packed_bwd_ref(q, k, v, rf, beta, tab, g, scale, nh, w, cs)
    tols = [1e-5 * max(1.0, r.abs().max().item()) for r in ref]
    *split, s = _bwd_products(q, k, v, rf, beta, tab, g, scale, nh, w, cs,
                              _mm_tf32x3)
    assert 8.0 < s[s > K.MASK_VAL / 2].abs().max().item() < 40.0
    for name, a, b, tol in zip(NAMES, split, ref, tols):
        assert (a - b).abs().max().item() <= tol / 3, name
    *one, _ = _bwd_products(q, k, v, rf, beta, tab, g, scale, nh, w, cs,
                            lambda a, b: _tf32(a) @ _tf32(b))
    for name, a, b, tol in zip(NAMES, one, ref, tols):
        assert (a - b).abs().max().item() > 10 * tol, name

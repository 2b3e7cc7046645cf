"""K9 ``eva_packed_out`` and K10 ``eva_mega`` of the PyTorch port against the
JAX package.

The port's plain versions (what the CUDA kernels are held against on the
card) must compute what the TPU kernels compute: each is compared with its
Pallas kernel in interpret mode on the same numpy inputs, in float32, at the
JAX package's own geometry of these kernels (``test_pallas.py:691, 716``:
B=2, an 8x8 grid, 3 heads of 16) and tolerance: 2e-5 abs / 1e-4 rel for K9
(``test_pallas.py:707``), 3e-5 / 1e-4 for K10 (``:747, 778``).  In bfloat16
the plain versions of K9 and K10's attention are also held to the Pallas
kernels within one bf16 rounding of the output, which pins the five places
where they round (qkv, the numerators, out / denom, the projection), the
ones the tensor-core kernel is held to on the card.  The CUDA kernels run
only on a card (``test_torch_cuda.py``); here the wrappers' copies of their
gates and shared-memory layouts are checked.
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


def _bf16(x):
    return None if x is None else torch.from_numpy(x).to(torch.bfloat16)


def _jbf16(x):
    return None if x is None else jnp.asarray(x).astype(jnp.bfloat16)


def _one_rounding(got, want):
    """got within one bf16 rounding of want: 2^-7 of the largest |value|,
    at least 2^-7."""
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want).abs().max().item()
    assert err <= 2 ** -7 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("with_bias", [False, True])
def test_packed_out_matches_jax_in_bf16(with_bias):
    """``eva_packed_out_ref`` against ``_kernel_fused_out`` in bf16 (the
    summaries and Wo in bf16, bo in f32), 4 landmarks as test_pallas.py:691."""
    qkv = _rng(4)(B, G * G, 3 * DIM)
    rf, beta, wo, bo, bias = _attention_operands(5, 4, with_bias)
    got = K9.eva_packed_out_ref(_bf16(qkv), _bf16(rf), _bf16(beta), _bf16(wo), _t(bo),
                                D ** -0.5, NH, G, WS, bias=_t(bias))
    want = jax_k9.eva_attention_packed_out(_jbf16(qkv), _jbf16(rf), _jbf16(beta),
                                           _jbf16(wo), _j(bo), D ** -0.5, NH, G, WS,
                                           bias=_j(bias), interpret=True)
    _one_rounding(got, want)


@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_from_x_matches_jax_in_bf16(with_bias):
    """``eva_attention_from_x_ref`` against ``_attn_kernel`` in bf16 (x, Wqkv,
    the summaries and Wo in bf16, the biases in f32), 16 landmarks."""
    x, wqkv, bqkv = _tokens()
    rf, beta, wo, bo, bias = _attention_operands(3, 16, with_bias)
    got = K10.eva_attention_from_x_ref(_bf16(x), _bf16(wqkv), _t(bqkv), _bf16(rf),
                                       _bf16(beta), _bf16(wo), _t(bo), D ** -0.5, NH,
                                       G, WS, bias=_t(bias))
    want = jax_k10.eva_attention_from_x(_jbf16(x), _jbf16(wqkv), _j(bqkv), _jbf16(rf),
                                        _jbf16(beta), _jbf16(wo), _j(bo), D ** -0.5,
                                        NH, G, WS, bias=_j(bias), interpret=True)
    _one_rounding(got, want)


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
    """K9's block (windows of one image, every head) and K10's (with the
    window's x rows) fit Hopper's 227 KB in f32.  In bf16 the tensor-core
    route stages every head's chunk rows and bias once a block, writes the
    attention rows over the q columns and holds Wo whole (K10 under its
    Wqkv ring).  One block of 12 warps an SM (a block and its 1 KB reserve
    fit once in 228 KB, not twice)."""
    for itemsize in (2, 4):
        assert K9.plan_out(128, 784, 28, 7, 49, 3, 64, itemsize) is not None
        assert K9.plan_out(128, 784, 28, 7, 49, 3, 64, itemsize, xdim=192) <= \
            K9.SMEM_LIMIT
    assert K9.smem_bytes_out(64, 49, 49, 3, 4, 192) == 174976
    assert K9.out_mma_plan(64, 49, 49, 3) == (3, True, False, 96, 208000)
    assert K9.out_mma_plan(64, 49, 49, 3, 192) == (3, True, False, 96, 230016)
    for xdim in (0, 192):
        assert K9.out_uses_mma(64, 2, xdim)
        smem = K9.smem_bytes_out(64, 49, 49, 3, 2, xdim)
        assert smem + 1024 <= 233472 < 2 * (smem + 1024)


# the geometries the tensor-core route took before its redesign, each in
# bf16 (B, grid side, window, chunks, heads, head dim): the DeiT-tiny-p8
# cell, DeiT-tiny-p16, the small and base EVA ViTs (6 and 12 heads of 64,
# whose window rows are staged a few heads at a time), PVTv2-B3's three EVA
# stages, strips of two passes (196 chunks) and an odd one (8x8, window 4)
_MMA_GEOMETRIES = {
    "headline": (128, 28, 7, 49, 3, 64), "p16": (128, 14, 7, 49, 3, 64),
    "evit_small p8": (128, 28, 7, 49, 6, 64), "evit_small p16": (128, 14, 7, 49, 6, 64),
    "evit_base p8": (64, 28, 7, 49, 12, 64), "evit_base p16": (128, 14, 7, 49, 12, 64),
    "pvt stage 1": (128, 56, 7, 49, 2, 32), "pvt stage 2": (128, 28, 7, 49, 4, 32),
    "pvt stage 3": (128, 14, 7, 49, 10, 32), "two-pass": (8, 28, 7, 196, 2, 16),
    "odd": (3, 8, 4, 4, 3, 16),
}


@pytest.mark.parametrize("name", sorted(_MMA_GEOMETRIES))
@pytest.mark.parametrize("with_x", [False, True])
def test_mma_route_takes_the_geometries(name, with_x):
    """``out_uses_mma`` and ``plan_out`` accept each geometry on the
    tensor-core route, for K9 and for K10's attention (x as wide as the
    heads), with a layout no wider than a block's shared memory."""
    B, g, ws, C, nh, d = _MMA_GEOMETRIES[name]
    xdim = nh * d if with_x else 0
    assert K9.out_uses_mma(d, 2, xdim)
    smem = K9.plan_out(B, g * g, g, ws, C, nh, d, 2, xdim=xdim)
    assert smem is not None and smem == K9.out_mma_plan(d, ws * ws, C, nh, xdim)[-1]
    hg = K9.out_mma_plan(d, ws * ws, C, nh, xdim)[0]
    assert 1 <= hg <= nh


def _wmma_layout_bytes(d, S, C, nh, xdim):
    """A block of the tensor-core route before its redesign (one head at a
    time through a logit matrix): q, keys then numerators, values, the f32
    logits (which also held K10's x rows and the warps' scratch), the row
    sums and the output rows, each padded to 16 rows and 128 bytes."""
    a, SP, KP, DB = K9._align128, -(-S // 16) * 16, -(-(S + C) // 16) * 16, d + 8
    xbytes = a(SP * (xdim + 8) * 2) if xdim else 0
    return (a(SP * DB * 2) + a(max(KP * DB, SP * (KP + 8)) * 2) + a(KP * DB * 2)
            + a(max(SP * (KP + 4) * 4, xbytes + 8 * 256 * 4)) + a(SP * 4)
            + a(SP * (nh * d + 8) * 2))


@pytest.mark.parametrize("d", [16, 32, 64])
def test_mma_plan_takes_every_geometry_the_old_layout_did(d):
    """Every bf16 geometry that the route's old layout fitted in a block,
    with windows up to 7x7 and up to 1024 channels, K9 and K10's attention
    (x as wide as the heads), fits the new plan's layout: wider models stage
    the window's rows, chunk rows and bias a few heads at a time with their
    attention rows in a buffer of their own, and take the small ring where
    the large one does not fit."""
    taken = 0
    for ws in range(1, 8):
        for C in (1, 4, 9, 16, 25, 49, 64, 100, 196, 400, 784):
            for nh in range(1, 1024 // d + 1):
                for xdim in (0, nh * d):
                    if _wmma_layout_bytes(d, ws * ws, C, nh, xdim) > K9.SMEM_LIMIT:
                        continue
                    taken += 1
                    assert K9.out_mma_plan(d, ws * ws, C, nh, xdim)[-1] <= K9.SMEM_LIMIT, \
                        (d, ws, C, nh, xdim)
    assert taken > 1000


@pytest.mark.parametrize("xdim, split, slab", [(0, True, 96), (768, True, 16)])
def test_mma_plan_stages_the_base_model_a_head_at_a_time(xdim, split, slab):
    """12 heads of 64 (the base EVA ViT): every head's window rows do not fit
    with anything else, so both kernels stage one head's rows, chunk rows
    and bias at a time with the attention rows in their own buffer and Wo
    streamed; K10's x rows leave room only for the small ring."""
    hg, wo_whole, got_split, got_slab, smem = K9.out_mma_plan(64, 49, 49, 12, xdim)
    assert (hg, wo_whole, got_split, got_slab) == (1, False, split, slab)
    assert smem == K9.out_mma_layout(64, 49, 49, 12, xdim, 1, False, split, slab)
    assert K9.out_mma_layout(64, 49, 49, 12, 0, 12, False, False, 96) > K9.SMEM_LIMIT

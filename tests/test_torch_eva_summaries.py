"""K8 ``eva_summaries`` of the PyTorch port against the JAX package.

The port's plain version (``eva_summaries_packed_ref``, what the CUDA kernel
is held against on the card) must compute what the TPU kernel computes: it is
compared with ``eva_summaries_packed(..., interpret=True)`` on the same numpy
inputs, in float32, to 2e-5 abs / 1e-4 rel (the tolerance of the JAX
package's own test of that kernel, ``test_pallas.py:643``), and with the
port's ``EVA._chunk_summaries_packed`` at eval, which is the same function.
The CUDA kernel itself runs only on a card (``test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32
from efficient_attention_tpu.ops.pallas import eva_summaries as jax_k8
from efficient_attention_torch import AttentionFactory
from efficient_attention_torch.ops.kernels import eva_summaries as K8

ATOL, RTOL = 2e-5, 1e-4


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def _inputs(seed, B, gh, gw, nh, d, use_ln):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    qkv = f(B, gh * gw, 3 * nh * d)
    dense = [0.2 * f(d, d), 0.1 * f(d), 0.2 * f(d, d), 0.1 * f(d)]
    ln = ([1 + 0.1 * f(d), 0.1 * f(d), 1 + 0.1 * f(d), 0.1 * f(d)]
          if use_ln else [None] * 4)
    return qkv, dense + ln


def _torch(x):
    return None if x is None else torch.from_numpy(x)


def _jax(x):
    return None if x is None else jnp.asarray(x)


def _both(qkv, weights, nh, gw, j, use_ln):
    out = K8.eva_summaries_packed_ref(_torch(qkv), *map(_torch, weights), nh,
                                      gw, j, use_ln)
    ref = jax_k8.eva_summaries_packed(_jax(qkv), *map(_jax, weights), nh=nh,
                                      gw=gw, j=j, use_ln=use_ln, interpret=True)
    return [t.numpy() for t in out], [np.asarray(t) for t in ref]


@pytest.mark.parametrize("adaptive_proj", ["default", "no-ln"])
def test_plain_matches_jax_kernel(adaptive_proj):
    """B=2, an 8x8 grid of 2x2 chunks (16 landmarks), 3 heads of 16."""
    use_ln = adaptive_proj == "default"
    qkv, weights = _inputs(1, 2, 8, 8, 3, 16, use_ln)
    assert K8.supports_summaries(2, 8, 8, 2, adaptive_proj, qkv.shape[-1], 3,
                                 itemsize=4)
    out, ref = _both(qkv, weights, 3, 8, 2, use_ln)
    for a, b in zip(out, ref):
        assert a.shape == b.shape == (2, 16, 48)
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)


def test_rectangular_grid():
    """A 4x8 grid of 2x2 chunks (8 landmarks), as test_pallas.py:648."""
    qkv, weights = _inputs(2, 2, 4, 8, 3, 16, True)
    out, ref = _both(qkv, weights, 3, 8, 2, True)
    for a, b in zip(out, ref):
        assert a.shape == b.shape == (2, 8, 48)
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("adaptive_proj", ["default", "no-ln"])
def test_plain_is_the_modules_eval_summaries(adaptive_proj):
    """The plain version is ``EVA._chunk_summaries_packed`` at eval (the
    route K8 replaces), on the module's own adaptive weights."""
    m = AttentionFactory.build_attention("eva", {
        "dim": 48, "num_heads": 3, "window_size": 4, "num_landmarks": 4,
        "attn_2d": True, "use_rpe": True, "adaptive_proj": adaptive_proj})
    torch.manual_seed(3)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(0.3 * torch.randn_like(p) + (p == 1).float())
    qkv = torch.from_numpy(_inputs(4, 2, 8, 8, 3, 16, False)[0])
    with torch.no_grad():
        want = m.eval()._chunk_summaries_packed(qkv, (8, 8), 4)
        got = K8.eva_summaries_packed_ref(qkv, *m._adaptive_weights(), 3, 8, 4,
                                          adaptive_proj == "default")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=RTOL)


def test_cpu_tensor_takes_plain_version():
    qkv, weights = _inputs(5, 2, 8, 8, 3, 16, True)
    before = K8.LAUNCHES
    out = K8.eva_summaries_packed(_torch(qkv), *map(_torch, weights), 3, 8, 2,
                                  True)
    assert K8.LAUNCHES == before
    want = K8.eva_summaries_packed_ref(_torch(qkv), *map(_torch, weights), 3, 8,
                                       2, True)
    for a, b in zip(out, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case,ok", [
    (dict(), True),
    (dict(itemsize=4), True),
    (dict(adaptive_proj="none"), False),   # no adaptive_mu_q to take
    (dict(j=3), False),                    # chunk 3 does not divide 28
    (dict(three_hd=3 * 3 * 24), False),    # head dim 24: not built
    (dict(gh=56, gw=56, j=8, itemsize=4), False),  # strip exceeds 227 KB
])
def test_gate(case, ok):
    geo = dict(B=128, gh=28, gw=28, j=4, adaptive_proj="default",
               three_hd=3 * 192, num_heads=3, itemsize=2)
    geo.update(case)
    assert K8.supports_summaries(**geo) is ok


def test_smem_at_the_cell():
    """DeiT-tiny-p8: a strip of 4 grid rows (112 tokens) of one head, 43 KB
    of bf16 rows; f32 and the x-reading form (K10) stay within 227 KB."""
    assert K8.smem_bytes(112, 64, 2) == 43008 + 4096
    assert K8.plan(128, 3, 28, 28, 4, 64, 4, xdim=192) <= K8.SMEM_LIMIT


# ---- the persistent tensor-core route (bf16): its plan, layout and walk.
# The kernel runs only on a card (test_torch_cuda.py, chip_smoke.py); here
# the wrapper's copies of what the launcher computes.

@pytest.mark.parametrize("name,geo,xdim,want", [
    # (B, heads, grid rows, grid width, chunk side, head dim, itemsize)
    ("headline K8", (128, 3, 28, 28, 4, 64, 2), 0, (8, 2, 2, 1)),
    ("headline K10a", (128, 3, 28, 28, 4, 64, 2), 192, (16, 1, 1, 2)),
    ("pvt stage 1 K8", (16, 2, 56, 56, 8, 32, 2), 0, (8, 2, 1, 1)),
    ("pvt stage 1 K10a", (16, 2, 56, 56, 8, 32, 2), 64, (16, 1, 1, 1)),
    ("pvt stage 2 K8", (16, 4, 28, 28, 4, 32, 2), 0, (8, 2, 2, 1)),
    ("pvt stage 2 K10a", (16, 4, 28, 28, 4, 32, 2), 128, (8, 1, 2, 1)),
    ("pvt stage 3 K8", (16, 10, 14, 14, 2, 32, 2), 0, None),  # strips of 28 rows
    ("pvt stage 3 K10a", (16, 10, 14, 14, 2, 32, 2), 320, (8, 1, 2, 1)),
    ("p16 K8", (16, 3, 14, 14, 2, 64, 2), 0, None),
    ("p16 K10a", (16, 3, 14, 14, 2, 64, 2), 192, (8, 1, 2, 1)),
    ("d16 K10a", (16, 12, 28, 28, 4, 16, 2), 192, (8, 1, 2, 1)),
    ("evit_base p16 K10a", (2, 12, 14, 14, 2, 64, 2), 768, None),  # the slice: 307 KB
    ("f32", (128, 3, 28, 28, 4, 64, 4), 0, None),
    ("head dim 12", (2, 4, 14, 14, 2, 12, 2), 0, None),
    ("81 members", (2, 3, 18, 18, 9, 64, 2), 0, None),
    ("x width 200", (2, 4, 28, 28, 4, 50, 2), 200, None),
])
def test_mma_plan_choices(name, geo, xdim, want):
    """The route and layout each geometry takes: the first layout of
    MMA_CONFIGS whose blocks fit an SM; None (the first kernel) off the
    route's gate, for K8 at strips shorter than MMA_MIN_ROWS_K8 rows, or
    where K10a's Wqkv slice does not fit."""
    got = K8.mma_plan(*geo, xdim=xdim)
    assert (None if got is None else tuple(got[:4])) == want
    if got is not None:
        assert got.smem <= K8.SMEM_LIMIT
        assert got.bps * (got.smem + 1024) <= K8.SM_SMEM


def test_mma_smem_bytes_region_by_region():
    """The layout's bytes at the headline, summed region by region (each
    128-byte aligned), for K8 and K10a."""
    lt = 3 * 64 + 8
    rows_qkv = 112 * lt * 2                 # 44,800: a strip's q | k | v rows
    small = 6 * 64 * 4 + 7 * 2 * 64 * 4 + 7 * 256 * 4 + 2 * 512
    # (vectors, means, the Dense's partial sums, weights and offsets)
    assert K8.mma_smem_bytes(112, 64, 0, 7, 16, 2) == 2 * rows_qkv + small
    assert K8.mma_smem_bytes(112, 64, 0, 7, 16, 3) == 3 * rows_qkv + small
    w_slice, x_rows = 192 * lt * 2, 112 * 200 * 2
    assert (K8.mma_smem_bytes(112, 64, 192, 7, 16, 2)
            == w_slice + 2 * x_rows + rows_qkv + small + 3 * 64 * 4)
    # the two-team kernel: one buffer of x rows, two of projected rows
    assert (K8.mma_smem_bytes(112, 64, 192, 7, 16, 1, 2)
            == w_slice + x_rows + 2 * rows_qkv + small + 3 * 64 * 4 == 225280)
    # head dim 16, 28 rows of x 48 wide: regions rounded up to 128 bytes
    assert K8.mma_smem_bytes(28, 16, 48, 7, 4, 1) == (
        5376 + 3200 + 3200 + 640 + 896 + 7168 + 128 + 128)


@pytest.mark.parametrize("B", [1, 7, 128])
@pytest.mark.parametrize("nh,strips", [(3, 7), (10, 7), (2, 7), (2, 2)])
def test_mma_walk_covers_every_item_once(B, nh, strips):
    """The persistent blocks take every (strip, head, image) exactly once,
    each block one head for its life, and the heads of one (strip, image)
    at the same position of their blocks' walks (so they run side by side):
    the headline, PVT-B3's three stages, LARGE_KEYS' 8x8 grid."""
    for bps in (1, 2):
        blocks = K8.mma_blocks(B, nh, strips, bps)
        assert blocks % nh == 0 and blocks <= max(nh, 132 * bps)
        walk = list(K8.mma_walk(B, nh, strips, blocks))
        items = sorted((s, h, b) for _, s, h, b in walk)
        assert items == sorted((s, h, b) for s in range(strips) for h in range(nh)
                               for b in range(B))
        position, heads = {}, {}
        for blk, s, h, b in walk:
            heads.setdefault(blk, set()).add(h)
            position.setdefault(blk, []).append((s, b))
        assert all(len(hs) == 1 for hs in heads.values())
        for blk in range(0, blocks, nh):
            assert all(position[blk + h] == position[blk] for h in range(nh))


def test_route_config_forces_and_refuses_layouts():
    """``config`` forces the first kernel (0) or a layout that fits; a layout
    that does not fit, or a ring too shallow for K8, raises."""
    geo = (128, 3, 28, 28, 4, 64, 2)
    assert K8.route_config(*geo, 0, None, "k8") == (8, 2, 2, 1)
    assert K8.route_config(*geo, 0, 0, "k8") == (0, 0, 0, 0)
    assert K8.route_config(*geo, 0, (16, 3, 1, 1), "k8") == (16, 3, 1, 1)
    for bad in ((8, 1, 1, 1), (16, 3, 2, 1), (12, 2, 1, 1), (16, 1, 1, 2)):
        with pytest.raises(ValueError, match="does not fit"):
            K8.route_config(*geo, 0, bad, "k8")
    assert K8.route_config(*geo, 192, (16, 1, 1, 1), "k10") == (16, 1, 1, 1)
    assert K8.route_config(*geo, 192, (16, 1, 1, 2), "k10") == (16, 1, 1, 2)
    with pytest.raises(ValueError, match="does not fit"):  # two teams: 16 warps, 1 stage
        K8.route_config(*geo, 192, (8, 1, 1, 2), "k10")

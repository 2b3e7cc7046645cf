"""Performer/kernelized attention of the PyTorch port against the JAX package.

* K6 ``performer_fused``: the plain version must give the interpret-mode
  Pallas kernel and its twin ``performer_fused_twin`` to 3e-5 abs / 1e-4
  rel in float32, and the gradients of qkv and the projection must give
  ``jax.grad`` of the twin to 1e-4 abs / 1e-3 rel.
* ``KernelizedAttention`` for every ``proj_method``, with and without
  cos-weighting, the JAX eval matrix carried into the port's ``random_proj``
  buffer: outputs to 3e-5 abs / 1e-4 rel (Fourier features, whose sin/cos
  of large arguments lose digits, to 3e-5 relative to the largest output).
* The reference golden ``kernelized_favorp.npz`` loads with ``strict=True``
  and matches to 3e-5 abs / 1e-4 rel (``test_goldens.py:155``).
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32, randomize, to_jax, torch_apply
from efficient_attention_tpu import AttentionFactory as JaxFactory
from efficient_attention_tpu.ops.pallas.performer_fused import (
    performer_attention_fused as jax_fused,
    performer_fused_twin,
)
from efficient_attention_tpu.ops.random_features import (
    create_proj_matrix as jax_proj_matrix,
)
from efficient_attention_torch import AttentionFactory
from efficient_attention_torch.interop import load_jax_params
from efficient_attention_torch.ops import random_features as RF
from efficient_attention_torch.ops.kernels import performer_fused as K

ATOL, RTOL = 3e-5, 1e-4
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def _jit_apply(module, params, x, mask=None):
    f = jax.jit(lambda p, xx, mk: module.apply(p, xx, key_padding_mask=mk,
                                               deterministic=True))
    return np.asarray(f(to_jax(params), jnp.asarray(x),
                        None if mask is None else jnp.asarray(mask)))


def _kernel_inputs(B, H, d, N, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N, 3 * H * d)).astype(np.float32),
            rng.standard_normal((H, m, d)).astype(np.float32))


def _twin(H, m, d):
    def f(qkv, proj):
        w_p = proj.transpose(1, 0, 2).reshape(m, H * d)
        return performer_fused_twin(qkv, w_p, nh=H)
    return f


@pytest.mark.parametrize("geometry", [(2, 2, 16, 64, 16), (1, 3, 64, 56, 24)])
def test_plain_matches_jax_kernel_and_twin(geometry):
    B, H, d, N, m = geometry
    qkv, proj = _kernel_inputs(B, H, d, N, m, seed=0)
    jargs = (jnp.asarray(qkv), jnp.asarray(proj))
    pallas = np.asarray(jax_fused(*jargs, H, interpret=True))
    twin = np.asarray(jax.jit(_twin(H, m, d))(*jargs))
    out = K.performer_fused_ref(torch.from_numpy(qkv), torch.from_numpy(proj),
                                H).numpy()
    np.testing.assert_allclose(out, twin, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=RTOL)


def test_grads_match_jax_twin():
    B, H, d, N, m = 2, 2, 16, 64, 16
    qkv, proj = _kernel_inputs(B, H, d, N, m, seed=1)
    g = np.random.default_rng(2).standard_normal((B, N, H * d)).astype(np.float32)
    want = jax.jit(jax.grad(
        lambda q, p: jnp.sum(_twin(H, m, d)(q, p) * jnp.asarray(g)),
        argnums=(0, 1)))(jnp.asarray(qkv), jnp.asarray(proj))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (qkv, proj)]
    before = K.LAUNCHES
    out = K.performer_attention_fused(*leaves, H)
    (out * torch.from_numpy(g)).sum().backward()
    assert K.LAUNCHES == before  # the CPU takes the plain version
    for name, leaf, w in zip(("qkv", "projection"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


# ---- KernelizedAttention ----

@functools.lru_cache(maxsize=None)
def _jax_kernelized(args_items, shape):
    args = dict(args_items)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jm = JaxFactory.build_attention("performer", dict(args, impl="xla"))
    params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)),
                       seed=4)
    # the JAX eval matrix, as get_proj_matrix draws it
    proj = np.asarray(jax_proj_matrix(
        jax.random.PRNGKey(0), args["num_heads"], args["approx_attn_dim"],
        args["dim"] // args["num_heads"], ortho=True))
    return x, params, proj, _jit_apply(jm, params, x)


@pytest.mark.parametrize("proj_method,sample_scheme,cos,shape", [
    ("favorp", "default", False, (2, 8, 8, 48)),
    ("favorp", "learnable", False, (2, 16, 48)),
    ("favorp", "fixed", True, (2, 16, 48)),
    ("relu", "learnable", True, (2, 16, 48)),
    ("fourier", "default", False, (2, 16, 48)),
    ("dpfp", "default", False, (2, 16, 48)),
    ("mlp-fourier", "default", True, (2, 16, 48)),
    ("relu-only", "default", False, (2, 16, 48)),
    ("sigmoid-only", "default", True, (2, 16, 48)),
])
def test_kernelized_matches_jax(proj_method, sample_scheme, cos, shape):
    args = dict(dim=48, num_heads=4, proj_method=proj_method,
                sample_scheme=sample_scheme, cos_weighting=cos,
                approx_attn_dim=24 if proj_method == "dpfp" else 16)
    x, params, proj, ref = _jax_kernelized(tuple(sorted(args.items())), shape)
    fused = proj_method == "favorp" and not cos
    for impl in ("auto", "fused", "xla") if fused else ("auto",):
        m = load_jax_params(AttentionFactory.build_attention(
            "performer", dict(args, impl=impl)), params, random_proj=proj)
        out = torch_apply(m, x)
        if proj_method == "fourier":
            np.testing.assert_allclose(out, ref, rtol=0,
                                       atol=3e-5 * np.abs(ref).max())
        else:
            np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL,
                                       err_msg=impl)


def test_kernelized_matches_jax_with_padding_mask():
    args = dict(dim=48, num_heads=4, approx_attn_dim=16)
    x, params, proj, _ = _jax_kernelized(tuple(sorted(args.items())), (2, 16, 48))
    mask = np.zeros((2, 16), bool)
    mask[1, 11:] = True
    jm = JaxFactory.build_attention("performer", dict(args, impl="xla"))
    ref = _jit_apply(jm, params, x, mask)
    m = load_jax_params(AttentionFactory.build_attention("performer", args),
                        params, random_proj=proj).eval()
    with torch.no_grad():
        out = m(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    fused = load_jax_params(AttentionFactory.build_attention(
        "performer", dict(args, impl="fused")), params, random_proj=proj).eval()
    with pytest.raises(NotImplementedError, match="padding mask"):
        fused(torch.from_numpy(x), torch.from_numpy(mask))


def test_training_projection_comes_from_the_generator():
    """Training draws a fresh Gaussian projection from ``self.generator``;
    eval uses the fixed buffer, drawn with head h seeded 1000 h."""
    m = AttentionFactory.build_attention("performer", dict(
        dim=48, num_heads=4, approx_attn_dim=16)).train()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 16, 48)).astype(np.float32))
    outs = []
    for seed in (0, 0, 1):
        m.generator = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            outs.append(m(x))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    again = AttentionFactory.build_attention("performer", dict(
        dim=48, num_heads=4, approx_attn_dim=16))
    assert torch.equal(m.random_proj, again.random_proj)
    head1 = RF.orthogonal_gaussian_matrix(16, 12, torch.Generator().manual_seed(1000))
    assert torch.equal(m.random_proj[1], head1)


def test_orthogonal_blocks():
    w = RF.orthogonal_gaussian_matrix(40, 16, torch.Generator().manual_seed(0))
    unit = w / w.norm(dim=1, keepdim=True)
    for lo in (0, 16):  # full blocks: orthonormal directions
        block = unit[lo:lo + 16]
        torch.testing.assert_close(block @ block.t(), torch.eye(16),
                                   atol=1e-5, rtol=0)
    assert w.shape == (40, 16)


def test_golden_kernelized_favorp_loads_strictly():
    data = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                "kernelized_favorp.npz"))
    sd = {k[len("param:"):]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("param:")}
    for impl in ("auto", "fused", "xla"):
        m = AttentionFactory.build_attention("performer", {
            "dim": 48, "num_heads": 4, "proj_method": "favorp",
            "sample_scheme": "learnable", "approx_attn_dim": 32, "impl": impl})
        m.load_state_dict(sd, strict=True)
        np.testing.assert_allclose(torch_apply(m, data["x"]), data["out"],
                                   atol=ATOL, rtol=RTOL, err_msg=impl)


@pytest.mark.parametrize("args,error,match", [
    (dict(impl="pallas"), ValueError, "impl"),
    (dict(proj_method="hyper"), NotImplementedError, "proj_method"),
    (dict(sample_scheme="resample"), NotImplementedError, "sample scheme"),
])
def test_kernelized_bad_configurations_raise(args, error, match):
    with pytest.raises(error, match=match):
        AttentionFactory.build_attention("performer", dict(dim=48, num_heads=4,
                                                           **args))


def test_feature_maps_match_jax():
    """The maps the module does not reach: hyperbolic and log-space FAVOR+
    features and the full prm_projection surface."""
    from efficient_attention_tpu.ops import random_features as JRF

    rng = np.random.default_rng(6)
    data = rng.standard_normal((2, 3, 10, 8)).astype(np.float32)
    proj = rng.standard_normal((3, 6, 8)).astype(np.float32)
    jd, jp, td, tp = jnp.asarray(data), jnp.asarray(proj), *map(torch.from_numpy, (data, proj))
    cases = [
        (JRF.hyperm_projection(jd, jp), RF.hyperm_projection(td, tp)),
        (JRF.log_favorp_projection(jd, jp, True), RF.log_favorp_projection(td, tp, True)),
        (JRF.prm_projection(jd, jp, normalize=False, return_exp=True, is_query=True),
         RF.prm_projection(td, tp, normalize=False, return_exp=True, is_query=True)),
        (JRF.prm_projection(jd, jp, normalize=False, return_exp=True),
         RF.prm_projection(td, tp, normalize=False, return_exp=True)),
        (JRF.prm_projection(jd, jd, diagonal=True, normalize=False),
         RF.prm_projection(td, td, diagonal=True, normalize=False)),
    ]
    for want, got in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)


def test_gate():
    # the main path: B=128, 784 tokens, 3 heads of 64, 64 features
    assert K.supports_performer_fused(128, 784, 576, 3, 64, 2)
    assert K.supports_performer_fused(128, 784, 576, 3, 64, 4)
    assert K.smem_bytes(64, 64) <= K.SMEM_LIMIT
    assert K.uses_mma(64, 64, 2) and not K.uses_mma(64, 64, 4)
    assert not K.uses_mma(64, 24, 2)   # 24 features: the CUDA-core route
    assert 3 * (K.smem_bytes(64, 64, 2) + 1024) <= 233472
    assert not K.supports_performer_fused(128, 784, 576, 3, 64, 1)
    assert not K.supports_performer_fused(2, 784, 3 * 1024, 1, 1024, 4)


# ---- K6's ring route: layout, walk, forced routes and summation order (the
# kernel runs only on the card; its checks there are test_torch_cuda.py's) ----

@pytest.mark.parametrize("name,geo,want", [
    ("headline", (128, 784, 3, 64, 64), (4, 64, 4, 3)),
    ("DeiT-tiny-p16", (128, 196, 3, 64, 64), (4, 64, 4, 3)),
    ("3136 tokens", (128, 3136, 3, 64, 64), (4, 64, 4, 3)),
    ("head dim 16", (128, 784, 12, 16, 64), (4, 64, 4, 3)),
    ("head dim 32", (128, 784, 6, 32, 64), (4, 64, 4, 3)),
    ("one image", (1, 784, 3, 64, 64), (4, 64, 4, 3)),
    ("48 features", (2, 784, 3, 64, 48), (3, 64, 4, 3)),
    ("128 features", (16, 784, 3, 64, 128), (8, 128, 4, 1)),
    ("20000 tokens", (2, 20000, 1, 64, 64), (8, 128, 4, 1)),
    ("60000 tokens", (2, 60000, 1, 64, 64), None),  # the norms do not fit
    ("f32", (128, 784, 3, 64, 64, 4), None),
    ("head dim 48", (2, 784, 2, 48, 64), None),
    ("24 features", (2, 784, 3, 64, 24), None),
])
def test_ring_plan_choices(name, geo, want):
    """The ring route's layout at the check script's shapes and elsewhere:
    the first of RING_CONFIGS whose blocks fit an SM (warps rounded to a
    multiple of m / 16), or None, where the launch keeps the kernel that
    took it before."""
    got = K.plan(*geo) if len(geo) == 6 else K.plan(*geo, 2)
    assert (None if got is None else tuple(got[:4])) == want, name
    if got is not None:
        d, m, N = geo[3], geo[4], geo[1]
        assert got.smem == K.ring_smem_bytes(d, m, N, *got[:3])
        assert got.bps * (got.smem + 1024) <= K.SM_SMEM


def test_ring_smem_bytes_region_by_region():
    """The ring block's bytes, region by region (each 128-byte aligned): the
    headline's layout, 8 warps (two token splits), and a small geometry
    whose regions round up."""
    w = 64 * 72 * 2                        # the projection, kv: [64][64 + 8] bf16
    slot = 64 * 72 * 2                     # one 64-row tile
    # 4 warps, 64-row tiles, 4 slots, one token split: no kv partial
    assert K.ring_smem_bytes(64, 64, 784, 4, 64, 4) == (
        2 * w + 4 * slot + 0 + 64 * 4 + 64 * 4 + 13 * 64 * 4 + 128) == 59264
    # 8 warps, 128-row tiles: two splits, one f32 kv partial [64][68]
    assert K.ring_smem_bytes(64, 64, 784, 8, 128, 4) == (
        2 * w + 4 * 2 * slot + 64 * 68 * 4 + 2 * 64 * 4 + 64 * 4 + 7 * 128 * 4
        + 128) == 114048
    # head dim 16, 16 features, 49 tokens in 16-row tiles, 4 splits
    assert K.ring_smem_bytes(16, 16, 49, 4, 16, 4) == (
        768 + 768 + 4 * 768 + 3 * 16 * 20 * 4 + 256 + 128 + 256 + 128) == 9216


@pytest.mark.parametrize("layout,ok", [
    ((64, 64, 784, 4, 64, 4), True),
    ((64, 64, 784, 8, 128, 4), True),
    ((64, 128, 784, 8, 128, 4), True),
    ((16, 16, 49, 4, 16, 4), True),
    ((32, 64, 3136, 4, 64, 8), True),
    ((48, 64, 784, 4, 64, 4), False),    # head dim 48
    ((64, 24, 784, 4, 64, 4), False),    # 24 features
    ((64, 144, 784, 8, 128, 4), False),  # more than 128 features
    ((64, 64, 784, 6, 128, 4), False),   # warps not a multiple of m / 16
    ((64, 128, 784, 16, 64, 4), False),  # more than 8 warps
    ((64, 64, 784, 8, 104, 4), False),   # tile not a multiple of 16
    ((64, 64, 784, 4, 64, 3), False),    # pass B's k and v need 4 slots
    ((64, 64, 784, 4, 64, 9), False),    # nine slots
    ((64, 64, 60000, 8, 128, 4), False),  # the norms beyond the block
])
def test_ring_config_ok(layout, ok):
    assert K.ring_config_ok(*layout) == ok


@pytest.mark.parametrize("B", [1, 7, 128])
@pytest.mark.parametrize("nh", [3, 12])
def test_ring_walk_covers_every_item_once(B, nh):
    """The persistent blocks take every (image, head) exactly once, each
    block one head for its life, and the heads of one image at the same
    position of their blocks' walks (so they run side by side)."""
    for bps in (1, 2, 3):
        blocks = K.ring_blocks(B, nh, bps)
        assert blocks % nh == 0 and blocks <= B * nh
        assert blocks <= max(nh, K.SMS * bps)
        walk = list(K.ring_walk(B, nh, blocks))
        assert sorted((h, b) for _, h, b in walk) == sorted(
            (h, b) for h in range(nh) for b in range(B))
        heads, position = {}, {}
        for blk, h, b in walk:
            heads.setdefault(blk, set()).add(h)
            position.setdefault(blk, []).append(b)
        assert all(len(hs) == 1 for hs in heads.values())
        for blk in range(0, blocks, nh):
            assert all(position[blk + h] == position[blk] for h in range(nh))


def test_route_config_forces_and_refuses_layouts():
    """``config`` None takes ``plan``'s layout, 0 the kernel that took the
    geometry before, a 5-tuple a ring layout that must fit; f32 and head dim
    48 have no ring layout."""
    geo = (128, 784, 3, 64, 64, 2)
    assert K.route_config(*geo) == K.plan(*geo)
    assert K.route_config(*geo, config=0) is None
    forced = K.route_config(*geo, config=(8, 64, 6, 1))
    assert tuple(forced[:4]) == (8, 64, 6, 1)
    assert forced.smem == K.ring_smem_bytes(64, 64, 784, 8, 64, 6)
    for bad in ((8, 64, 9, 1), (6, 128, 4, 1), (8, 64, 4, 0),
                (8, 64, 4, 2)):   # an 8-warp block is built for one an SM
        with pytest.raises(ValueError, match="ring layout"):
            K.route_config(*geo, config=bad)
    with pytest.raises(ValueError, match="ring layout"):   # 3 x 114 KB an SM
        K.route_config(*geo, config=(4, 128, 4, 3))
    assert K.plan(128, 784, 3, 64, 64, 4) is None
    assert K.plan(2, 784, 2, 48, 64, 2) is None
    assert K.route_config(2, 784, 2, 48, 64, 2) is None


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("geometry,layout", [
    ((2, 3, 16, 56, 32), (8, 32)),   # 4 token splits of 16-token chunks
    ((1, 2, 32, 80, 16), (4, 64)),   # 4 splits, a ragged last tile
    ((1, 1, 64, 49, 64), (8, 32)),   # 2 splits, 49 tokens
])
def test_ring_summation_order_matches_jax_kernel(geometry, layout, dtype):
    """The ring route's arithmetic emulated on the CPU
    (``performer_fused_ring_ref``: kv and z summed in each warp's 16-token
    chunks in order, the token splits' partials added in f32, kv rounded
    once) against the interpret-mode Pallas kernel: f32 to 3e-5 abs /
    1e-4 rel (summation order), bf16 to one rounding (2^-7) of the output's
    largest value, the limit the kernel is held to on the card."""
    B, H, d, N, m = geometry
    qkv, proj = _kernel_inputs(B, H, d, N, m, seed=7)
    jq = jnp.asarray(qkv) if dtype is np.float32 else jnp.asarray(qkv).astype(jnp.bfloat16)
    want = np.asarray(jax_fused(jq, jnp.asarray(proj), H, interpret=True).astype(jnp.float32))
    tq = torch.from_numpy(qkv)
    if dtype != np.float32:
        tq = tq.to(torch.bfloat16)
    got = K.performer_fused_ring_ref(tq, torch.from_numpy(proj), H, *layout)
    assert got.dtype == tq.dtype
    if dtype is np.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    else:
        assert np.abs(got.float().numpy() - want).max() <= 2 ** -7 * np.abs(want).max()

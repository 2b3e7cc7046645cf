"""LARA of the PyTorch port against the JAX package, on the CPU.

* K5 ``lara_fused``: the plain version must give the interpret-mode Pallas
  kernel and its twin ``lara_fused_twin`` to 3e-5 abs / 1e-4 rel in float32
  (both at a landmark count that is not a multiple of 8), and the gradient of
  every input must give ``jax.grad`` of the twin to 1e-4 abs / 1e-3 rel.
* ``LinearRA`` at eval, every proposal generator and MIS type, 1-D and 2-D,
  with and without a padding mask, and in training with the proposal noise
  injected on both sides: outputs to 3e-5 abs / 1e-4 rel, gradients to 1e-4
  abs / 1e-3 rel (``test_torch_eva.py``'s tolerances).
* The reference golden ``lara_pool_mixed.npz`` loads with ``strict=True`` and
  matches to 3e-5 abs / 1e-4 rel (``test_goldens.py:133``).
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
from efficient_attention_tpu.ops.pallas.lara_fused import (
    _round8,
    lara_attention_fused as jax_fused,
    lara_fused_twin,
)
from efficient_attention_torch import AttentionFactory
from efficient_attention_torch.attention.lara import LinearRA
from efficient_attention_torch.interop import load_jax_params, state_dict_from_jax
from efficient_attention_torch.ops.kernels import lara_fused as K

ATOL, RTOL = 3e-5, 1e-4
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def jax_apply(module, params, x):
    """The JAX module's eval output, through one jitted call."""
    return np.asarray(jax.jit(lambda p, xx: module.apply(p, xx, deterministic=True))(
        to_jax(params), jnp.asarray(x)))


def _kernel_inputs(B, H, d, N, c, seed, key_scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    qkv = f(B, N, 3 * H * d)
    qkv[..., H * d:2 * H * d] *= key_scale
    logits = f(B, H, c)
    bal = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return [qkv, 0.5 * f(B, H, c, d), 0.5 * f(B, H, c, d),
            bal.astype(np.float32), f(B, H, c)]


def _twin(arrays, H, d, c, alpha):
    qkv, w, qb, bal, lp = (jnp.asarray(a) for a in arrays)
    B = qkv.shape[0]
    c8 = _round8(c)

    def pack(t):
        return jnp.pad(jnp.swapaxes(t, 1, 2).reshape(B, c, H * d),
                       ((0, 0), (0, c8 - c), (0, 0)))

    def pack_sc(t):
        return jnp.pad(jnp.swapaxes(t, 1, 2), ((0, 0), (0, c8 - c), (0, 0)))

    return lambda q, w, qb, bal, lp: lara_fused_twin(
        q, pack(w), pack(qb), pack_sc(bal), pack_sc(lp), scale=d ** -0.5,
        nh=H, c=c, alpha_coeff=alpha), (qkv, w, qb, bal, lp)


@pytest.mark.parametrize("geometry,alpha", [((2, 2, 16, 64, 12), 2.0),
                                            ((2, 3, 64, 56, 49), 2.0),
                                            ((1, 2, 64, 64, 16), 1.0)])
def test_plain_matches_jax_kernel_and_twin(geometry, alpha):
    B, H, d, N, c = geometry
    arrays = _kernel_inputs(B, H, d, N, c, seed=0)
    twin, jargs = _twin(arrays, H, d, c, alpha)
    pallas = np.asarray(jax_fused(*jargs, d ** -0.5, H, alpha_coeff=alpha,
                                  interpret=True))
    out = K.lara_fused_ref(*map(torch.from_numpy, arrays), d ** -0.5, H,
                           alpha).numpy()
    np.testing.assert_allclose(out, np.asarray(jax.jit(twin)(*jargs)),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=RTOL)


def test_grads_match_jax_twin():
    """Every input's gradient through the autograd Function (the plain
    version on the CPU) against jax.grad of the twin."""
    B, H, d, N, c = 2, 2, 16, 64, 12
    arrays = _kernel_inputs(B, H, d, N, c, seed=1)
    g = np.random.default_rng(2).standard_normal((B, N, H * d)).astype(np.float32)
    twin, jargs = _twin(arrays, H, d, c, 2.0)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(twin(*a) * jnp.asarray(g)),
                            argnums=(0, 1, 2, 3, 4)))(*jargs)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    before = K.LAUNCHES
    out = K.lara_attention_fused(*leaves, d ** -0.5, H, alpha_coeff=2.0)
    (out * torch.from_numpy(g)).sum().backward()
    assert K.LAUNCHES == before  # the CPU takes the plain version
    for name, leaf, w in zip(("qkv", "w", "q_bar", "balance", "log_proposal"),
                             leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def test_large_norm_keys_match_the_eager_module():
    """Keys far from every landmark: the plain version (true-max softmax)
    agrees with the JAX eager LinearRA where the TPU kernel's fixed bound
    underflows (ROADMAP.md Queue 3)."""
    args = dict(dim=128, num_heads=2, num_landmarks=16,
                proposal_gen="pool-mixed", mis_type="mis-opt", alpha_coeff=2.0)
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 128)).astype(np.float32)
    jm = JaxFactory.build_attention("lara", dict(args, impl="xla"))
    params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), seed=4)
    params["params"]["qkv"]["kernel"][:, 128:256] *= 40.0  # |k| ~ 40 sqrt(d)
    ref = jax_apply(jm, params, x)
    m = load_jax_params(AttentionFactory.build_attention(
        "lara", dict(args, impl="fused")), params)
    out = torch_apply(m, x)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    assert np.abs(ref).max() > 0.1


# ---- LinearRA ----

# every MIS type on the recipe's generator, every other generator and the
# dense pool once
CASES_2D = [("pool-mixed", "light", "mis-opt"), ("pool-mixed", "light", "mis-biased"),
            ("pool-mixed", "light", "mis-bh"), ("pool", "light", "mis-opt"),
            ("no-param-pool", "light", "mis-opt"), ("pool-vmixed", "dense", "mis-opt")]


def _x(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_lara(args_items, shape):
    args = dict(args_items)
    x = _x(shape)
    jm = JaxFactory.build_attention("lara", dict(args, impl="xla"))
    params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), seed=6)
    return x, params, jax_apply(jm, params, x)


@pytest.mark.parametrize("proposal_gen,pool,mis_type", CASES_2D)
def test_lara_2d_matches_jax(proposal_gen, pool, mis_type):
    args = dict(dim=48, num_heads=4, num_landmarks=16, proposal_gen=proposal_gen,
                pool_module_type=pool, mis_type=mis_type, alpha_coeff=2.0)
    x, params, ref = _jax_lara(tuple(sorted(args.items())), (2, 8, 8, 48))
    impls = ("auto", "fused", "xla") if mis_type == "mis-opt" else ("auto",)
    for impl in impls:
        m = load_jax_params(AttentionFactory.build_attention(
            "lara", dict(args, impl=impl)), params)
        np.testing.assert_allclose(torch_apply(m, x), ref, atol=ATOL, rtol=RTOL,
                                   err_msg=impl)


@pytest.mark.parametrize("proposal_gen,n,c,mis_type", [
    ("adaptive-1d", 32, 8, "mis-opt"), ("adaptive-1d", 30, 8, "mis-biased"),
    ("no-param-pool", 37, 6, "mis-bh")])
def test_lara_1d_matches_jax(proposal_gen, n, c, mis_type):
    args = dict(dim=48, num_heads=4, num_landmarks=c, proposal_gen=proposal_gen,
                mis_type=mis_type)
    x, params, ref = _jax_lara(tuple(sorted(args.items())), (2, n, 48))
    m = load_jax_params(AttentionFactory.build_attention("lara", args), params)
    np.testing.assert_allclose(torch_apply(m, x), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape,proposal_gen", [((2, 32, 48), "adaptive-1d"),
                                                ((2, 8, 8, 48), "pool-mixed")])
def test_lara_matches_jax_with_padding_mask(shape, proposal_gen):
    args = dict(dim=48, num_heads=4, num_landmarks=16 if len(shape) == 4 else 8,
                proposal_gen=proposal_gen, mis_type="mis-opt")
    x, params, _ = _jax_lara(tuple(sorted(args.items())), shape)
    n = int(np.prod(shape[1:-1]))
    mask = np.zeros((2, n), bool)
    mask[0, n - 5:] = True
    mask[1, n - 11:] = True
    jm = JaxFactory.build_attention("lara", dict(args, impl="xla"))
    ref = np.asarray(jax.jit(lambda p, xx, mk: jm.apply(p, xx, key_padding_mask=mk))(
        to_jax(params), jnp.asarray(x), jnp.asarray(mask)))
    m = load_jax_params(AttentionFactory.build_attention("lara", args), params)
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    # the fused route takes no padding mask
    fused = load_jax_params(AttentionFactory.build_attention(
        "lara", dict(args, impl="fused")), params).eval()
    with pytest.raises(NotImplementedError, match="padding mask"):
        fused(torch.from_numpy(x), torch.from_numpy(mask))


@pytest.mark.parametrize("mis_type,sampling", [
    ("mis-opt", "default"), ("mis-biased", "antithetics"), ("mis-bh", "multisample")])
def test_lara_train_mode_matches_jax(monkeypatch, mis_type, sampling):
    """Training forward and every gradient against the JAX module at
    deterministic=False, the proposal noise injected on both sides
    (``jax.random.normal`` there, ``LinearRA._proposal_noise`` here)."""
    args = dict(dim=48, num_heads=4, num_landmarks=16, proposal_gen="pool-mixed",
                mis_type=mis_type, alpha_coeff=2.0,
                use_antithetics=sampling == "antithetics",
                use_multisample=sampling == "multisample")
    x, params, _ = _jax_lara(tuple(sorted(args.items())), (2, 8, 8, 48))
    c = 32 if sampling == "multisample" else 16
    noise = np.random.default_rng(7).standard_normal((2, 4, c, 12)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    monkeypatch.setattr(LinearRA, "_proposal_noise",
                        lambda self, shape, like: torch.from_numpy(noise).to(like.dtype))
    cot = _x(x.shape, seed=8)
    jm = JaxFactory.build_attention("lara", dict(args, impl="xla"))

    def loss(p, xx):
        out = jm.apply(p, xx, deterministic=False,
                       rngs={"sample": jax.random.PRNGKey(1)})
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(to_jax(params), jnp.asarray(x))
    m = load_jax_params(AttentionFactory.build_attention("lara", args), params).train()
    xt = torch.from_numpy(x).requires_grad_()
    out = m(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.array, gp))
    named = dict(m.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   **GRAD_TOL, err_msg=name)


def test_proposal_noise_comes_from_the_generator():
    m = AttentionFactory.build_attention("lara", dict(
        dim=48, num_heads=4, num_landmarks=16, proposal_gen="pool")).train()
    x = torch.from_numpy(_x((1, 8, 8, 48), seed=9))
    outs = []
    for seed in (0, 0, 1):
        m.generator = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            outs.append(m(x))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


def test_golden_lara_pool_mixed_loads_strictly():
    data = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                "lara_pool_mixed.npz"))
    sd = {k[len("param:"):]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("param:")}
    for impl in ("auto", "fused", "xla"):
        m = AttentionFactory.build_attention("lara", {
            "dim": 48, "num_heads": 4, "num_landmarks": 4,
            "proposal_gen": "pool-mixed", "mis_type": "mis-opt",
            "attn_2d": True, "alpha_coeff": 2.0, "impl": impl})
        m.load_state_dict(sd, strict=True)
        np.testing.assert_allclose(torch_apply(m, data["x"]), data["out"],
                                   atol=ATOL, rtol=RTOL, err_msg=impl)


@pytest.mark.parametrize("args,error,match", [
    (dict(impl="pallas"), ValueError, "impl"),
    (dict(mis_type="mis-x"), NotImplementedError, "mis_type"),
    (dict(proposal_gen="conv"), NotImplementedError, "proposal_gen"),
    (dict(pool_module_type="deep"), NotImplementedError, "pool_module_type"),
])
def test_lara_bad_configurations_raise(args, error, match):
    with pytest.raises(error, match=match):
        AttentionFactory.build_attention("lara", dict(dim=48, num_heads=4, **args))


def test_fused_route_on_cpu(monkeypatch):
    """At eval, 'auto' keeps the eager path for CPU tensors (the kernel
    route is for CUDA ones), 'fused' takes the wrapper on any device, and
    neither launches a kernel on the CPU; training never takes it."""
    import efficient_attention_torch.attention.lara as lara_module

    calls = []
    wrapper = lara_module.lara_attention_fused
    monkeypatch.setattr(lara_module, "lara_attention_fused",
                        lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    x = torch.from_numpy(_x((2, 8, 8, 48), seed=10))
    before = K.LAUNCHES
    for impl, train, expected in (("auto", False, 0), ("xla", False, 0),
                                  ("fused", False, 1)):
        m = AttentionFactory.build_attention("lara", dict(
            dim=48, num_heads=4, num_landmarks=16, impl=impl)).train(train)
        with torch.no_grad():
            m(x)
        assert len(calls) == expected
        calls.clear()
    fused = AttentionFactory.build_attention("lara", dict(
        dim=48, num_heads=4, num_landmarks=16, impl="fused")).train()
    with pytest.raises(NotImplementedError, match="eval"):
        fused(x)
    assert K.LAUNCHES == before


def test_gate():
    # the main path: B=128, 784 tokens, 3 heads of 64, 49 landmarks
    assert K.supports_lara_fused(128, 784, 576, 3, 49, 2)
    assert K.supports_lara_fused(128, 784, 576, 3, 49, 4)
    assert K.smem_bytes(64, 49) <= K.SMEM_LIMIT
    # bf16 at head dims that are multiples of 16 takes the tensor-core route,
    # whose block fits three to an SM at the main shape
    assert K.uses_mma(64, 49, 2) and not K.uses_mma(64, 49, 4)
    assert not K.uses_mma(12, 4, 2)
    assert 3 * (K.smem_bytes(64, 49, 2) + 1024) <= 233472
    assert not K.supports_lara_fused(128, 784, 576, 3, 49, 1)   # element size
    assert not K.supports_lara_fused(128, 784, 577, 3, 49, 2)   # heads
    assert not K.supports_lara_fused(2, 784, 3 * 1024, 1, 400, 4)  # smem


# ---- K5's routes: the cluster route's plan and layout, the gate's sweep,
# and a CPU model of the cluster's partition ----

# (B, N, heads, head dim, landmarks, itemsize) -> (ranks, shared memory,
# route): the DeiT-tiny-p8 headline, DeiT-tiny-p16's 196 tokens, PVT-B3
# stage 1's 3136 with one head of 64, a 1-D N = 50, C = 1, 49 and 64,
# head dims 16, 32 and 64; then the bf16 geometries the cluster route
# leaves to the wmma kernel (head dims 48 and 512, 65 landmarks, more tokens
# than 16 blocks hold) and those left to the CUDA-core kernel (f32, head
# dim 12, kv tiles beyond the wmma kernel's accumulators)
PLANS = [
    ((128, 784, 3, 64, 49, 2), (2, 221568, "cluster")),
    ((128, 196, 3, 64, 49, 2), (1, 137344, "cluster")),
    ((128, 3136, 1, 64, 49, 2), (8, 224640, "cluster")),
    ((2, 50, 3, 64, 49, 2), (1, 74496, "cluster")),
    ((128, 784, 3, 64, 1, 2), (2, 185984, "cluster")),
    ((128, 784, 3, 64, 64, 2), (2, 225152, "cluster")),
    ((128, 784, 3, 16, 49, 2), (1, 134912, "cluster")),
    ((128, 784, 3, 32, 49, 2), (1, 219392, "cluster")),
    ((128, 784, 3, 48, 49, 2), (-1, 57984, "wmma")),
    ((128, 784, 3, 64, 65, 2), (-1, 80512, "wmma")),
    ((2, 20000, 1, 64, 49, 2), (-1, 67200, "wmma")),
    ((2, 784, 1, 512, 16, 2), (-1, 217984, "wmma")),
    ((128, 784, 3, 64, 49, 4), (0, 69552, "cuda-cores")),
    ((128, 784, 4, 12, 49, 2), (0, 25664, "cuda-cores")),
    ((2, 784, 1, 96, 128, 2), (0, 211840, "cuda-cores")),
]


@pytest.mark.parametrize("geometry,want", PLANS)
def test_plan_picks_the_smallest_cluster_that_fits(geometry, want):
    B, N, nh, d, C, itemsize = geometry
    got = K.plan(B, N, nh, d, C, itemsize)
    assert got == want
    assert K.supports_lara_fused(B, N, 3 * nh * d, nh, C, itemsize)
    R, smem, route = got
    assert smem <= K.SMEM_LIMIT
    if route == "cluster":
        rows = -(-N // R)
        assert K.uses_mma(d, C, itemsize) and (R - 1) * rows < N  # no empty block
        assert smem == K.smem_bytes(d, C, 2, rows, R)
        # every smaller cluster's blocks exceed shared memory or leave one empty
        for r in range(1, R):
            rw = -(-N // r)
            assert (r - 1) * rw >= N or K.smem_bytes(d, C, 2, rw, r) > K.SMEM_LIMIT
    else:
        assert smem == K.smem_bytes(d, C, 4 if route == "cuda-cores" else 2)
        assert (route == "wmma") == K.uses_wmma(d, C, itemsize)


def _old_gate_smem(d, C, itemsize):
    """The shared memory of the block the gate of the wmma/CUDA-core kernel
    pair held each geometry to before the cluster route (its smem_bytes)."""
    TT, a16 = 32, lambda n: -(-n // 16) * 16  # noqa: E731
    a128 = lambda n: -(-n // 128) * 128  # noqa: E731
    if itemsize == 2 and d % 16 == 0 and (a16(C) // 16) * (d // 16) <= 32:
        CP, DB = a16(C), d + 8
        LF = max(CP * (TT + 4), TT * (CP + 4))
        FS = max(2 * LF, CP * (d + 4), TT * (d + 4))
        PB = max(CP * (TT + 8), TT * (CP + 8))
        return (3 * a128(CP * DB * 2) + 3 * a128(TT * DB * 2) + a128(FS * 4)
                + a128(PB * 2) + a128(8 * CP * 4) + a128(TT * 4))
    DP = d + 1
    logits = a16(max(C * (TT + 1), TT * (C + 1)) * 4)
    return (3 * a16(C * DP * 4) + 2 * a16(TT * DP * 4) + 2 * logits
            + a16(8 * C * 4) + a16(TT * 4))


@pytest.mark.parametrize("itemsize", [2, 4])
def test_gate_still_takes_every_geometry_it_took(itemsize):
    """Every (head dim, landmarks, tokens) the gate took before the cluster
    route still passes it, and where the cluster route does not take it,
    it keeps the kernel it ran on before (wmma where ``uses_wmma``); bf16
    takes all three routes, f32 the CUDA-core one."""
    routes = set()
    for d in [*range(1, 130), 192, 256, 384, 512, 768, 1024]:
        for C in [*range(1, 80), 96, 128, 192, 256, 400, 512]:
            if _old_gate_smem(d, C, itemsize) > K.SMEM_LIMIT:
                continue
            old = "wmma" if K.uses_wmma(d, C, itemsize) else "cuda-cores"
            for N in (1, 50, 784, 20000):
                got = K.plan(128, N, 1, d, C, itemsize)
                assert got is not None, (d, C, N)
                assert K.supports_lara_fused(128, N, 3 * d, 1, C, itemsize)
                assert got[2] in ("cluster", old), (d, C, N, got)
                routes.add(got[2])
    assert routes == ({"cluster", "cuda-cores", "wmma"} if itemsize == 2
                      else {"cuda-cores"})


@pytest.mark.parametrize("key_scale", [1.0, 40.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ranks", [1, 4, 7, 8, 16])
def test_split_partition_matches_plain(ranks, dtype, key_scale):
    """The cluster route's partition (per-block maxima, sums and kv over
    slices padded to 16 rows, combined in rank order) gives the plain
    version: 1e-5 relative to the output's largest value in f32, one bf16
    rounding (2^-7) in bf16; also with keys far from every landmark (the
    large-norm case of test_large_norm_keys_match_the_eager_module)."""
    B, H, d, N, c = 2, 2, 16, 95, 12  # no slice empty at 16 ranks
    arrays = [torch.from_numpy(a) for a in
              _kernel_inputs(B, H, d, N, c, seed=11, key_scale=key_scale)]
    arrays[0] = arrays[0].to(dtype)
    want = K.lara_fused_ref(*arrays, d ** -0.5, H, 2.0).float()
    got = K.lara_fused_split_ref(*arrays, d ** -0.5, H, 2.0, ranks=ranks).float()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


def test_split_partition_refuses_an_empty_block():
    arrays = [torch.from_numpy(a) for a in _kernel_inputs(1, 1, 16, 50, 4, seed=12)]
    with pytest.raises(ValueError, match="empty"):
        K.lara_fused_split_ref(*arrays, 0.25, 1, 2.0, ranks=16)

"""K7 ``local_packed`` of the PyTorch port against the JAX package, on the CPU.

The plain version must give the interpret-mode Pallas kernel and its
``_xla_rowmajor`` to 3e-5 abs / 1e-4 rel in float32 (``TestLocalPacked``'s
tolerance), with and without the RPE bias; the gradients of qkv and the bias
must give ``jax.grad`` of ``_xla_rowmajor`` to 1e-4 abs / 1e-3 rel.  The
``LocalAttention`` module takes the K7 route (the plain version on the CPU)
at eval and in training, and its outputs and gradients match the JAX
module's to the same tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32, randomize, to_jax
from efficient_attention_tpu import AttentionFactory as JaxFactory
from efficient_attention_tpu.ops.pallas.local_packed import (
    _xla_rowmajor,
    local_attention_packed as jax_packed,
)
from efficient_attention_torch import AttentionFactory
from efficient_attention_torch.interop import load_jax_params, state_dict_from_jax
from efficient_attention_torch.ops.kernels import local_packed as K

ATOL, RTOL = 3e-5, 1e-4
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)

# (grid width, window, heads, head dim)
GEOMETRIES = [(8, 4, 3, 16), (14, 7, 4, 12), (6, 3, 2, 8)]


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def _inputs(W, ws, nh, d, B=2, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, W * W, 3 * nh * d), (0.1 * f(nh, ws * ws, ws * ws)).astype(np.float32),
            f(B, W * W, nh * d))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_plain_matches_jax(geometry, with_bias):
    W, ws, nh, d = geometry
    qkv, bias, _ = _inputs(W, ws, nh, d)
    scale = d ** -0.5
    jbias = jnp.asarray(bias) if with_bias else None
    ref = np.asarray(_xla_rowmajor(jnp.asarray(qkv), scale, nh, W, ws, jbias))
    pallas = np.asarray(jax_packed(jnp.asarray(qkv), scale, nh, W, ws,
                                   bias=jbias, interpret=True))
    out = K.local_packed_ref(torch.from_numpy(qkv), scale, nh, W, ws,
                             torch.from_numpy(bias) if with_bias else None).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_grads_match_jax(with_bias):
    """qkv and bias gradients through the autograd Function (the plain
    version on the CPU) against jax.grad of ``_xla_rowmajor``, the JAX
    kernel's VJP source."""
    W, ws, nh, d = GEOMETRIES[1]
    qkv, bias, g = _inputs(W, ws, nh, d, seed=1)
    scale = d ** -0.5

    def loss(q, b):
        return jnp.sum(_xla_rowmajor(q, scale, nh, W, ws, b if with_bias else None)
                       * jnp.asarray(g))

    want = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(qkv),
                                                   jnp.asarray(bias))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (qkv, bias)]
    before = K.LAUNCHES
    out = K.local_attention_packed(leaves[0], scale, nh, W, ws,
                                   bias=leaves[1] if with_bias else None)
    (out * torch.from_numpy(g)).sum().backward()
    assert K.LAUNCHES == before  # the CPU takes the plain version
    np.testing.assert_allclose(leaves[0].grad.numpy(), np.asarray(want[0]),
                               **GRAD_TOL)
    if with_bias:
        np.testing.assert_allclose(leaves[1].grad.numpy(), np.asarray(want[1]),
                                   **GRAD_TOL)
    else:
        assert leaves[1].grad is None


def test_bf16_plain_version_rounds_like_the_tpu_kernel():
    W, ws, nh, d = GEOMETRIES[0]
    qkv, bias, _ = map(torch.from_numpy, _inputs(W, ws, nh, d, seed=2))
    lo = qkv.to(torch.bfloat16)
    out = K.local_packed_ref(lo, 0.25, nh, W, ws, bias)
    assert out.dtype == torch.bfloat16
    ref = K.local_packed_ref(lo.float(), 0.25, nh, W, ws, bias)
    assert (out.float() - ref).abs().max() < 2 ** -5


@pytest.mark.parametrize("train", [False, True])
def test_local_attention_takes_k7_and_matches_jax(monkeypatch, train):
    """The module route (JAX ``local.py:145-170``): eval output, and in
    training (attention dropout 0) every gradient, against the JAX module;
    'xla' keeps the eager path."""
    import efficient_attention_torch.attention.local as local_module

    args = dict(dim=48, num_heads=4, window_size=4, attn_2d=True, use_rpe=True)
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 48)).astype(np.float32)
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    jm = JaxFactory.build_attention("local", args)
    params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 5)

    def loss(p, xx):
        out = jm.apply(p, xx, deterministic=not train)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(to_jax(params), jnp.asarray(x))
    calls = []
    wrapper = local_module.local_attention_packed
    monkeypatch.setattr(local_module, "local_attention_packed",
                        lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    for impl in ("auto", "xla"):
        m = load_jax_params(AttentionFactory.build_attention(
            "local", dict(args, impl=impl)), params).train(train)
        xt = torch.from_numpy(x).requires_grad_()
        out = m(xt)
        (out * torch.from_numpy(cot)).sum().backward()
        assert len(calls) == (impl == "auto")
        calls.clear()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=RTOL, err_msg=impl)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD_TOL)
        named = dict(m.named_parameters())
        for name, g in state_dict_from_jax(
                jax.tree_util.tree_map(np.array, gp)).items():
            np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                       **GRAD_TOL, err_msg=name)


def test_local_route_conditions(monkeypatch):
    """No K7 with a padding mask, attention dropout, or a head dim the
    kernel is not built for; an unknown impl raises."""
    import efficient_attention_torch.attention.local as local_module

    calls = []
    monkeypatch.setattr(local_module, "local_attention_packed",
                        lambda *a, **k: calls.append(1))
    x = torch.zeros(1, 8, 8, 48)
    base = dict(dim=48, num_heads=4, window_size=4, attn_2d=True, use_rpe=True)
    with torch.no_grad():
        AttentionFactory.build_attention("local", base).eval()(
            x, torch.zeros(1, 64, dtype=torch.bool))
        AttentionFactory.build_attention("local", dict(base, attn_drop=0.1)).eval()(x)
        AttentionFactory.build_attention("local", dict(base, num_heads=2)).eval()(x)
    assert not calls
    with pytest.raises(ValueError, match="impl"):
        AttentionFactory.build_attention("local", dict(base, impl="packed"))


def test_gate():
    # the main path: B=128, 28x28 tokens, window 7, 3 heads of 64
    assert K.plan(128, 784, 28, 7, 3, 64, 2) == 4
    assert K.supports_packed(128, 784, 28, 7, 64, 4, 3)
    assert K.plan(2, 196, 14, 7, 4, 12, 4) == 4
    assert K.plan(2, 81, 9, 3, 2, 16, 4) == 1
    assert not K.supports_packed(2, 784, 28, 7, 24, 4)   # head dim 24
    assert not K.supports_packed(2, 784, 28, 5, 64, 4)   # window 5
    assert not K.supports_packed(2, 784, 28, 7, 64, 1)   # element size
    assert K.smem_bytes(64, 49) <= K.SMEM_LIMIT
    assert K.uses_mma(64, 2) and not K.uses_mma(12, 2) and not K.uses_mma(64, 4)
    assert 3 * (K.smem_bytes(64, 49, 2) + 1024) <= 233472


# ---- the bf16 tensor-core route (csrc/local_packed.cu,
# local_packed_fwd_mma_kernel): its layout, its gate and its arithmetic ----

def test_mma_smem_layout_counts_each_region():
    """A window's q, k and v rows [S][d + 8] in bf16, two buffers each, the
    bias [S][S] in f32 and the token table [4][S] in int32, each region
    128-byte aligned; three blocks an SM at the serving cell's S = 49, head
    dim 64 (Hopper: 228 KB an SM, 1 KB of it reserved a block)."""
    a128 = lambda n: -(-n // 128) * 128  # noqa: E731
    for d, S in ((64, 49), (32, 9), (16, 16), (64, 121)):
        win = a128(S * (d + 8) * 2)
        assert K.smem_bytes(d, S, 2) == 3 * 2 * win + a128(S * S * 4) + a128(4 * S * 4)
    assert K.smem_bytes(64, 49, 2) == 53632
    assert 3 * (K.smem_bytes(64, 49, 2) + 1024) <= 233472
    # f32 keeps the CUDA-core route's layout
    assert K.smem_bytes(64, 49, 4) == K.smem_bytes(64, 49)


def _old_wmma_smem_bytes(d, S):
    """Shared memory of the wmma route this kernel replaced: q, k, v
    [SP][d + 8] and P [SP][SP + 8] in bf16 with the window padded to SP, a
    multiple of 16, rows; an f32 region for the logits [SP][SP + 4] or the
    output tile [SP][d + 4]; the bias [S][S] in f32; each 128-byte aligned."""
    a128 = lambda n: -(-n // 128) * 128  # noqa: E731
    SP = -(-S // 16) * 16
    return (3 * a128(SP * (d + 8) * 2) + a128(max(SP * (SP + 4), SP * (d + 4)) * 4)
            + a128(SP * (SP + 8) * 2) + a128(S * S * 4))


def test_plan_admits_every_bf16_window_the_old_layout_did():
    for d in (16, 32, 64):
        for ws in range(1, 12):
            g = 2 * ws
            old = _old_wmma_smem_bytes(d, ws * ws) <= K.SMEM_LIMIT
            new = K.plan(2, g * g, g, ws, 3, d, 2) is not None
            assert new or not old, (d, ws)
            assert K.uses_mma(d, 2)
    assert K.plan(2, 22 * 22, 22, 11, 3, 64, 2) is not None  # two passes
    assert _old_wmma_smem_bytes(64, 144) > K.SMEM_LIMIT
    assert K.plan(2, 24 * 24, 24, 12, 3, 64, 2) is not None  # now fits


_LOG2E = 1.4426950408889634


def _strip_walk(qkv, scale, nh, W, ws, bias, k1_order=False):
    """The tensor-core route's arithmetic on the CPU, window by window: rows
    padded to 16-row strips and 16-column tiles by reading the last real row,
    logits in base 2 (scale and bias times log2 e, from bf16 operands with
    f32 sums), columns past S at -inf, the row max, the numerators
    exp2(s - max), their f32 sum (in one pass where round16(S) <= 112, else
    online over the tiles, rescaling only the sum), then P = numerator / sum
    rounded to bf16 times v in f32, cast to bf16.  With ``k1_order`` the
    value product takes K1's order instead: the numerators rounded to bf16,
    divided by the sum after the product."""
    from efficient_attention_torch.ops.kernels.eva_packed import _merge, _windows

    gh = qkv.shape[1] // W
    q, k, v = (_windows(t, gh, W, ws, nh).float() for t in qkv.chunk(3, dim=-1))
    S = ws * ws
    SP = -(-S // 16) * 16
    rows = torch.clamp(torch.arange(SP), max=S - 1)
    q, k, v = q[..., rows, :], k[..., rows, :], v[..., rows, :]
    s = torch.einsum("bhgsd,bhgtd->bhgst", q, k) * (scale * _LOG2E)
    b2 = torch.zeros(nh, SP, SP)
    if bias is not None:
        b2[:, :, :S] = _LOG2E * bias.float()[:, rows][:, :, :S]
    s = s + b2[None, :, None]
    s[..., S:] = -torch.inf
    if SP <= 112:
        m = s.amax(-1, keepdim=True)
        x = torch.exp2(s - m)
        den = x.sum(-1, keepdim=True)
    else:
        m = torch.full(s.shape[:-1] + (1,), -torch.inf)
        den = torch.zeros_like(m)
        for t in range(0, SP, 16):
            tile = s[..., t:t + 16]
            mn = torch.maximum(m, tile.amax(-1, keepdim=True))
            den = den * torch.exp2(m - mn) + torch.exp2(tile - mn).sum(-1, keepdim=True)
            m = mn
        x = torch.exp2(s - m)
    if k1_order:
        out = torch.einsum("bhgst,bhgtd->bhgsd", x.bfloat16().float(), v) / den
    else:
        p = (x * (1.0 / den)).bfloat16().float()
        out = torch.einsum("bhgst,bhgtd->bhgsd", p, v)
    return _merge(out[..., :S, :], gh, W, ws).bfloat16()


@pytest.mark.parametrize("ws", [7, 11])
def test_mma_strip_walk_rounds_p_as_the_tpu_kernel(ws):
    """The emulated walk at S = 49 (one pass) and S = 121 (two passes) gives
    the plain version within the card's bf16 limit (2**-7 of the largest
    value, at least 1), and the rounding order is pinned: its mean distance
    from the plain version is at most a quarter of that of the same walk in
    K1's order (numerators rounded, divided after the product)."""
    W, nh, d = 2 * ws, 2, 32
    qkv, bias, _ = map(torch.from_numpy, _inputs(W, ws, nh, d, seed=7))
    qkv = qkv.bfloat16()
    bias = 5 * bias  # 0.5 N(0, 1), as the card checks draw it
    scale = d ** -0.5
    ref = K.local_packed_ref(qkv, scale, nh, W, ws, bias).float()
    walk = _strip_walk(qkv, scale, nh, W, ws, bias).float()
    k1 = _strip_walk(qkv, scale, nh, W, ws, bias, k1_order=True).float()
    assert (walk - ref).abs().max() <= 2 ** -7 * max(1.0, ref.abs().max().item())
    near, far = (walk - ref).abs().mean(), (k1 - ref).abs().mean()
    assert far > 0 and near <= far / 4, (near, far)

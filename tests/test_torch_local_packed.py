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

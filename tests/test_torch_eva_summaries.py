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

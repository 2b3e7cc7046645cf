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

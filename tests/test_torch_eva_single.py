"""K2 ``eva_single`` of the PyTorch port against the JAX package.

The port's plain version (``eva_attention_single_ref``, what the CUDA kernel
is held against on the card) must compute what the TPU kernel computes: it
is compared with ``eva_attention_single(..., interpret=True)`` and with its
pure-XLA twin ``eva_single_twin`` on the same numpy inputs, in float32, to
3e-5 abs / 1e-4 rel (the tolerance of the JAX package's own kernel tests,
``test_pallas.py:838``).  The CUDA kernel itself runs only on a card; it is
held against this plain version in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32, jax_apply, randomize, torch_apply
from efficient_attention_tpu.ops.pallas import eva_single as jax_k2
from efficient_attention_tpu.ops.pallas.eva_packed import (
    MASK_VAL,
    _bias_to_token_coords,
    _strip_maps,
)
from efficient_attention_torch.ops.kernels import eva_single as K

ATOL, RTOL = 3e-5, 1e-4


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def _inputs(seed, B, gh, gw, ws, nh, d, with_bias, use_ln):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    qkv = f(B, gh * gw, 3 * nh * d)
    dense = [0.2 * f(d, d), 0.1 * f(d), 0.2 * f(d, d), 0.1 * f(d)]
    ln = ([1 + 0.1 * f(d), 0.1 * f(d), 1 + 0.1 * f(d), 0.1 * f(d)]
          if use_ln else [None] * 4)
    bias = f(nh, ws * ws, ws * ws) if with_bias else None
    return qkv, dense, ln, bias


def _jax(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.from_numpy(x)


def _port_ref(qkv, dense, ln, bias, nh, gw, ws, j, use_ln):
    d = qkv.shape[-1] // (3 * nh)
    return K.eva_attention_single_ref(
        _torch(qkv), *map(_torch, dense), *map(_torch, ln), d ** -0.5, nh,
        gw, ws, j, use_ln, bias=_torch(bias)).numpy()


def _jax_kernel(qkv, dense, ln, bias, nh, gw, ws, j, use_ln):
    d = qkv.shape[-1] // (3 * nh)
    return np.asarray(jax_k2.eva_attention_single(
        _jax(qkv), *map(_jax, dense), *map(_jax, ln), d ** -0.5, nh, gw, ws,
        j, use_ln, bias=_jax(bias), interpret=True))


@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("gh,gw,ws,j", [(8, 8, 4, 4), (8, 8, 2, 2),
                                        (4, 8, 2, 2)])
def test_plain_matches_jax_kernel(gh, gw, ws, j, with_bias, use_ln):
    nh, d = 3, 16
    qkv, dense, ln, bias = _inputs(gh * 100 + ws * 10 + j, 2, gh, gw, ws,
                                   nh, d, with_bias, use_ln)
    assert K.supports_single(2, gh, gw, ws, j,
                             "default" if use_ln else "no-ln", 3 * nh * d,
                             nh, itemsize=4)
    out = _port_ref(qkv, dense, ln, bias, nh, gw, ws, j, use_ln)
    ref = _jax_kernel(qkv, dense, ln, bias, nh, gw, ws, j, use_ln)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("use_ln", [True, False])
def test_plain_matches_jax_twin(use_ln):
    """The XLA twin takes the TPU kernel's packed operands; build them as
    ``eva_attention_single`` does (``eva_single.py:414-450``)."""
    B, nh, d, gh, gw, ws, j = 2, 3, 16, 8, 8, 4, 4
    hd, N, tgs = nh * d, gh * gw, gw * ws
    C = (gh // j) * (gw // j)
    c8 = jax_k2._round8(C)
    qkv, dense, ln, bias = _inputs(7, B, gh, gw, ws, nh, d, True, use_ln)
    wq, bq, wk, bk = dense
    Rj, mask_add = _strip_maps(gw, ws, tgs)
    cmask = np.where(np.arange(c8) < C, 0.0, MASK_VAL).astype(np.float32)
    add_big = jnp.concatenate(
        [_bias_to_token_coords(jnp.asarray(bias), Rj) + mask_add,
         jnp.broadcast_to(jnp.asarray(cmask), (nh, tgs, c8))], axis=-1)
    P = jnp.asarray(jax_k2._chunk_membership(gh, gw, j, tgs, N // tgs, c8))
    w_big = np.zeros((2, 3 * hd, hd), np.float32)
    for h in range(nh):
        w_big[0, h * d:(h + 1) * d, h * d:(h + 1) * d] = wq
        w_big[1, hd + h * d:hd + (h + 1) * d, h * d:(h + 1) * d] = wk
    tile = lambda v: jnp.asarray(np.tile(v, nh))  # noqa: E731
    ones, zeros = np.ones(d, np.float32), np.zeros(d, np.float32)
    lnq_s, lnq_b, lnk_s, lnk_b = ln if use_ln else (ones, zeros, ones, zeros)
    ref = np.asarray(jax_k2.eva_single_twin(
        jnp.asarray(qkv), P, jnp.asarray(w_big[0]), tile(bq),
        jnp.asarray(w_big[1]), tile(bk), tile(lnq_s), tile(lnq_b),
        tile(lnk_s), tile(lnk_b), add_big, scale=d ** -0.5, nh=nh, j=j,
        use_ln=use_ln))
    out = _port_ref(qkv, dense, ln, bias, nh, gw, ws, j, use_ln)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_large_norm_keys_stay_finite_and_match_eager():
    """Keys far from every chunk's ``mu``: the TPU kernel's data-independent
    shift ``|mu|^2/(2 sqrt(d))`` underflows every member's weight to 0 and
    its clamp then gives ``beta = 0``; the port shifts by the true chunk
    max, stays finite and matches the JAX eager path (``impl='xla'``)."""
    from efficient_attention_tpu import AttentionFactory as JaxFactory
    from efficient_attention_torch import AttentionFactory
    from efficient_attention_torch.interop import load_jax_params

    dim, nh, gh = 32, 2, 8
    args = {"dim": dim, "num_heads": nh, "window_size": 4, "num_landmarks": 4,
            "attn_2d": True, "use_rpe": True, "adaptive_proj": "default"}
    x = np.random.default_rng(3).standard_normal((1, gh, gh, dim)).astype(np.float32)
    jm = JaxFactory.build_attention("eva", dict(args, impl="xla"))
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=4)
    qkv_p = params["params"]["qkv"]
    qkv_p["kernel"][:, dim:2 * dim] *= 40.0  # huge keys
    # zero queries: every logit is its RPE bias, so beta carries real weight
    qkv_p["kernel"][:, :dim] = 0.0
    qkv_p["bias"][:dim] = 0.0
    ref = jax_apply(jm, params, x)
    pm = load_jax_params(AttentionFactory.build_attention("eva", args), params)
    out = torch_apply(pm, x)  # impl='auto' on CPU: the plain K2 version
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)

    # the same qkv through the TPU kernel: beta collapses to 0
    p = params["params"]
    qkv = (x.reshape(1, gh * gh, dim) @ p["qkv"]["kernel"] + p["qkv"]["bias"])
    mq, mk = p["adaptive_mu_q"], p["adaptive_mu_k"]
    dense = [mq["layers_0"]["kernel"], mq["layers_0"]["bias"],
             mk["layers_0"]["kernel"], mk["layers_0"]["bias"]]
    ln = [mq["layers_1"]["scale"], mq["layers_1"]["bias"],
          mk["layers_1"]["scale"], mk["layers_1"]["bias"]]
    bias = pm.window_bias().detach().numpy()
    plain = _port_ref(qkv, dense, ln, bias, nh, gh, 4, 4, True)
    tpu = _jax_kernel(qkv, dense, ln, bias, nh, gh, 4, 4, True)
    assert np.abs(plain - tpu).max() > 1e-2


@pytest.mark.parametrize("case,ok", [
    (dict(), True),
    (dict(itemsize=4), True),
    (dict(adaptive_proj="none"), False),
    (dict(gh=30, gw=30), False),       # window 7 does not divide 30
    (dict(j=3), False),                # chunk 3 does not divide 28
    (dict(three_hd=3 * 3 * 24), False),  # head dim 24: not built
    (dict(gh=56, gw=56, itemsize=4), False),  # block's rows exceed 227 KB
])
def test_gate(case, ok):
    geo = dict(B=128, gh=28, gw=28, ws=7, j=4, adaptive_proj="default",
               three_hd=3 * 192, num_heads=3, itemsize=2)
    geo.update(case)
    assert K.supports_single(**geo) is ok


def test_gate_plan_at_main_shape():
    """DeiT-tiny-p8: 16 windows over clusters of 8 blocks, 2 windows each."""
    cluster, smem = K.plan(128, 3, 28, 28, 7, 4, 64, 2)
    assert cluster == 8
    assert smem == K.smem_bytes(98, 64, 2, 49, 7, 7) <= K.SMEM_LIMIT


def test_cpu_tensor_takes_plain_version():
    qkv, dense, ln, bias = _inputs(11, 2, 8, 8, 4, 3, 16, True, True)
    before = K.LAUNCHES
    out = K.eva_attention_single(
        _torch(qkv), *map(_torch, dense), *map(_torch, ln), 0.25, 3, 8, 4,
        4, True, bias=_torch(bias))
    assert K.LAUNCHES == before
    np.testing.assert_array_equal(
        out.numpy(), _port_ref(qkv, dense, ln, bias, 3, 8, 4, 4, True))


def test_wrapper_rejects_other_devices():
    qkv = torch.empty(2, 64, 144, device="meta")
    w = torch.empty(16, 16, device="meta")
    b = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.eva_attention_single(qkv, w, b, w, b, None, None, None, None,
                               0.25, 3, 8, 4, 4, False)

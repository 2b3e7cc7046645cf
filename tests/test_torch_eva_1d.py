"""The 1-D EVA of the WMT encoder in the PyTorch port, against the JAX
package, on the CPU: K4 ``eva_1d``'s plain version against the
interpret-mode Pallas kernel, and the port's 1-D EVA module (both routes)
against the JAX eager module on the same weights, plus the 1-D windows, T5
buckets and ``LocalAttention`` base they build on.

Tolerances: 3e-5 abs / 1e-4 rel at query rows that are not padding
(``tests/test_pallas.py::TestEva1DKernel``'s); the windows, buckets and
padding exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32, randomize, to_jax
from efficient_attention_tpu.attention import EVA as JaxEVA
from efficient_attention_tpu.attention.local import LocalAttention as JaxLocal
from efficient_attention_tpu.ops import windows as JW
from efficient_attention_tpu.ops.pallas.eva_1d import eva_attention_1d as jax_eva_1d
from efficient_attention_tpu.ops.rpe import t5_bucket_table as jax_t5_buckets
from efficient_attention_torch import AttentionFactory
from efficient_attention_torch.attention.local import LocalAttention
from efficient_attention_torch.interop import load_jax_params
from efficient_attention_torch.ops import windows as W
from efficient_attention_torch.ops.kernels import eva_1d as K4
from efficient_attention_torch.ops.rpe import t5_bucket_table

TOL = dict(atol=3e-5, rtol=1e-4)
# the module geometry: dim 48, 3 heads of 16, window 8 (halo 4), 8 chunks
EVA_ARGS = dict(dim=48, num_heads=3, window_size=8, num_landmarks=8,
                attn_2d=False, overlap_window=True, adaptive_proj="no-ln")


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def _close_at_rows(got, want, lengths):
    """Compare ``[B, N, ...]`` outputs at the rows below each length."""
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL)


@pytest.mark.parametrize("use_pad,bias_kind", [(False, "t5"), (True, "t5"),
                                               (True, "learned")])
def test_eva_1d_plain_matches_the_interpret_mode_kernel(use_pad, bias_kind):
    """K4's plain version against ``eva_attention_1d(interpret=True)`` at
    B=2, N=64, 3 heads of 16, window 8, halo 4, 8 chunks, f32."""
    rng = np.random.default_rng(3)
    B, N, H, d, ws, ext, C = 2, 64, 3, 16, 8, 4, 8
    qkv = rng.standard_normal((B, N, 3 * H * d)).astype(np.float32)
    rf = rng.standard_normal((B, C, H * d)).astype(np.float32)
    beta = rng.standard_normal((B, C, H * d)).astype(np.float32)
    if bias_kind == "t5":
        buckets = jax_t5_buckets(ws, ws + 2 * ext, causal=False, num_buckets=16,
                                 max_distance=ws + ext)
        table = rng.standard_normal((16, H)).astype(np.float32)
        bias = np.transpose(table[buckets], (2, 0, 1)) * d ** -0.5
    else:
        bias = 0.5 * rng.standard_normal((H, ws, ws + 2 * ext)).astype(np.float32)
    lengths = [N, N - 11] if use_pad else [N, N]
    mask = (np.arange(N)[None, :] >= np.asarray(lengths)[:, None]) if use_pad else None
    want = np.asarray(jax_eva_1d(
        jnp.asarray(qkv), jnp.asarray(rf), jnp.asarray(beta),
        None if mask is None else jnp.asarray(mask), d ** -0.5, H, ws, ext,
        bias=jnp.asarray(bias), n_orig=N, interpret=True))
    got = K4.eva_attention_1d(
        torch.from_numpy(qkv), torch.from_numpy(rf), torch.from_numpy(beta),
        None if mask is None else torch.from_numpy(mask), d ** -0.5, H, ws, ext,
        bias=torch.from_numpy(bias)).numpy()
    _close_at_rows(got, want, lengths)


def _eva_pair(seed=0, N=60, **kw):
    """The JAX eager module with numpy-drawn params and the port's module
    carrying them (strict load); an input ``[2, N, 48]``."""
    args = {**EVA_ARGS, **kw}
    jm = JaxEVA(impl="xla", **args)
    x = np.random.default_rng(seed).standard_normal((2, N, 48)).astype(np.float32)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed + 1)
    tm = load_jax_params(AttentionFactory.build_attention("eva", args), params)
    return jm, params, tm.eval(), x


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("kw", [dict(use_t5_rpe=True), dict(use_rpe=True)])
def test_eva_1d_module_matches_jax_eager(impl, kw):
    """Eval, overlap, ``no-ln``, a padding mask and a length (60) that is not
    a multiple of the window: the K4 route (plain version on the CPU) and
    the eager route against JAX's eager module."""
    jm, params, tm, x = _eva_pair(**kw)
    lengths = [60, 45]
    mask = np.arange(60)[None, :] >= np.asarray(lengths)[:, None]
    want = np.asarray(jm.apply(to_jax(params), jnp.asarray(x),
                               key_padding_mask=jnp.asarray(mask)))
    tm.impl = impl
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert got.shape == (2, 60, 48)
    _close_at_rows(got, want, lengths)


def test_eva_1d_module_without_mask_or_halo_matches_jax():
    """No padding mask and no halo: JAX's natural-layout summaries."""
    jm, params, tm, x = _eva_pair(seed=4, N=64, overlap_window=False,
                                  use_t5_rpe=True)
    want = np.asarray(jm.apply(to_jax(params), jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_eval_ignores_attention_dropout():
    """At eval, attn_drop=0.1 takes K4 and gives what attn_drop=0 gives (the
    JAX gate's ``attn_drop == 0`` test keeps the WMT recipe off its kernel)."""
    _, _, tm, x = _eva_pair(use_t5_rpe=True)
    drop = AttentionFactory.build_attention(
        "eva", dict(EVA_ARGS, use_t5_rpe=True, attn_drop=0.1)).eval()
    drop.load_state_dict(tm.state_dict())
    mask = torch.from_numpy(np.arange(60)[None, :] >= np.array([[60], [45]]))
    before = K4.LAUNCHES
    with torch.no_grad():
        a, b = tm(torch.from_numpy(x), mask), drop(torch.from_numpy(x), mask)
    assert torch.equal(a, b)
    assert K4.LAUNCHES == before  # CPU tensors: the plain version


def test_cpu_route_is_the_plain_version(monkeypatch):
    calls = []
    real = K4.eva_1d_ref
    monkeypatch.setattr(K4, "eva_1d_ref", lambda *a, **k: calls.append(1) or real(*a, **k))
    _, _, tm, x = _eva_pair(use_t5_rpe=True)
    with torch.no_grad():
        tm(torch.from_numpy(x))
        assert len(calls) == 1
        tm.impl = "xla"
        tm(torch.from_numpy(x))
    assert len(calls) == 1


def test_packed_raises_where_the_gate_fails():
    _, _, tm, x = _eva_pair(use_t5_rpe=True)
    tm.impl = "packed"
    with torch.no_grad():
        tm(torch.from_numpy(x))  # eval, within the gate
        with pytest.raises(ValueError, match="impl='packed'"):
            tm.train()(torch.from_numpy(x))  # the kernel serves eval only
    odd = AttentionFactory.build_attention(
        "eva", dict(EVA_ARGS, dim=72, use_t5_rpe=True, impl="packed")).eval()
    with torch.no_grad(), pytest.raises(ValueError, match="supports_1d"):
        odd(torch.zeros(1, 16, 72))  # head dim 24: not built
    with pytest.raises(RuntimeError, match="no backward"):
        K4.eva_attention_1d(torch.zeros(1, 8, 48, requires_grad=True),
                            torch.zeros(1, 2, 16), torch.zeros(1, 2, 16), None,
                            0.25, 1, 8, 4)


@pytest.mark.parametrize("ext,pad_val", [(0, 0.0), (2, 0.0), (4, 1.0)])
def test_window_1d_partition_matches_jax(ext, pad_val):
    x = np.random.default_rng(0).standard_normal((2, 3, 24, 5)).astype(np.float32)
    want = np.asarray(JW.window_1d_partition(jnp.asarray(x), 8, ext, pad_val))
    got = W.window_1d_partition(torch.from_numpy(x), 8, ext, pad_val).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ws,ext", [(8, 4), (4, 2), (32, 16)])
def test_bidirectional_t5_buckets_match_jax(ws, ext):
    """``causal=False`` buckets of a halo'd window, as EVA builds them."""
    nb = max(min((ws + ext) // 2, 64), 16)
    args = (ws, ws + 2 * ext)
    kw = dict(causal=False, num_buckets=nb, max_distance=ws + ext)
    got = t5_bucket_table(*args, **kw)
    np.testing.assert_array_equal(got, jax_t5_buckets(*args, **kw))
    # keys before the query and after it fall in different halves
    rel = np.arange(ws + 2 * ext)[None, :] - np.arange(ws)[:, None]
    assert (got[rel > 0] >= nb // 2).all() and (got[rel < 0] < nb // 2).all()


def test_local_attention_1d_base_matches_jax():
    """The halo of ``overlap_window``, the 1-D learned table and the padding
    of a sequence to a window multiple (``_process_input``); the 1-D local
    forward itself is not ported yet."""
    m = LocalAttention(48, 3, window_size=8, attn_2d=False, overlap_window=True,
                       use_rpe=True)
    assert m.ext_size == 4
    assert tuple(m.local_relative_position_bias_table.shape) == (3, 8, 16)
    jm = JaxLocal(dim=48, num_heads=3, window_size=8, attn_2d=False,
                  overlap_window=True)
    x = np.random.default_rng(1).standard_normal((2, 21, 48)).astype(np.float32)
    for mask in (None, np.arange(21)[None, :] >= np.array([[21], [17]])):
        jx, jmask, jshape = jm.apply({}, jnp.asarray(x),
                                     None if mask is None else jnp.asarray(mask),
                                     method=JaxLocal._process_input)
        tx, tmask, tshape = m._process_input(
            torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
        assert tshape == tuple(jshape) == (24,)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        m(torch.from_numpy(x))

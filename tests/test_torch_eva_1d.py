"""The 1-D EVA of the WMT encoder in the PyTorch port, against the JAX
package, on the CPU: K4 ``eva_1d``'s plain version against the
interpret-mode Pallas kernel, and the port's 1-D EVA module (both routes)
against the JAX eager module on the same weights, plus the 1-D windows, T5
buckets and ``LocalAttention`` base they build on.

Also the f32 route's strip walk (``eva_1d_strip_ref``: 16-row strips over
the union of their windows' columns, groups of 32 columns under a running
max) against both, and the route's plan, layout, gate and item walk, the
Python halves of what the card runs (its checks there are
``test_torch_cuda.py``'s).

Tolerances: 3e-5 abs / 1e-4 rel at query rows that are not padding
(``tests/test_pallas.py::TestEva1DKernel``'s); the windows, buckets,
padding, layouts and walks exactly.
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


@pytest.mark.parametrize("use_pad", [False, True])
@pytest.mark.parametrize("ext", [0, 4])
@pytest.mark.parametrize("ws", [4, 8, 16])
def test_strip_walk_matches_plain_and_interpret_mode_kernel(ws, ext, use_pad):
    """The f32 route's walk emulated in f32 tensor ops against K4's plain
    version and the interpret-mode Pallas kernel: B=2, 2 heads of 16, C=5,
    N=40 (the last 16-row strip ragged; at ws=16, N=48, the next multiple of
    the window), strips that hold 4, 2 or 1 windows (with the other
    windows' columns weighing nothing) and, with a mask, one sentence of
    N - 11 tokens."""
    rng = np.random.default_rng(11)
    B, H, d, C = 2, 2, 16, 5
    N = 48 if ws == 16 else 40
    qkv = rng.standard_normal((B, N, 3 * H * d)).astype(np.float32)
    rf = rng.standard_normal((B, C, H * d)).astype(np.float32)
    beta = rng.standard_normal((B, C, H * d)).astype(np.float32)
    bias = 0.5 * rng.standard_normal((H, ws, ws + 2 * ext)).astype(np.float32)
    lengths = [N, N - 11] if use_pad else [N, N]
    mask = np.arange(N)[None, :] >= np.asarray(lengths)[:, None] if use_pad else None
    want = np.asarray(jax_eva_1d(
        jnp.asarray(qkv), jnp.asarray(rf), jnp.asarray(beta),
        None if mask is None else jnp.asarray(mask), d ** -0.5, H, ws, ext,
        bias=jnp.asarray(bias), n_orig=N, interpret=True))
    args = (torch.from_numpy(qkv), torch.from_numpy(rf), torch.from_numpy(beta),
            None if mask is None else torch.from_numpy(mask), d ** -0.5, H, ws, ext,
            torch.from_numpy(bias))
    got = K4.eva_1d_strip_ref(*args).numpy()
    _close_at_rows(got, want, lengths)
    _close_at_rows(got, K4.eva_1d_ref(*args).numpy(), lengths)


def test_strip_walk_takes_windows_that_straddle_strips_and_many_columns():
    """A window of 24 (strips hold parts of two windows), a halo of 20 and
    C=13: strips of 88 local columns and 16 chunk columns, four groups
    under the running max, against the plain version."""
    rng = np.random.default_rng(12)
    B, H, d, N, ws, ext, C = 2, 2, 32, 72, 24, 20, 13
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    mask = torch.from_numpy(np.arange(N)[None, :] >= np.array([[N], [50]]))
    args = (t(B, N, 3 * H * d), t(B, C, H * d), t(B, C, H * d), mask, d ** -0.5, H,
            ws, ext, 0.5 * t(H, ws, ws + 2 * ext))
    _close_at_rows(K4.eva_1d_strip_ref(*args).numpy(), K4.eva_1d_ref(*args).numpy(),
                   [N, 50])


# ---- the f32 route's plan, layout, gate and item walk ----

@pytest.mark.parametrize("name,geo,want", [
    ("recipe", (64, 32, 8, 4, 8, 8, 64), 32),
    ("long", (16, 256, 8, 4, 8, 8, 64), 64),
    ("small", (3, 40, 8, 4, 5, 3, 16), 48),
    ("one token", (1, 8, 8, 4, 1, 1, 32), 16),
    ("head dim 128, window 16", (4, 64, 16, 8, 8, 4, 128), 64),
    ("window 128, halo 64", (2, 256, 128, 64, 8, 4, 64), 64),
    ("window 512, halo 256", (1, 512, 512, 256, 8, 2, 64), None),  # no block fits
    ("bf16", (64, 32, 8, 4, 8, 8, 64, 2), None),
    ("head dim 48", (64, 32, 8, 4, 8, 8, 48), None),
    ("head dim 24", (2, 32, 8, 4, 8, 2, 24), None),
    ("N not a multiple of the window", (2, 36, 8, 4, 8, 2, 64), None),
    ("no chunk", (2, 32, 8, 4, 0, 2, 64), None),
])
def test_tf32_plan_choices(name, geo, want):
    """The f32 route's query rows an item at the check script's shapes and
    elsewhere: the first of TF32_ROWS, cut to the sentence, whose block
    fits, or None, where the launch takes the CUDA-core kernel."""
    got = K4.plan(*geo) if len(geo) == 8 else K4.plan(*geo, 4)
    assert (None if got is None else got.rows) == want, name
    if got is not None:
        B, N, ws, ext, C, nh, d = geo[:7]
        assert got.smem == K4.tf32_smem_bytes(d, ws, ext, C, got.rows)
        assert K4.tf32_config_ok(d, ws, ext, C, got.rows)
        assert got.warps == got.rows // 16 and got.rows <= -(-N // 16) * 16


def test_tf32_smem_bytes_region_by_region():
    """A block's bytes, region by region (each 128-byte aligned): q rows at
    D + 16 floats (D + 32 at head dim 16), key and value rows at D + 16 and
    D + 4 (the item's halo'd windows plus 7, in rows of 8), chunk keys and
    values (C in rows of 8) and a float of key mask a key row."""
    # the recipe: 32 rows, 4 windows of 8 with halos of 4: 47 -> 48 key rows
    assert K4.tf32_key_rows(32, 8, 4) == 48
    assert K4.tf32_smem_bytes(64, 8, 4, 8, 32) == (
        32 * 80 * 4 + 48 * 80 * 4 + 48 * 68 * 4 + 8 * 80 * 4 + 8 * 68 * 4 + 256) == 43648
    # the long shape: 64 rows, 8 windows: 64 + 8 + 7 -> 80 key rows
    assert K4.tf32_key_rows(64, 8, 4) == 80
    assert K4.tf32_smem_bytes(64, 8, 4, 8, 64) == (
        64 * 80 * 4 + 80 * 80 * 4 + 80 * 68 * 4 + 8 * 80 * 4 + 8 * 68 * 4 + 384)
    # head dim 16, C = 5: rows of 48 and 20 floats, chunk rows rounded up to 8,
    # regions rounded up to 128 bytes
    assert K4.tf32_smem_bytes(16, 8, 4, 5, 48) == (
        48 * 48 * 4 + 64 * 48 * 4 + 64 * 20 * 4 + 8 * 48 * 4 + 8 * 20 * 4 + 256) == 29056
    # head dim 128, window 16, halo 8: one window a 16-row run
    assert K4.tf32_key_rows(16, 16, 8) == 40
    assert K4.tf32_smem_bytes(128, 16, 8, 8, 16) == (
        16 * 144 * 4 + 40 * 144 * 4 + 40 * 132 * 4 + 8 * 144 * 4 + 8 * 132 * 4 + 256)
    # a window of 24 that 32-row runs straddle: up to 3 windows, 72 + 10 + 7
    assert K4.tf32_key_rows(32, 24, 5) == 96
    # a window of 128 that holds whole 16-row runs
    assert K4.tf32_key_rows(16, 128, 64) == 264
    # the region of 47 floats of key mask rounds up to 256 bytes
    assert K4.tf32_smem_bytes(32, 4, 0, 6, 16) == (
        16 * 48 * 4 + 24 * 48 * 4 + 24 * 36 * 4 + 8 * 48 * 4 + 8 * 36 * 4 + 128)


@pytest.mark.parametrize("args,ok", [
    ((64, 8, 4, 8, 32), True),
    ((16, 8, 4, 5, 48), True),
    ((128, 16, 8, 8, 64), True),
    ((32, 24, 5, 9, 32), True),
    ((64, 8, 4, 8, 16), True),
    ((64, 8, 4, 8, 128), True),
    ((48, 8, 4, 8, 32), False),    # head dim 48
    ((64, 0, 4, 8, 32), False),    # no window
    ((64, 8, -1, 8, 32), False),   # a negative halo
    ((64, 8, 4, 0, 32), False),    # no chunk
    ((64, 8, 4, 8, 0), False),     # no rows
    ((64, 8, 4, 8, 40), False),    # rows not a multiple of 16
    ((64, 8, 4, 8, 144), False),   # more than 128 rows
    ((128, 16, 8, 8, 128), False),  # a 128-row block at head dim 128
])
def test_tf32_config_ok(args, ok):
    assert K4.tf32_config_ok(*args) == ok


@pytest.mark.parametrize("B,N,nh,rows", [(1, 32, 8, 32), (7, 40, 3, 16), (3, 256, 2, 64),
                                         (2, 72, 5, 48)])
def test_tf32_walk_covers_every_item_once(B, N, nh, rows):
    """The blocks take every (sentence, head, run of rows) exactly once, and
    the heads of one run are consecutive blocks."""
    runs = -(-N // rows)
    want = sorted((b, h, r * rows) for b in range(B) for h in range(nh) for r in range(runs))
    walk = list(K4.tf32_walk(B, N, nh, rows))
    assert len(walk) == B * nh * runs
    assert sorted(walk) == want
    order = [(b, r0, h) for b, h, r0 in walk]
    assert order == sorted(order)


def test_route_config_forces_and_refuses_layouts():
    """``config`` None takes ``plan``'s item size, 0 the CUDA-core kernel,
    an int f32-route items of that many query rows, which must fit; bf16 has
    no f32 route."""
    geo = (64, 32, 8, 4, 8, 8, 64, 4)
    assert K4.route_config(*geo) == K4.plan(*geo)
    assert K4.route_config(*geo, config=0) is None
    forced = K4.route_config(*geo, config=64)
    assert forced == (64, K4.tf32_smem_bytes(64, 8, 4, 8, 64)) and forced.warps == 4
    for bad in (24,     # rows not a multiple of 16
                144,    # more than 128 rows
                -16):
        with pytest.raises(ValueError, match="do not fit"):
            K4.route_config(*geo, config=bad)
    with pytest.raises(ValueError, match="do not fit"):  # 245 KB at head dim 128
        K4.route_config(4, 128, 16, 8, 8, 4, 128, 4, config=128)
    assert K4.route_config(64, 32, 8, 4, 8, 8, 64, 2) is None
    with pytest.raises(ValueError, match="do not fit"):
        K4.route_config(64, 32, 8, 4, 8, 8, 64, 2, config=32)


def test_supports_1d_takes_either_kernel():
    """The module's gate holds where either kernel takes the geometry: the
    f32 route alone at a window the CUDA-core kernel's block cannot hold,
    the CUDA-core kernel alone in bf16, neither at head dim 24."""
    assert K4.wpb_plan(2, 256, 128, 64, 8, 4, 64, 4) is None
    assert K4.plan(2, 256, 128, 64, 8, 4, 64, 4) is not None
    assert K4.supports_1d(2, 256, 128, 64, 8, 4, 64, 4)
    assert K4.plan(64, 32, 8, 4, 8, 8, 64, 2) is None
    assert K4.supports_1d(64, 32, 8, 4, 8, 8, 64, 2)
    assert not K4.supports_1d(2, 32, 8, 4, 8, 2, 24, 4)


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
    of a sequence to a window multiple (``_process_input``); then the 1-D
    local forward itself, on JAX's weights, with and without a mask."""
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
    jm = JaxLocal(dim=48, num_heads=3, window_size=8, attn_2d=False,
                  overlap_window=True, use_rpe=True)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=3)
    load_jax_params(m, params)
    for mask in (None, np.arange(21)[None, :] >= np.array([[21], [17]])):
        want = jm.apply(params, jnp.asarray(x),
                        None if mask is None else jnp.asarray(mask))
        with torch.no_grad():
            got = m.eval()(torch.from_numpy(x),
                           None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)

"""K2 ``eva_single`` of the PyTorch port against the JAX package.

The port's plain version (``eva_attention_single_ref``, what the CUDA kernel
is held against on the card) must compute what the TPU kernel computes: it
is compared with ``eva_attention_single(..., interpret=True)`` and with its
pure-XLA twin ``eva_single_twin`` on the same numpy inputs, in float32, to
3e-5 abs / 1e-4 rel (the tolerance of the JAX package's own kernel tests,
``test_pallas.py:838``), and in bfloat16 to the card's K2 limit.  The CUDA
kernel itself runs only on a card; it is held against this plain version in
``test_torch_cuda.py``.  Here the tensor-core route's gate and layout, and
its arithmetic emulated on the CPU (``-k mma``), are pinned before any chip
time.
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
    """DeiT-tiny-p8: 16 windows over clusters of 8 blocks, 2 windows each;
    bf16 on the tensor-core kernel's layout, f32 on the CUDA-core one's."""
    cluster, smem, mma = K.plan(128, 3, 28, 28, 7, 4, 64, 2)
    assert cluster == 8 and mma
    assert smem == K.mma_smem_bytes(28, 28, 7, 4, 64, 8) <= K.SMEM_LIMIT
    cluster, smem, mma = K.plan(128, 3, 28, 28, 7, 4, 64, 4)
    assert cluster == 8 and not mma
    assert smem == K.smem_bytes(98, 64, 4, 49, 7, 7) <= K.SMEM_LIMIT


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


# the card's limit for K2 in bf16 (chip_smoke.py TOL): one rounding of
# outputs below 4, whose bf16 spacing is at most 2**-6
BF16_TOL = 2 ** -6


def test_bf16_plain_version_rounds_like_the_tpu_kernel():
    """In bf16, rf_k and beta meet the queries and numerators rounded to
    bf16 (``rfh.astype(kh.dtype)``), the numerators exp(l - max) are rounded
    at the final row max (``p.astype(vals.dtype)``) and the denominator is
    the f32 sum of the unrounded ones; f32 keeps the softmax form."""
    nh, d, gw, ws, j = 2, 16, 8, 4, 4
    qkv, dense, ln, bias = _inputs(5, 1, 8, 8, ws, nh, d, True, True)
    lo = _torch(qkv).bfloat16()
    args = (*map(_torch, dense), *map(_torch, ln), d ** -0.5, nh, gw, ws, j, True)
    out = K.eva_attention_single_ref(lo, *args, bias=_torch(bias))
    assert out.dtype == torch.bfloat16
    # by hand: the f32 summaries of the bf16 inputs, windows 0..3
    f = K.eva_attention_single_ref  # the f32 branch gives rf_k and beta below
    q, k, v = lo.float().reshape(1, 8, 8, 3, nh, d).unbind(3)
    chunk = lambda t: t.reshape(1, 2, 4, 2, 4, nh, d).permute(  # noqa: E731
        0, 1, 3, 5, 2, 4, 6).reshape(1, 4, nh, 16, d)
    wq, bq, wk, bk = map(_torch, dense)
    lq, lqb, lk, lkb = map(_torch, ln)
    ln_ = torch.nn.functional.layer_norm
    rf_q = ln_(chunk(q).mean(-2) @ wq + bq, (d,), lq, lqb, 1e-6)
    rf_k = ln_(chunk(k).mean(-2) @ wk + bk, (d,), lk, lkb, 1e-6)
    mu = 0.5 * (rf_q + rf_k)
    kc = chunk(k)
    logp = (d ** -0.5 * (kc * mu.unsqueeze(-2)).sum(-1)
            - 0.5 * d ** -0.5 * kc.square().sum(-1))
    beta = (torch.softmax(logp, -1).unsqueeze(-1) * chunk(v)).sum(-2)
    win = lambda t: t.reshape(1, 2, 4, 2, 4, nh, d).permute(  # noqa: E731
        0, 5, 1, 3, 2, 4, 6).reshape(1, nh, 4, 16, d)
    rf_b = rf_k.bfloat16().float().transpose(1, 2)     # [1, nh, 4, d]
    beta_b = beta.bfloat16().float().transpose(1, 2)
    logits = torch.cat([
        torch.einsum("bhgsd,bhgtd->bhgst", win(q), win(k)) * d ** -0.5
        + _torch(bias)[None, :, None],
        torch.einsum("bhgsd,bhcd->bhgsc", win(q), rf_b) * d ** -0.5], -1)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    merge = lambda o: o.reshape(1, nh, 2, 2, 4, 4, d).permute(  # noqa: E731
        0, 2, 4, 3, 5, 1, 6).reshape(1, 64, nh * d)

    def product(x):  # x [v | beta] over the f32 sum of the unrounded p
        return merge((torch.einsum("bhgst,bhgtd->bhgsd", x[..., :16], win(v))
                      + torch.einsum("bhgsc,bhcd->bhgsd", x[..., 16:], beta_b))
                     / p.sum(-1, keepdim=True))

    torch.testing.assert_close(out, product(p.bfloat16().float()).bfloat16(),
                               atol=0, rtol=0)
    unrounded = product(p)
    assert not torch.equal(out, unrounded.bfloat16())
    # f32: the normalised softmax times the unrounded summaries, as before
    f32 = f(lo.float(), *args, bias=_torch(bias))
    assert not torch.equal(f32.bfloat16(), out)


def test_bf16_plain_version_matches_jax_kernel():
    """The bf16 plain version against the interpret-mode TPU kernel in bf16
    on the same numpy inputs, within the card's K2 limit (2**-6 abs): they
    differ in the TPU kernel's bf16 operands of phase 1 (mu and the member
    weights rounded before their products) and in the order of sums."""
    nh, d, gw, ws, j = 2, 16, 8, 4, 4
    qkv, dense, ln, bias = _inputs(17, 1, 8, 8, ws, nh, d, True, True)
    qkv = np.array(jnp.asarray(qkv, jnp.bfloat16).astype(jnp.float32))
    out = K.eva_attention_single_ref(
        _torch(qkv).bfloat16(), *map(_torch, dense), *map(_torch, ln),
        d ** -0.5, nh, gw, ws, j, True, bias=_torch(bias)).float().numpy()
    ref = np.asarray(jax_k2.eva_attention_single(
        jnp.asarray(qkv, jnp.bfloat16), *map(_jax, dense), *map(_jax, ln),
        d ** -0.5, nh, gw, ws, j, True, bias=_jax(bias),
        interpret=True)).astype(np.float32)
    np.testing.assert_allclose(out, ref, atol=BF16_TOL, rtol=0)


@pytest.mark.parametrize("d,itemsize,mma", [
    (16, 2, True), (32, 2, True), (64, 2, True),
    (12, 2, False), (64, 4, False), (16, 4, False)])
def test_mma_route_gate(d, itemsize, mma):
    """bf16 at head dims 16, 32 and 64 takes the tensor-core kernel; f32 and
    head dim 12 keep the CUDA-core kernel (``uses_mma``, twin of the C
    export ``eva_single_uses_mma``)."""
    assert K.uses_mma(d, itemsize) is mma
    assert K.plan(2, 2, 8, 8, 4, 4, d, itemsize)[2] is mma
    assert K.plan(2, 2, 8, 8, 4, 4, d, itemsize, cuda_cores=True)[2] is False


def test_mma_smem_layout_counts_each_region():
    """The tensor-core kernel's layout twin at the headline (cluster 8, two
    windows of 49 a block, 49 chunks, at most 8 owned by a block): q, k, v
    rows [98][72] and the chunk rows [49][72] twice in bf16; the bias
    [49][49] in f32; the token table [98] and owned chunks [8] in int32;
    their members [8][16] in uint16; their means [8][2][64], mu and rf_k
    [8][64] each and the warps' member weights [4][2][16] in f32; each
    region 128-byte aligned.  Three blocks an SM (Hopper: 228 KB an SM, 1 KB
    of it reserved a block)."""
    a128 = lambda n: -(-n // 128) * 128  # noqa: E731
    assert K.owned_chunks(8, 2, 4, 7, 4) == 8
    want = (3 * a128(98 * 72 * 2) + 2 * a128(49 * 72 * 2) + a128(49 * 49 * 4)
            + a128(98 * 4) + a128(8 * 4) + a128(8 * 16 * 2) + a128(8 * 2 * 64 * 4)
            + 2 * a128(8 * 64 * 4) + a128(4 * 2 * 16 * 4))
    assert K.mma_smem_bytes(28, 28, 7, 4, 64, 8) == want == 76288
    assert 3 * (want + 1024) <= 233472


def _owners(gh, gw, ws, j, cluster):
    """The block of each chunk's first token (its owner on the tensor-core
    route), by chunk."""
    nww, wpb = gw // ws, (gh // ws) * (gw // ws) // cluster
    return [((cy * j // ws) * nww + cx * j // ws) // wpb
            for cy in range(gh // j) for cx in range(gw // j)]


def test_chunks_are_owned_by_their_first_tokens_block():
    """Each chunk has one owner, the block that holds its first token; the
    most a block owns is ``owned_chunks``, the layout's count."""
    for gh, gw, ws, j, cs in ((28, 28, 7, 4, 8), (56, 56, 7, 8, 16), (14, 14, 7, 2, 2),
                              (12, 12, 3, 4, 8), (12, 16, 4, 2, 4), (21, 28, 7, 7, 4)):
        owners = _owners(gh, gw, ws, j, cs)
        counts = [owners.count(r) for r in range(cs)]
        wpb = (gh // ws) * (gw // ws) // cs
        assert max(counts) == K.owned_chunks(cs, wpb, gw // ws, ws, j), (gh, gw, ws, j, cs)
        assert sum(counts) == (gh // j) * (gw // j)


# the geometries of the repo's models: DeiT-tiny-p8 (28x28, j 4, heads of
# 64), PVT-B3's three EVA stages (heads of 32), DeiT-tiny-p16 (14x14, j 2)
MODEL_GEOMETRIES = ((3, 28, 7, 4, 64), (2, 56, 7, 8, 32), (4, 28, 7, 4, 32),
                    (10, 14, 7, 2, 32), (3, 14, 7, 2, 64))


def test_mma_plan_admits_every_geometry_the_old_layout_did():
    """Every geometry the CUDA-core layout admits is still admitted, the
    bf16 ones at head dims 16/32/64 on the tensor-core kernel wherever its
    padded rows fit: the models' geometries and the tests' among them."""
    for nh, g, ws, j, d in MODEL_GEOMETRIES:
        assert K.plan(128, nh, g, g, ws, j, d, 2)[2], (g, j, d)
    for g, ws, j, d in ((8, 4, 4, 16), (28, 7, 4, 64), (12, 3, 4, 16), (8, 4, 2, 16)):
        assert K.plan(2, 3, g, g, ws, j, d, 2)[2]
    admitted, fallbacks = 0, []
    for d in (12, 16, 32, 64):
        for ws in range(2, 9):
            for nw in range(1, 9):
                g = ws * nw
                for j in (c for c in range(1, g + 1) if g % c == 0 and c <= 8):
                    for itemsize in (2, 4):
                        n_win, chunks = nw * nw, (g // j) ** 2
                        cs = next(c for c in K.CLUSTER_SIZES if n_win % c == 0)
                        old = K.smem_bytes(n_win // cs * ws * ws, d, itemsize, chunks,
                                           -(-chunks // cs), ws) <= K.SMEM_LIMIT
                        got = K.plan(2, 2, g, g, ws, j, d, itemsize)
                        assert (got is not None) == old, (g, ws, j, d, itemsize)
                        if got is None or not K.uses_mma(d, itemsize):
                            continue
                        admitted += 1
                        if not got[2]:  # the padded rows do not fit a block
                            assert K.mma_smem_bytes(g, g, ws, j, d, cs) > K.SMEM_LIMIT
                            fallbacks.append(n_win // cs * ws * ws)
    # those hold 144 or more tokens a block (one block an image and head, or
    # one-token chunks)
    assert min(fallbacks) >= 144 and len(fallbacks) <= admitted // 20, (fallbacks, admitted)


def test_mma_plan_picks_the_measured_cluster_at_the_models_shapes():
    """At B=128 plan() picks, at each model's shape, the cluster size that
    ran fastest on the H100 (scripts/torch_eva_single_phases.py, PERF.md):
    the headline 8 (two windows a block, three blocks an SM), PVT-B3's
    stages 16, 4 and 2, and DeiT-tiny-p16 2 (two windows a block at two
    blocks an SM, not one window at three).  The answer is cached, so the
    gate and the launch of every block compute it once."""
    for (nh, g, ws, j, d), cs in zip(MODEL_GEOMETRIES, (8, 16, 4, 2, 2)):
        cluster, smem, mma = K.plan(128, nh, g, g, ws, j, d, 2)
        assert (cluster, mma) == (cs, True), (g, j, d)
        assert smem == K.mma_smem_bytes(g, g, ws, j, d, cs)
        assert (g // ws) ** 2 // cs >= 2
    hits = K.plan.cache_info().hits
    assert K.supports_single(128, 28, 28, 7, 4, "default", 3 * 3 * 64, 3)
    assert K.plan.cache_info().hits == hits + 1


_LOG2E = 1.4426950408889634


def _emulate_mma_route(qkv, dense, ln, bias, nh, gw, ws, j, use_ln, cluster):
    """The tensor-core route's arithmetic on the CPU, block by block of a
    cluster.  Each block stages its windows' q, k, v rows by slot (window
    order); a chunk's owner (the block of its first token) gathers its
    members' rows from the blocks that hold them, by (rank, slot), and forms
    in f32 the q and k sums in member order, the means, the Dense (+LN), mu,
    the members' logits, their true maximum, exp and sum, and beta.  Phase 2
    window by window as 16-row strips reading the last real row, base-2
    logits over [k | rf_k] padded to 16 columns by the last real row (-inf
    past S + C), rf_k and beta rounded to bf16, the numerators exp2(s - max)
    rounded to bf16 for the value product, the f32 sum of the unrounded
    ones, out / sum rounded to bf16."""
    B, N, three_hd = qkv.shape
    d = three_hd // (3 * nh)
    gh = N // gw
    nww, wc = gw // ws, gw // j
    n_win, C, S = (gh // ws) * nww, (gh // j) * wc, ws * ws
    wpb = n_win // cluster
    q, k, v = qkv.float().reshape(B, N, 3, nh, d).unbind(2)   # [B, N, nh, d]

    def slot_token(rank, slot):
        w, l = rank * wpb + slot // S, slot % S
        return ((w // nww) * ws + l // ws) * gw + (w % nww) * ws + l % ws

    # each block's staged rows, by slot
    staged = [torch.tensor([slot_token(r, t) for t in range(wpb * S)])
              for r in range(cluster)]
    rows = [(q[:, tk], k[:, tk], v[:, tk]) for tk in staged]
    owners = _owners(gh, gw, ws, j, cluster)
    wq, bq, wk, bk = map(_torch, dense)
    dn = d ** -0.5
    rf_k = torch.zeros(B, C, nh, d)
    beta = torch.zeros(B, C, nh, d)
    for c in range(C):
        cy, cx = divmod(c, wc)
        members = []
        for m in range(j * j):
            y, x = cy * j + m // j, cx * j + m % j
            w = (y // ws) * nww + x // ws
            members.append((w // wpb, (w % wpb) * S + (y % ws) * ws + x % ws))
        assert members[0][0] == owners[c]
        mq = torch.stack([rows[r][0][:, t] for r, t in members], 1)  # [B, jj, nh, d]
        mk = torch.stack([rows[r][1][:, t] for r, t in members], 1)
        mv = torch.stack([rows[r][2][:, t] for r, t in members], 1)
        rq, rk = mq.mean(1) @ wq + bq, mk.mean(1) @ wk + bk
        if use_ln:
            lq, lqb, lk, lkb = map(_torch, ln)
            rq = torch.nn.functional.layer_norm(rq, (d,), lq, lqb, 1e-6)
            rk = torch.nn.functional.layer_norm(rk, (d,), lk, lkb, 1e-6)
        mu = 0.5 * (rq + rk)
        lg = dn * (mk * mu[:, None]).sum(-1) - 0.5 * dn * mk.square().sum(-1)
        e = torch.exp(lg - lg.amax(1, keepdim=True))                # true max
        beta[:, c] = (e[..., None] * mv).sum(1) / e.sum(1)[..., None]
        rf_k[:, c] = rk
    rf_b = rf_k.bfloat16().float().permute(0, 2, 1, 3)   # [B, nh, C, d]
    beta_b = beta.bfloat16().float().permute(0, 2, 1, 3)
    gwh, gww = gh // ws, gw // ws

    def windows(t):  # [B, N, nh, d] -> [B, nh, G, S, d]
        return (t.reshape(B, gwh, ws, gww, ws, nh, d)
                .permute(0, 5, 1, 3, 2, 4, 6).reshape(B, nh, -1, S, d))

    SP, KP = -(-S // 16) * 16, -(-(S + C) // 16) * 16
    rws = torch.clamp(torch.arange(SP), max=S - 1)
    cols = torch.clamp(torch.arange(KP), max=S + C - 1)
    G = gwh * gww
    wqs = windows(q)[..., rws, :]
    keys = torch.cat([windows(k), rf_b[:, :, None].expand(-1, -1, G, -1, -1)], 3)[..., cols, :]
    vals = torch.cat([windows(v), beta_b[:, :, None].expand(-1, -1, G, -1, -1)], 3)[..., cols, :]
    s = torch.einsum("bhgsd,bhgtd->bhgst", wqs, keys) * (dn * _LOG2E)
    if bias is not None:
        s[..., :S] += _LOG2E * _torch(bias)[:, rws][None, :, None]
    s[..., S + C:] = -torch.inf
    xn = torch.exp2(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhgst,bhgtd->bhgsd", xn.bfloat16().float(), vals) / xn.sum(-1, keepdim=True)
    out = out[..., :S, :].bfloat16()
    return (out.reshape(B, nh, gwh, gww, ws, ws, d).permute(0, 2, 4, 3, 5, 1, 6)
            .reshape(B, N, nh * d))


@pytest.mark.parametrize("large_keys", [False, True])
def test_mma_route_emulated_matches_plain(large_keys):
    """The emulated tensor-core route against the bf16 plain version within
    the card's limit (2**-6 abs) where chunks straddle blocks: a 12x12 grid,
    windows 3, chunks 4, 2 heads of 16, cluster 8 (two windows a block).
    Also with keys x40 and zero queries, where every member lies far from mu
    and only a softmax at the true maximum stays finite (the TPU kernel's
    bound shift gives beta = 0 there)."""
    nh, d, g, ws, j, cs = 2, 16, 12, 3, 4, 8
    qkv, dense, ln, bias = _inputs(23, 2, g, g, ws, nh, d, True, True)
    if large_keys:
        qkv[..., :nh * d] = 0.0
        qkv[..., nh * d:2 * nh * d] *= 40.0
    qkv = _torch(qkv).bfloat16()
    args = (*map(_torch, dense), *map(_torch, ln), d ** -0.5, nh, g, ws, j, True)
    ref = K.eva_attention_single_ref(qkv, *args, bias=_torch(bias)).float()
    got = _emulate_mma_route(qkv, dense, ln, bias, nh, g, ws, j, True, cs).float()
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= BF16_TOL, err
    if large_keys:  # beta carries real weight: it is not the collapsed 0
        assert ref.abs().max() > 0.1

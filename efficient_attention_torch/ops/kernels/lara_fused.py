"""K5 ``lara_fused``: the mis-opt LARA combine of the eval forward in one kernel.

Replaces ``efficient_attention_tpu/ops/pallas/lara_fused.py::
lara_attention_fused``, the kernel that every LARA block (mis-opt, eval)
goes through.  From the packed projection output ``qkv [B, N, 3*H*D]``, the
proposal means ``w [B, H, C, D]`` (at eval the RF weights are the means),
the query landmarks ``q_bar [B, H, C, D]`` and the landmark-side terms
``balance, log_proposal [B, H, C]`` it computes, for each image and head,

* the landmark statistics: ``lpk[c, n] = <w_c, k_n>/sqrt(d) -
  |k_n|^2/(2 sqrt(d))``, ``kv[c] = softmax_n(lpk[c]) @ v``,
  ``lse_k[c] = logsumexp_n lpk[c]`` and ``lse_t[c] = logsumexp_n
  scale <q_bar_c, q_n>``;
* per token ``n`` the mis-opt weights ``alpha = balance + coeff (t_nc -
  mean_c t_nc)`` with ``t_nc = exp(scale <q_bar_c, q_n> - lse_t[c])``, the
  SNIS softmax over the landmarks of ``log alpha + lpq[n, c] + lse_k[c] -
  log_proposal[c]`` and its product with ``kv``.

The softmaxes over tokens are shifted by their true maximum, as the JAX
package's twin (``lara_fused_twin``) and its eager path are; the TPU kernel
shifts ``lse_k`` by the bound ``|w_c|^2/(2 sqrt(d))`` instead, which
underflows when every key lies far from ``w_c``.  Roundings follow the TPU
kernel: both operands of every product are taken in qkv's dtype (so in
bf16 the landmarks, the token-softmax numerators, the SNIS weights and
``kv`` are rounded first), every sum is f32, and the output is cast last.

``lara_attention_fused`` launches the CUDA kernel (``csrc/lara_fused.cu``)
for CUDA tensors and raises where it cannot take them; ``plan`` picks the
route by geometry.  bf16 at head dims 16, 32 and 64 with at most 64
landmarks (``uses_mma``) takes the cluster route: a thread-block cluster of
``ranks`` blocks per (image, head), each holding a slice of the tokens on
chip, every product on tensor cores.  Other bf16 geometries whose head dim
is a multiple of 16 (``uses_wmma``: other head dims, more landmarks, or
more tokens than a cluster of 16 holds) take the wmma kernel, which walks
the tokens in tiles; f32 and the rest take the CUDA-core kernel.  For CPU
tensors it computes the same
function with ``lara_fused_ref``, the plain PyTorch version, which is also
what the kernel is held against on the card; ``lara_fused_split_ref`` is
the same function summed as the cluster route partitions it.  Its gradient
is autograd's over the plain version, as the JAX package takes the VJP of
its twin.  ``LAUNCHES`` counts the kernel's launches on any route,
``LAUNCHES_MMA`` those of the cluster route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from efficient_attention_torch.ops.kernels import _build

LAUNCHES = 0
LAUNCHES_MMA = 0

NAME = "lara_fused"
SOURCE = "efficient_attention_torch/csrc/lara_fused.cu"
REPLACES = "efficient_attention_tpu/ops/pallas/lara_fused.py:201"

# the CUDA-core and wmma kernels' warps, token tile and the kv accumulator
# tiles a wmma warp holds; the cluster route's warps, head dims, landmarks
# (4 tiles of 16 in a phase-B strip), cluster sizes (above 8 non-portable)
# and per-landmark rows of statistics; the shared memory a block may use on
# Hopper
WARPS = 8
CLUSTER_WARPS = 16
TOKEN_TILE = 32
MMA_MAX_ACC = 4
MMA_HEAD_DIMS = (16, 32, 64)
MMA_MAX_LANDMARKS = 64
MAX_RANKS = 16
STATS = 9
SMEM_LIMIT = 232448
_MAX_GRID_YZ = 65535


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


def uses_mma(d: int, C: int, itemsize: int) -> bool:
    """Whether the cluster route's kernel is built for ``(d, C)`` in this
    type (``uses_cluster`` in ``csrc/lara_fused.cu``): bfloat16, a head dim
    of 16, 32 or 64 and at most 64 landmarks.  ``plan`` also needs its rows
    to fit a cluster."""
    return itemsize == 2 and d in MMA_HEAD_DIMS and C <= MMA_MAX_LANDMARKS


def uses_wmma(d: int, C: int, itemsize: int) -> bool:
    """Whether the wmma kernel takes ``(d, C)`` (``uses_wmma`` in
    ``csrc/lara_fused.cu``): bfloat16, a head dim that is a multiple of 16,
    and the kv tiles within the warps' accumulators."""
    return (itemsize == 2 and d % 16 == 0
            and (_align(C, 16) // 16) * (d // 16) <= WARPS * MMA_MAX_ACC)


def smem_bytes(d: int, C: int, itemsize: int = 4, rows: int = 0,
               ranks: int = 1) -> int:
    """Dynamic shared memory of one block; the same layouts as
    ``make_cluster_layout``, ``make_mma_layout`` and ``make_layout`` in
    ``csrc/lara_fused.cu``.

    ``rows > 0``: the cluster route with ``rows`` tokens a block in clusters
    of ``ranks``, each region 128-byte aligned: q, k, v (``rows`` rounded up
    to 16) and w, q_bar and the rounded kv (landmarks padded to a multiple
    of 16) in bf16 rows of d + 8; the block's f32 kv sums in rows of d + 8
    (over k and v, which phase A no longer needs then); what the other
    blocks write into it, in f32: as the owner of ``ceil(C / ranks)``
    landmarks every block's kv sums, den and two landmark-logit statistics,
    and every block's maxima; nine per-landmark rows and the per-token norms
    in f32; the warps' row statistics.
    Otherwise the wmma kernel where ``uses_wmma``: w, q_bar, kv and the q,
    k, v tiles in bf16, an f32 region for the logit tiles, the kv sums or
    the output tile, the rounded numerators or SNIS weights in bf16, the
    statistics and a per-token row.  Else the CUDA-core kernel: the
    landmarks w and q_bar and the kv sums (f32 rows of d at d + 1), one
    token tile each of q (which v reuses) and k, two logit tiles, eight
    per-landmark statistics and one per-token row."""
    TT = TOKEN_TILE
    if rows > 0:
        RP, CP, DB, LO = _align(rows, 16), _align(C, 16), d + 8, -(-C // ranks)
        return (_align(RP * DB * 2, 128)
                + max(2 * _align(RP * DB * 2, 128), _align(CP * DB * 4, 128))
                + 3 * _align(CP * DB * 2, 128) + _align(ranks * LO * d * 4, 128)
                + _align(ranks * CP * 4, 128) + _align(ranks * LO * 4, 128)
                + _align(ranks * LO * 8, 128) + _align(STATS * CP * 4, 128)
                + _align(RP * 4, 128) + _align(CLUSTER_WARPS * 3 * 16 * 4, 128))
    if uses_wmma(d, C, itemsize):
        CP, DB = _align(C, 16), d + 8
        LF = max(CP * (TT + 4), TT * (CP + 4))
        FS = max(2 * LF, CP * (d + 4), TT * (d + 4))
        PB = max(CP * (TT + 8), TT * (CP + 8))
        return (3 * _align(CP * DB * 2, 128) + 3 * _align(TT * DB * 2, 128)
                + _align(FS * 4, 128) + _align(PB * 2, 128)
                + _align(8 * CP * 4, 128) + _align(TT * 4, 128))
    DP = d + 1
    logits = _align(max(C * (TT + 1), TT * (C + 1)) * 4, 16)
    return (3 * _align(C * DP * 4, 16) + 2 * _align(TT * DP * 4, 16)
            + 2 * logits + _align(8 * C * 4, 16) + _align(TT * 4, 16))


def plan_ranks(N: int, d: int, C: int) -> int:
    """The cluster size of the cluster route at ``(N, d, C)`` in bf16, or 0
    where it does not take the geometry (``plan_ranks`` in
    ``csrc/lara_fused.cu``): the smallest whose blocks fit, every block
    holding at least one token.  At the DeiT-tiny-p8 headline that is 2
    blocks of 392 tokens, the fastest cluster size there on the H100
    (PERF.md)."""
    if N < 1 or C < 1 or not uses_mma(d, C, 2):
        return 0
    for R in range(1, MAX_RANKS + 1):
        rows = -(-N // R)
        if (R - 1) * rows < N and smem_bytes(d, C, 2, rows, R) <= SMEM_LIMIT:
            return R
    return 0


@functools.lru_cache(maxsize=1024)
def plan(B: int, N: int, num_heads: int, d: int, C: int,
         itemsize: int) -> Optional[Tuple[int, int, str]]:
    """``(ranks, smem_bytes, route)`` of a launch, or None where no route
    takes it (``lara_fused_plan`` in ``csrc/lara_fused.cu``).  ``route`` is
    ``"cluster"`` (bf16, ``uses_mma``, a cluster of ``ranks`` blocks holds
    the tokens), else ``"wmma"`` (``ranks`` -1; bf16, ``uses_wmma``) where
    that kernel's block fits, else ``"cuda-cores"`` (``ranks`` 0) where
    its block fits.  Cached: the model's blocks ask at every forward."""
    if not 1 <= B <= _MAX_GRID_YZ or num_heads < 1 or C < 1 or N < 1 or d < 1:
        return None
    if itemsize not in (2, 4):
        return None
    R = plan_ranks(N, d, C) if itemsize == 2 else 0
    if R:
        return R, smem_bytes(d, C, 2, -(-N // R), R), "cluster"
    if uses_wmma(d, C, itemsize) and smem_bytes(d, C, itemsize) <= SMEM_LIMIT:
        return -1, smem_bytes(d, C, itemsize), "wmma"
    if smem_bytes(d, C, 4) <= SMEM_LIMIT:
        return 0, smem_bytes(d, C, 4), "cuda-cores"
    return None


def supports_lara_fused(B: int, N: int, three_hd: int, num_heads: int, C: int,
                        itemsize: int = 2) -> bool:
    """Geometry gate of the kernel: float32 or bfloat16, heads dividing the
    width, at least one landmark, and a route whose block fits Hopper's
    shared memory (``plan``)."""
    if num_heads < 1 or three_hd % (3 * num_heads):
        return False
    return plan(B, N, num_heads, three_hd // (3 * num_heads), C, itemsize) is not None


def _heads(qkv, weights, q_bar, num_heads):
    """q, k, v ``[B, H, N, D]`` in f32, w and q_bar rounded to qkv's dtype,
    and the rounding a product in that dtype sees."""
    T = qkv.dtype
    B, N, three_hd = qkv.shape
    d = three_hd // (3 * num_heads)

    def rnd(t):  # the value a product in qkv's dtype sees
        return t.to(T).float()

    x = qkv.float().reshape(B, N, 3, num_heads, d)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, N, D]
    return q, k, v, rnd(weights.float()), rnd(q_bar.float()), rnd


def _combine(q, w, qb, kv, lse_k, lse_t, balance, log_proposal, scale,
             alpha_coeff, rnd, dtype):
    """Each token's mis-opt combine over the landmarks from the landmark
    statistics (kv already divided by its denominator); ``[B, N, H*D]``."""
    B, nh, N, d = q.shape
    C = w.shape[2]
    dn = d ** -0.5
    lpq = (dn * torch.einsum("bhnd,bhcd->bhnc", q, w)
           - (0.5 * dn) * q.square().sum(-1)[..., None])
    t_nc = torch.exp(scale * torch.einsum("bhnd,bhcd->bhnc", q, qb)
                     - lse_t[:, :, None, :])
    mean_c = t_nc.sum(-1, keepdim=True) / float(C)
    alpha = balance.float()[:, :, None, :] + alpha_coeff * (t_nc - mean_c)
    log_iw = (torch.log(alpha.clamp(min=1e-8)) + lpq + lse_k[:, :, None, :]
              - log_proposal.float()[:, :, None, :])
    sniw = torch.softmax(log_iw, dim=-1)
    out = torch.einsum("bhnc,bhcd->bnhd", rnd(sniw), rnd(kv))
    return out.reshape(B, N, nh * d).to(dtype)


def lara_fused_ref(qkv: torch.Tensor, weights: torch.Tensor,
                   q_bar: torch.Tensor, balance: torch.Tensor,
                   log_proposal: torch.Tensor, scale: float, num_heads: int,
                   alpha_coeff: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version (the counterpart of ``_kernel``): the same
    function and roundings in f32 tensor ops; ``[B, N, H*D]`` in qkv's
    dtype."""
    q, k, v, w, qb, rnd = _heads(qkv, weights, q_bar, num_heads)
    dn = q.shape[-1] ** -0.5
    # landmark statistics, each softmax over tokens shifted by its maximum
    lpk = (dn * torch.einsum("bhcd,bhnd->bhcn", w, k)
           - (0.5 * dn) * k.square().sum(-1)[:, :, None, :])
    m_k = lpk.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(lpk - m_k)
    den = p.sum(-1).clamp(min=1e-15)
    kv = torch.einsum("bhcn,bhnd->bhcd", rnd(p), v) / den[..., None]
    lse_k = torch.log(den) + m_k[..., 0]
    lse_t = torch.logsumexp(scale * torch.einsum("bhcd,bhnd->bhcn", qb, q), -1)
    return _combine(q, w, qb, kv, lse_k, lse_t, balance, log_proposal, scale,
                    alpha_coeff, rnd, qkv.dtype)


def lara_fused_split_ref(qkv: torch.Tensor, weights: torch.Tensor,
                         q_bar: torch.Tensor, balance: torch.Tensor,
                         log_proposal: torch.Tensor, scale: float,
                         num_heads: int, alpha_coeff: float = 1.0,
                         ranks: int = 1) -> torch.Tensor:
    """``lara_fused_ref`` summed as the cluster route partitions it: the
    tokens cut into ``ranks`` slices of ``ceil(N / ranks)``, each padded to a
    multiple of 16 with copies of its last token (logits -inf, so they add
    exact zeros).  Each slice's maxima, then the true maxima over the slices;
    each slice's sums and kv sums (numerators rounded against the true
    maxima), added over the slices in rank order; each slice's maximum and
    sum of the landmark logits' exponentials, merged in rank order (nothing
    of them is rounded); the per-token combine as the plain version.  It
    differs from ``lara_fused_ref`` only in the order of f32 sums.  Every
    slice must hold a token, as the kernel's do."""
    q, k, v, w, qb, rnd = _heads(qkv, weights, q_bar, num_heads)
    N, d = q.shape[2], q.shape[3]
    dn = d ** -0.5
    rows = -(-N // ranks)
    if ranks < 1 or (ranks - 1) * rows >= N:
        raise ValueError(f"{ranks} slices of {rows} of {N} tokens leave one empty")
    lpk = (dn * torch.einsum("bhcd,bhnd->bhcn", w, k)
           - (0.5 * dn) * k.square().sum(-1)[:, :, None, :])
    lt = scale * torch.einsum("bhcd,bhnd->bhcn", qb, q)
    parts = []
    for r in range(ranks):
        n0, nr = r * rows, min(rows, N - r * rows)
        idx = torch.arange(n0, n0 + _align(nr, 16)).clamp(max=n0 + nr - 1)
        real = torch.arange(_align(nr, 16)) < nr
        mask = torch.where(real, 0.0, float("-inf"))
        parts.append((lpk[..., idx] + mask, lt[..., idx] + mask, v[:, :, idx]))
    m_k = torch.stack([a.amax(-1) for a, _, _ in parts]).amax(0)
    den = m_t = dent = kvs = 0.0
    for r, (a, t, vv) in enumerate(parts):  # rank order
        p = torch.exp(a - m_k[..., None])
        den = den + p.sum(-1)
        kvs = kvs + torch.einsum("bhcn,bhnd->bhcd", rnd(p), vv)
        # the landmark logits' (maximum, sum) of each slice, merged
        mr = t.amax(-1)
        lr = torch.exp(t - mr[..., None]).sum(-1)
        if r == 0:
            m_t, dent = mr, lr
        else:
            m = torch.maximum(m_t, mr)
            m_t, dent = m, dent * torch.exp(m_t - m) + lr * torch.exp(mr - m)
    den = den.clamp(min=1e-15)
    return _combine(q, w, qb, kvs / den[..., None], torch.log(den) + m_k,
                    torch.log(dent.clamp(min=1e-30)) + m_t, balance,
                    log_proposal, scale, alpha_coeff, rnd, qkv.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lara_fused_launch.argtypes = ([ptr] * 6 + [i32] * 6 + [f32] * 3
                                      + [i32, ptr])
    lib.lara_fused_launch.restype = i32
    lib.lara_fused_smem_bytes.argtypes = [i32] * 5
    lib.lara_fused_smem_bytes.restype = i32
    lib.lara_fused_plan.argtypes = [i32] * 4
    lib.lara_fused_plan.restype = i32
    lib.lara_fused_max_active_clusters.argtypes = [i32] * 4
    lib.lara_fused_max_active_clusters.restype = i32
    lib.lara_fused_error_string.argtypes = [i32]
    lib.lara_fused_error_string.restype = ctypes.c_char_p
    return lib


def _launch(qkv, weights, q_bar, balance, log_proposal, scale, num_heads,
            alpha_coeff):
    if qkv.device.type != "cuda":
        raise ValueError(f"lara_fused runs on CUDA or CPU tensors, got {qkv.device}")
    if qkv.dim() != 3 or qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qkv must be a float32 or bfloat16 [B, N, 3*H*D], got "
                         f"{qkv.dtype} {tuple(qkv.shape)}")
    B, N, three_hd = qkv.shape
    nh = num_heads
    if three_hd % (3 * nh):
        raise ValueError(f"qkv {tuple(qkv.shape)} does not split into {nh} heads")
    d = three_hd // (3 * nh)
    if weights.dim() != 4 or tuple(weights.shape[:2]) != (B, nh) \
            or weights.shape[3] != d:
        raise ValueError(f"weights must be [{B}, {nh}, C, {d}], got "
                         f"{tuple(weights.shape)}")
    C = weights.shape[2]
    for t, what, shape in ((q_bar, "q_bar", (B, nh, C, d)),
                           (balance, "balance", (B, nh, C)),
                           (log_proposal, "log_proposal", (B, nh, C))):
        if tuple(t.shape) != shape or t.device != qkv.device:
            raise ValueError(f"{what} must be {list(shape)} on {qkv.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    route = plan(B, N, nh, d, C, qkv.element_size())
    if route is None:
        raise ValueError(f"lara_fused cannot take B={B}, N={N}, {nh} heads of "
                         f"{d}, {C} landmarks; see supports_lara_fused")

    def aligned(t):  # the cluster route reads qkv, w and q_bar 16 bytes at a time
        t = t.contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    qkv = aligned(qkv)
    ops = [aligned(t.to(torch.float32))
           for t in (weights, q_bar, balance, log_proposal)]
    out = torch.empty((B, N, nh * d), dtype=qkv.dtype, device=qkv.device)
    lib = _lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lara_fused_launch(
            qkv.data_ptr(), *(t.data_ptr() for t in ops), out.data_ptr(),
            B, N, nh, d, C, int(qkv.dtype == torch.bfloat16), float(scale),
            float(d ** -0.5), float(alpha_coeff), route[0], stream)
    if rc != 0:
        raise RuntimeError(f"lara_fused launch failed ({route[2]} route): "
                           f"{lib.lara_fused_error_string(rc).decode()}")
    global LAUNCHES, LAUNCHES_MMA
    LAUNCHES += 1
    LAUNCHES_MMA += route[2] == "cluster"
    return out


class _LaraFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, weights, q_bar, balance, log_proposal, scale,
                num_heads, alpha_coeff):
        ctx.save_for_backward(qkv, weights, q_bar, balance, log_proposal)
        ctx.geometry = (scale, num_heads, alpha_coeff)
        if qkv.device.type == "cpu":
            return lara_fused_ref(qkv, weights, q_bar, balance, log_proposal,
                                  scale, num_heads, alpha_coeff)
        return _launch(qkv, weights, q_bar, balance, log_proposal, scale,
                       num_heads, alpha_coeff)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = lara_fused_ref(*leaves, *ctx.geometry)
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
        return (*grads, None, None, None)


def lara_attention_fused(
    qkv: torch.Tensor,           # [B, N, 3*H*D] fused projection output
    weights: torch.Tensor,       # [B, H, C, D] proposal means
    q_bar: torch.Tensor,         # [B, H, C, D]
    balance: torch.Tensor,       # [B, H, C]
    log_proposal: torch.Tensor,  # [B, H, C]
    scale: float,
    num_heads: int,
    alpha_coeff: float = 1.0,
) -> torch.Tensor:
    """Fused mis-opt LARA; returns ``[B, N, H*D]`` in qkv's dtype,
    differentiable in every tensor input.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    return _LaraFused.apply(qkv, weights, q_bar, balance, log_proposal,
                            float(scale), int(num_heads), float(alpha_coeff))

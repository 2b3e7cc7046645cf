"""K6 ``performer_fused``: FAVOR+ linear attention of the eval forward in one kernel.

Replaces ``efficient_attention_tpu/ops/pallas/performer_fused.py::
performer_attention_fused``, the kernel that every Performer block (favorp,
eval) goes through.  From the packed projection output ``qkv [B, N, 3*H*D]``
and the random-feature projection ``w [H, m, D]`` it computes, for each
image and head,

* the key features ``k'[n, j] = m^-1/2 exp(<w_j, k_n>/d^1/4 - |k_n|^2/
  (2 sqrt(d)) - s_k) + 1e-4``, with one stabiliser ``s_k`` (the max of
  ``<w_j, k_n>/d^1/4`` over all ``n`` and ``j``), and from them
  ``kv = k'^T v [m, D]`` and ``z = sum_n k' [m]``;
* per token the query features ``q'`` (each token stabilised by its own max
  over ``j``) and ``out = q' kv / clip(q' z, 1e-2)``.

Roundings follow the TPU kernel: both operands of every product are taken in
qkv's dtype (so in bf16 the projection, ``k'``, ``q'`` and ``kv`` are rounded
first), ``z`` and the denominators are f32 sums of the unrounded features,
and the output is cast last.

``performer_attention_fused`` launches the CUDA kernel
(``csrc/performer_fused.cu``) for CUDA tensors and raises where it cannot
take them; ``plan`` picks the route by geometry.  bf16 at head dims 16, 32
and 64 with ``m % 16 == 0`` and ``m <= 128`` takes the ring route:
persistent blocks, each keeping one head and walking its images
(``ring_walk``), the token tiles through a ring of 16-byte cp.async copies,
every product on mma.sync with the logits and features in registers, and
kv summed over the warps' token splits in f32 once an item, then rounded
once.  Other bf16 geometries whose head dim and feature count are
multiples of 16 (``uses_mma``) take the wmma kernel; f32 and the rest the
CUDA-core kernel.  For CPU tensors it computes the same function with
``performer_fused_ref``, the plain PyTorch version, which is also what the
kernel is held against on the card; ``performer_fused_ring_ref`` is the
same function with kv summed as the ring route sums it.  Its gradient is
autograd's over the plain version, as the JAX package takes the VJP of its
twin.  ``LAUNCHES`` counts the kernel's launches on any route,
``LAUNCHES_RING`` those of the ring route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Optional, Tuple

import torch

from efficient_attention_torch.ops.kernels import _build

LAUNCHES = 0
LAUNCHES_RING = 0

NAME = "performer_fused"
SOURCE = "efficient_attention_torch/csrc/performer_fused.cu"
REPLACES = "efficient_attention_tpu/ops/pallas/performer_fused.py:167"

FEAT_EPS = 1e-4    # favorp_projection's eps
DEN_EPS = 1e-2     # linear_attention's clip of the denominator

# the kernel's token tile, its warps, the kv accumulator tiles a warp of
# the bf16 route holds, and the shared memory a block may use on Hopper
TOKEN_TILE = 32
WARPS = 8
MMA_MAX_ACC = 4
SMEM_LIMIT = 232448
_MAX_GRID_YZ = 65535
# the ring route: its head dims, most features, most warps a block, the
# shared memory of an SM (a block also holds 1 KB of the system's) and its
# SMs on the H100
RING_HEAD_DIMS = (16, 32, 64)
RING_MAX_FEATURES = 128
RING_MAX_WARPS = 8
SM_SMEM = 233472
SMS = 132
# the ring route's layouts, (warps, tile rows, ring slots, blocks an SM),
# in the order plan() tries them: the first whose blocks fit an SM.  Warps
# are rounded down to a multiple of m / 16 (at least m / 16).  The first
# was the fastest layout at every shape that scripts/torch_performer_fused_
# check.py times (PERF.md); the 8-warp ones take m > 64 and long sequences.
RING_CONFIGS = ((4, 64, 4, 3), (8, 128, 4, 1), (8, 64, 4, 1))


class RingConfig(NamedTuple):
    """A layout of the ring route and its block's shared memory."""
    warps: int
    tile: int
    stages: int
    bps: int
    smem: int


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


def uses_mma(d: int, m: int, itemsize: int) -> bool:
    """Whether the kernel takes its bf16 tensor-core route (``uses_mma`` in
    ``csrc/performer_fused.cu``): bfloat16, head dim and feature count
    multiples of 16, and the kv tiles within the warps' accumulators."""
    return (itemsize == 2 and d % 16 == 0 and m % 16 == 0
            and (m // 16) * (d // 16) <= WARPS * MMA_MAX_ACC)


def smem_bytes(d: int, m: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of one block of the route ``(d, m, itemsize)``
    takes; the same layouts as ``make_layout`` and ``make_mma_layout`` in
    ``csrc/performer_fused.cu``.  CUDA-core route: the projection and the
    kv sums (f32 rows of d at d + 1), one token tile each of k (or q) and v,
    one feature tile (rows of m at m + 1), z, two per-token rows and the
    per-warp maxima.  bf16 route: the projection, kv and the two token tiles
    in bf16 (rows of d + 8), an f32 region for the logits, the kv sums or
    the output tile, the features in bf16 (rows of m + 8), z, two per-token
    rows and the per-warp maxima."""
    TT = TOKEN_TILE
    if uses_mma(d, m, itemsize):
        DB = d + 8
        FS = max(TT * (m + 4), m * (d + 4), TT * (d + 4))
        return (2 * _align(m * DB * 2, 128) + 2 * _align(TT * DB * 2, 128)
                + _align(FS * 4, 128) + _align(TT * (m + 8) * 2, 128)
                + _align(m * 4, 128) + 2 * _align(TT * 4, 128) + _align(32 * 4, 128))
    DP = d + 1
    return (2 * _align(m * DP * 4, 16) + 2 * _align(TT * DP * 4, 16)
            + _align(TT * (m + 1) * 4, 16) + _align(m * 4, 16)
            + 2 * _align(TT * 4, 16) + _align(32 * 4, 16))


def ring_warps(warps: int, m: int) -> int:
    """A layout's warps for ``m`` features: a multiple of the 16-feature
    strips ``m / 16``, pass B's warps for one token split each."""
    mf = m // 16
    return mf * max(1, warps // mf)


def ring_smem_bytes(d: int, m: int, N: int, warps: int, tile: int, stages: int) -> int:
    """Dynamic shared memory of one ring block (``make_ring_layout`` in
    ``csrc/performer_fused.cu``), each region 128-byte aligned: the head's
    projection and the rounded kv [m][d + 8] in bf16; ``stages`` ring slots,
    each one k, q or v tile [tile][d + 8] in bf16; the kv partials of the
    token splits past the first (f32 [m][d + 4] each); every split's z
    partial, z, the item's token norms [N rounded up to tiles] and 16
    warps' maxima in f32."""
    DB, splits = d + 8, warps // (m // 16)
    tiles = -(-N // tile)
    return (2 * _align(m * DB * 2, 128) + stages * _align(tile * DB * 2, 128)
            + _align((splits - 1) * m * (d + 4) * 4, 128) + _align(splits * m * 4, 128)
            + _align(m * 4, 128) + _align(tiles * tile * 4, 128)
            + _align(RING_MAX_WARPS * 4, 128))


def ring_config_ok(d: int, m: int, N: int, warps: int, tile: int, stages: int) -> bool:
    """Whether the ring route takes a layout (``ring_config_ok`` in the
    source): head dim 16/32/64, ``m % 16 == 0`` up to 128, warps a multiple
    of ``m / 16`` up to 8, tiles of 16 to 128 rows in steps of 16, 4 to 8
    ring slots (pass B takes two a step, k and v), and the block within
    Hopper's shared memory."""
    if d not in RING_HEAD_DIMS or m < 16 or m > RING_MAX_FEATURES or m % 16 or N < 1:
        return False
    if not 1 <= warps <= RING_MAX_WARPS or warps % (m // 16):
        return False
    if not 16 <= tile <= 128 or tile % 16 or not 4 <= stages <= 8:
        return False
    return ring_smem_bytes(d, m, N, warps, tile, stages) <= SMEM_LIMIT


@functools.lru_cache(maxsize=1024)
def plan(B: int, N: int, num_heads: int, d: int, m: int, itemsize: int,
         configs=None) -> Optional[RingConfig]:
    """The ring route's layout for a launch, or None where the launch keeps
    the kernel that took it before (the wmma kernel where ``uses_mma``, else
    the CUDA-core kernel): bfloat16, head dim 16, 32 or 64, ``m % 16 ==
    0`` up to 128, and the first of ``configs`` (``RING_CONFIGS``) whose
    ``bps`` blocks fit an SM's shared memory.  Cached: the model's blocks
    ask at every forward."""
    if itemsize != 2 or not 1 <= B or num_heads < 1 or N < 1:
        return None
    if d not in RING_HEAD_DIMS or m % 16 or not 16 <= m <= RING_MAX_FEATURES:
        return None
    for warps, tile, stages, bps in configs or RING_CONFIGS:
        w = ring_warps(warps, m)
        if not ring_config_ok(d, m, N, w, tile, stages) or bps < 1:
            continue
        smem = ring_smem_bytes(d, m, N, w, tile, stages)
        # as built: blocks of 4 warps three an SM, of 8 warps one
        if bps * (smem + 1024) <= SM_SMEM and bps <= (3 if w <= 4 else 1):
            return RingConfig(w, tile, stages, bps, smem)
    return None


def ring_blocks(B: int, num_heads: int, bps: int, sms: int = SMS) -> int:
    """Blocks of a ring launch (``ring_blocks`` in the source): a multiple
    of the heads, about ``bps`` an SM, no more than the items."""
    return num_heads * max(1, min(B, sms * bps // num_heads))


def ring_walk(B: int, num_heads: int, blocks: int) -> Iterator[Tuple[int, int, int]]:
    """(block, head, image) of every item in the order the ring blocks take
    them (the kernel's walk): block k keeps head k % num_heads, so its
    projection stays in shared memory, and takes images k / num_heads,
    k / num_heads + blocks / num_heads, ...; the heads of one image are at
    the same position of their blocks' walks, so they run side by side."""
    step = blocks // num_heads
    for blk in range(blocks):
        for b in range(blk // num_heads, B, step):
            yield blk, blk % num_heads, b


def supports_performer_fused(B: int, N: int, three_hd: int, num_heads: int,
                             m: int, itemsize: int = 2) -> bool:
    """Geometry gate of the kernel: float32 or bfloat16, heads dividing the
    width, at least one feature, and the block within Hopper's shared
    memory."""
    if not 1 <= B <= _MAX_GRID_YZ or num_heads < 1 or m < 1 or N < 1:
        return False
    if three_hd % (3 * num_heads) or itemsize not in (2, 4):
        return False
    return smem_bytes(three_hd // (3 * num_heads), m, itemsize) <= SMEM_LIMIT


def _features(qkv, projection, num_heads):
    """The key features ``k'``, v and the query features ``q'`` ([B, H, N,
    m], [B, H, N, D], [B, H, N, m], f32, unrounded) and the rounding a
    product in qkv's dtype sees."""
    T = qkv.dtype
    B, N, three_hd = qkv.shape
    nh = num_heads
    d = three_hd // (3 * nh)
    m = projection.shape[1]
    dn4, half, ratio = d ** -0.25, 0.5 * d ** -0.5, m ** -0.5

    def rnd(t):  # the value a product in qkv's dtype sees
        return t.to(T).float()

    x = qkv.float().reshape(B, N, 3, nh, d)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, N, D]
    w = rnd(projection.float())
    dash_k = dn4 * torch.einsum("bhnd,hmd->bhnm", k, w)
    s_k = dash_k.amax(dim=(-1, -2), keepdim=True).detach()
    kp = ratio * torch.exp(dash_k - half * k.square().sum(-1)[..., None] - s_k) \
        + FEAT_EPS
    dash_q = dn4 * torch.einsum("bhnd,hmd->bhnm", q, w)
    s_q = dash_q.amax(dim=-1, keepdim=True).detach()
    qp = ratio * torch.exp(dash_q - half * q.square().sum(-1)[..., None] - s_q) \
        + FEAT_EPS
    return kp, v, qp, rnd


def _combine(qp, kv, z, rnd, dtype):
    """out = round(q') round(kv) / clip(q' z, 1e-2) as ``[B, N, H*D]`` in
    ``dtype``, from the f32 sums kv [B, H, m, D] and z [B, H, m]."""
    B, nh, N, _ = qp.shape
    num = torch.einsum("bhnm,bhmd->bhnd", rnd(qp), rnd(kv))
    den = (qp * z[:, :, None, :]).sum(-1)
    out = num / den.clamp(min=DEN_EPS)[..., None]
    return out.transpose(1, 2).reshape(B, N, -1).to(dtype)


def performer_fused_ref(qkv: torch.Tensor, projection: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """Plain PyTorch version (the counterpart of ``_kernel``): the same
    function and roundings in f32 tensor ops; ``[B, N, H*D]`` in qkv's
    dtype."""
    kp, v, qp, rnd = _features(qkv, projection, num_heads)
    kv = torch.einsum("bhnm,bhnd->bhmd", rnd(kp), v)
    return _combine(qp, kv, kp.sum(-2), rnd, qkv.dtype)


def performer_fused_ring_ref(qkv: torch.Tensor, projection: torch.Tensor,
                             num_heads: int, warps: int, tile: int) -> torch.Tensor:
    """The plain version with kv and z summed as the ring route sums them:
    the tokens in 16-token chunks, chunk c of a tile of ``tile`` rows
    summed by token split ``c % S`` (S = ``warps / (m / 16)``), each split's
    partial a running f32 sum over its chunks in token order, the partials
    then added in split order in f32 and kv rounded once."""
    kp, v, qp, rnd = _features(qkv, projection, num_heads)
    m = kp.shape[-1]
    splits = warps // (m // 16)
    N = kp.shape[2]
    kv_part, z_part = [None] * splits, [None] * splits
    for n0 in range(0, N, 16):
        ts = (n0 % tile) // 16 % splits
        kvc = torch.einsum("bhnm,bhnd->bhmd", rnd(kp[:, :, n0:n0 + 16]), v[:, :, n0:n0 + 16])
        zc = kp[:, :, n0:n0 + 16].sum(-2)
        kv_part[ts] = kvc if kv_part[ts] is None else kv_part[ts] + kvc
        z_part[ts] = zc if z_part[ts] is None else z_part[ts] + zc
    kv, z = kv_part[0], z_part[0]
    for i in range(1, splits):
        if kv_part[i] is not None:
            kv, z = kv + kv_part[i], z + z_part[i]
    return _combine(qp, kv, z, rnd, qkv.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.performer_fused_launch.argtypes = ([ptr] * 3 + [i32] * 6 + [f32] * 3
                                           + [i32] * 4 + [ptr])
    lib.performer_fused_launch.restype = i32
    lib.performer_fused_smem_bytes.argtypes = [i32, i32, i32]
    lib.performer_fused_smem_bytes.restype = i32
    lib.performer_fused_ring_smem_bytes.argtypes = [i32] * 6
    lib.performer_fused_ring_smem_bytes.restype = i32
    lib.performer_fused_ring_blocks.argtypes = [i32] * 3
    lib.performer_fused_ring_blocks.restype = i32
    lib.performer_fused_ring_blocks_per_sm.argtypes = [i32] * 4
    lib.performer_fused_ring_blocks_per_sm.restype = i32
    lib.performer_fused_error_string.argtypes = [i32]
    lib.performer_fused_error_string.restype = ctypes.c_char_p
    return lib


def route_config(B: int, N: int, num_heads: int, d: int, m: int, itemsize: int,
                 config=None) -> Optional[RingConfig]:
    """The launch's ring layout, or None for the kernel that took the
    geometry before: ``plan``'s where ``config`` is None; ``config`` 0
    forces the old kernel, a 4-tuple (warps, tile rows, ring slots, blocks
    an SM) a ring layout, which must fit."""
    if config is None:
        return plan(B, N, num_heads, d, m, itemsize)
    if config == 0:
        return None
    cfg = plan(B, N, num_heads, d, m, itemsize, configs=(tuple(int(x) for x in config),))
    if cfg is None or cfg.warps != config[0]:
        raise ValueError(f"performer_fused: ring layout {config} does not fit B={B}, "
                         f"N={N}, {num_heads} heads of {d}, {m} features")
    return cfg


def _launch(qkv, projection, num_heads, config=None):
    if qkv.device.type != "cuda":
        raise ValueError(f"performer_fused runs on CUDA or CPU tensors, got "
                         f"{qkv.device}")
    if qkv.dim() != 3 or qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qkv must be a float32 or bfloat16 [B, N, 3*H*D], got "
                         f"{qkv.dtype} {tuple(qkv.shape)}")
    B, N, three_hd = qkv.shape
    nh = num_heads
    if three_hd % (3 * nh):
        raise ValueError(f"qkv {tuple(qkv.shape)} does not split into {nh} heads")
    d = three_hd // (3 * nh)
    if projection.dim() != 3 or projection.shape[0] != nh \
            or projection.shape[2] != d or projection.device != qkv.device:
        raise ValueError(f"projection must be [{nh}, m, {d}] on {qkv.device}, "
                         f"got {tuple(projection.shape)} on {projection.device}")
    m = projection.shape[1]
    if not supports_performer_fused(B, N, three_hd, nh, m, qkv.element_size()):
        raise ValueError(f"performer_fused cannot take B={B}, N={N}, {nh} heads "
                         f"of {d}, {m} features; see supports_performer_fused")
    ring = route_config(B, N, nh, d, m, qkv.element_size(), config)
    qkv = qkv.contiguous()
    if ring is not None and qkv.data_ptr() % 16:  # 16-byte cp.async
        qkv = qkv.clone()
    w = projection.to(torch.float32).contiguous()
    out = torch.empty((B, N, nh * d), dtype=qkv.dtype, device=qkv.device)
    layout = tuple(ring[:4]) if ring else (0,) * 4
    lib = _lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.performer_fused_launch(
            qkv.data_ptr(), w.data_ptr(), out.data_ptr(), B, N, nh, d, m,
            int(qkv.dtype == torch.bfloat16), float(d ** -0.25),
            float(0.5 * d ** -0.5), float(m ** -0.5), *layout, stream)
    if rc != 0:
        raise RuntimeError(f"performer_fused launch failed ({'ring' if ring else 'old'} "
                           f"route): {lib.performer_fused_error_string(rc).decode()}")
    global LAUNCHES, LAUNCHES_RING
    LAUNCHES += 1
    LAUNCHES_RING += ring is not None
    return out


class _PerformerFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, projection, num_heads, config):
        ctx.save_for_backward(qkv, projection)
        ctx.num_heads = num_heads
        if qkv.device.type == "cpu":
            return performer_fused_ref(qkv, projection, num_heads)
        return _launch(qkv, projection, num_heads, config)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = performer_fused_ref(*leaves, ctx.num_heads)
        return (*torch.autograd.grad(out, leaves, g), None, None)


def performer_attention_fused(
    qkv: torch.Tensor,         # [B, N, 3*H*D] fused projection output
    projection: torch.Tensor,  # [H, m, D] random-feature matrix
    num_heads: int,
    config=None,
) -> torch.Tensor:
    """Fused FAVOR+ linear attention; returns ``[B, N, H*D]`` in qkv's
    dtype, differentiable in qkv and the projection.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the route ``plan`` picks, or raise.  ``config`` forces a route
    (``route_config``: 0 the old kernel, a 4-tuple a ring layout), to time
    and check one beside the other."""
    return _PerformerFused.apply(qkv, projection, int(num_heads), config)

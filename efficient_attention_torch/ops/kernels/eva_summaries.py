"""K8 ``eva_summaries``: the 2-D EVA eval chunk summaries in one read of qkv.

Replaces ``efficient_attention_tpu/ops/pallas/eva_summaries.py::
eva_summaries_packed``, the kernel behind EVA's ``use_pallas_summaries``.
From the packed projection output ``qkv [B, N, 3*H*D]`` it computes, for each
``j x j`` chunk of the ``N/gw x gw`` token grid and each head, the means of q
and k, ``rf_q = LN(mean_q Wq + bq)`` and ``rf_k = LN(mean_k Wk + bk)`` (the
adaptive Dense and LN act on ``head_dim`` and are shared by the heads; no LN
for ``adaptive_proj='no-ln'``), ``mu = (rf_q + rf_k) / 2``, and the softmax
over the chunk's members of ``<mu, k_t>/sqrt(d) - |k_t|^2/(2 sqrt(d))``,
shifted by its true maximum, that weights their values into ``beta``.  It
returns ``(rf_k_bar, beta)``, each ``[B, C, H*D]`` in qkv's dtype.  The means
and the adaptive projection are taken in f32 whatever the input type: the
adaptive LN amplifies their truncation (``eva_summaries.py:15-23``).

``eva_summaries_packed`` launches the CUDA kernel (``csrc/eva_summaries.cu``)
for a CUDA tensor, and raises where the kernel cannot take its input.  For a
CPU tensor it computes the same function with ``eva_summaries_packed_ref``,
the plain PyTorch version, which is also what the kernel is held against on
the card; at eval it is the same function as ``EVA._chunk_summaries_packed``.
``LAUNCHES`` counts the kernel's launches, ``LAUNCHES_MMA`` those on the
persistent tensor-core route (bf16, head dims 16/32/64, chunks of at most 64
members, strips of at least ``MMA_MIN_ROWS_K8`` rows, the layout
``mma_plan`` picks within shared memory); every other geometry runs the
first kernel, a block a (strip, head, image).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from efficient_attention_torch.ops.kernels import _build

LAUNCHES = 0
LAUNCHES_MMA = 0

NAME = "eva_summaries"
SOURCE = "efficient_attention_torch/csrc/eva_summaries.cu"
REPLACES = "efficient_attention_tpu/ops/pallas/eva_summaries.py:217"

# the kernel's own limits: head dims it is instantiated for, threads per
# block and the shared memory a block may use on Hopper
HEAD_DIMS = (12, 16, 32, 64)
THREADS = 256
SMEM_LIMIT = 232448
_MAX_GRID_YZ = 65535
# the persistent tensor-core route: head dims it is built for, the most
# members a chunk, shared memory an SM (a block reserves 1 KB of it), the
# SMs of an H100 SXM (mma_blocks' default; the launcher reads the card's)
MMA_HEAD_DIMS = (16, 32, 64)
MMA_MAX_MEMBERS = 64
SM_SMEM = 233472
SMS = 132


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(rows: int, d: int, itemsize: int, xdim: int = 0) -> int:
    """Dynamic shared memory of one block; the same layout as
    ``make_sum_layout`` in ``csrc/eva_eval.cuh``: the strip's q/k/v rows of
    one head (the input type), per-warp f32 means, and for the x-reading form
    (``xdim > 0``, K10) the strip's x rows padded to 16 and per-warp MMA
    scratch."""
    warps = THREADS // 32
    total = _align128(rows * 3 * d * itemsize) + _align128(warps * 2 * d * 4)
    if xdim:
        total += (_align128(_round16(rows) * (xdim + 8) * itemsize)
                  + _align128(warps * 256 * 4))
    return total


def plan(B: int, num_heads: int, gh: int, gw: int, j: int, d: int, itemsize: int,
         xdim: int = 0) -> Optional[int]:
    """Shared memory of a launch, or None where the kernel cannot take it:
    square chunks dividing the grid, a head dim it is built for, float32 or
    bfloat16, and a strip of ``j*gw`` tokens within Hopper's shared memory."""
    if not 1 <= B <= _MAX_GRID_YZ or not 1 <= num_heads <= _MAX_GRID_YZ:
        return None
    if j <= 0 or gh <= 0 or gw <= 0 or gh % j or gw % j:
        return None
    if d not in HEAD_DIMS or itemsize not in (2, 4) or xdim < 0:
        return None
    smem = smem_bytes(j * gw, d, itemsize, xdim)
    return smem if smem <= SMEM_LIMIT else None


class SumConfig(NamedTuple):
    """The persistent route's launch: warps a block (8 or 16), item buffers
    in its cp.async ring, blocks an SM, teams (2: K10's two-team kernel,
    which projects one item while it summarises the one before), and the
    block's shared memory (``SumConfig`` in ``csrc/eva_eval.cuh``)."""
    warps: int
    stages: int
    bps: int
    teams: int
    smem: int


# the layouts mma_plan tries, first that fits: (warps, stages, blocks an
# SM, teams), K8's (xdim 0) and K10's (xdim > 0)
MMA_CONFIGS = {
    False: ((8, 2, 2, 1), (8, 2, 1, 1)),
    True: ((8, 1, 2, 1), (16, 1, 1, 2), (16, 2, 1, 1), (16, 1, 1, 1)),
}
# K8 leaves strips of fewer rows to the first kernel, which was the faster
# there (PVT-B3's third stage and DeiT-tiny-p16: 28 rows a strip)
MMA_MIN_ROWS_K8 = 56


def mma_max_bps(warps: int) -> int:
    """The blocks an SM the kernel of ``warps`` warps is built for
    (``sum_mma_max_bps`` in the header: its launch bounds)."""
    return 1 if warps == 16 else 2


def mma_smem_bytes(rows: int, d: int, xdim: int, wc: int, jj: int, stages: int,
                   teams: int = 1) -> int:
    """Shared memory of one block of the persistent route; the same layout
    as ``sum_mma_layout`` in ``csrc/eva_eval.cuh``: for K10 (``xdim > 0``)
    the head's Wqkv columns [xdim][3d + 8] (bf16), then the ring of
    ``stages`` item buffers (K8 the strip's q, k, v rows of one head
    [rows][3d + 8]; K10 its x rows [rows][xdim + 8]), K10's projected rows
    [rows][3d + 8] (two buffers for the two-team kernel, ``teams`` 2), the
    f32 vectors (the adaptive biases and LN, K10's bqkv columns), the
    chunks' means [wc][2][d], the Dense's partial sums (256 floats a chunk),
    the members' weights [wc][jj] and their row offsets [wc][jj], each region
    128-byte aligned."""
    lt = 3 * d + 8
    stage = rows * (xdim + 8 if xdim else lt) * 2
    return (_align128(xdim * lt * 2) + stages * _align128(stage)
            + (teams * _align128(rows * lt * 2) if xdim else 0)
            + _align128((6 * d + (3 * d if xdim else 0)) * 4)
            + _align128(wc * 2 * d * 4) + _align128(256 * wc * 4)
            + 2 * _align128(wc * jj * 4))


def mma_plan(B: int, num_heads: int, gh: int, gw: int, j: int, d: int,
             itemsize: int, xdim: int = 0, configs=None) -> Optional[SumConfig]:
    """The persistent tensor-core route's layout, or None where the launch
    takes the first kernel: bf16, head dims 16/32/64, chunks of at most 64
    members, for K10 ``xdim % 16 == 0``, for K8 strips of at least
    ``MMA_MIN_ROWS_K8`` rows (unless ``configs`` forces a layout), and the
    first of ``configs`` (``MMA_CONFIGS``) whose blocks fit an SM's shared
    memory."""
    if plan(B, num_heads, gh, gw, j, d, itemsize, xdim) is None:
        return None
    if itemsize != 2 or d not in MMA_HEAD_DIMS or j * j > MMA_MAX_MEMBERS:
        return None
    if xdim % 16 or (configs is None and not xdim and j * gw < MMA_MIN_ROWS_K8):
        return None
    for warps, stages, bps, teams in configs or MMA_CONFIGS[xdim > 0]:
        # (sum_mma_config_ok: K8 reads its rows from the ring, so it needs a
        # second buffer to load into; blocks an SM as the kernel is built;
        # two teams only for K10 at 16 warps, one stage, one block an SM)
        if teams == 2:
            if not (xdim and (warps, stages, bps) == (16, 1, 1)):
                continue
        elif (teams != 1 or warps not in (8, 16) or not 1 <= bps <= mma_max_bps(warps)
              or not (1 if xdim else 2) <= stages <= 3):
            continue
        smem = mma_smem_bytes(j * gw, d, xdim, gw // j, j * j, stages, teams)
        if smem <= SMEM_LIMIT and bps * (smem + 1024) <= SM_SMEM:
            return SumConfig(warps, stages, bps, teams, smem)
    return None


def mma_blocks(B: int, num_heads: int, strips: int, bps: int, sms: int = SMS) -> int:
    """Blocks of a persistent launch (``sum_mma_blocks`` in the header): a
    multiple of the heads, at most ``bps`` an SM, no more than the items."""
    return num_heads * max(1, min(strips * B, sms * bps // num_heads))


def mma_walk(B: int, num_heads: int, strips: int,
             blocks: int) -> Iterator[Tuple[int, int, int, int]]:
    """(block, strip, head, image) of every item in the order the persistent
    blocks take them (the kernel's walk): block k keeps head k % num_heads,
    so K10's blocks keep one Wqkv slice, and takes the (strip, image) pairs
    q = k / num_heads, q + blocks / num_heads, ...; pair q is strip q %
    strips of image q / strips.  At a time the blocks of one pair's heads
    run side by side and share its rows in L2."""
    step = blocks // num_heads
    for blk in range(blocks):
        for q in range(blk // num_heads, strips * B, step):
            yield blk, q % strips, blk % num_heads, q // strips


def supports_summaries(B: int, gh: int, gw: int, j: int, adaptive_proj: str,
                       three_hd: int, num_heads: int, itemsize: int = 2) -> bool:
    """Geometry gate of the kernel (JAX ``supports_summaries``, with the head
    dim, element size and shared memory that the kernel is built for)."""
    if adaptive_proj not in ("default", "no-ln") or three_hd % (3 * num_heads):
        return False
    d = three_hd // (3 * num_heads)
    return plan(B, num_heads, gh, gw, j, d, itemsize) is not None


def route_config(B: int, num_heads: int, gh: int, gw: int, j: int, d: int,
                 itemsize: int, xdim: int, config, what: str) -> Tuple[int, int, int, int]:
    """The launcher's (warps, stages, blocks an SM, teams): ``mma_plan``'s
    layout, (0, 0, 0, 0) for the first kernel; ``config`` forces one (0 the
    first kernel, or a 4-tuple the persistent route, which must fit)."""
    if config is None:
        cfg = mma_plan(B, num_heads, gh, gw, j, d, itemsize, xdim)
        return tuple(cfg[:4]) if cfg is not None else (0, 0, 0, 0)
    if config == 0:
        return (0, 0, 0, 0)
    cfg = mma_plan(B, num_heads, gh, gw, j, d, itemsize, xdim, configs=(tuple(config),))
    if cfg is None:
        raise ValueError(f"{what}: layout {config} does not fit B={B}, grid {gh}x{gw}, "
                         f"chunk {j}, head dim {d}, xdim {xdim}")
    return tuple(cfg[:4])


def eva_summaries_packed_ref(
    qkv: torch.Tensor,                   # [B, N, 3*H*D]
    wq: torch.Tensor, bq: torch.Tensor,  # adaptive_mu_q Dense [d, d] (in, out), [d]
    wk: torch.Tensor, bk: torch.Tensor,  # adaptive_mu_k Dense
    lnq_scale: Optional[torch.Tensor], lnq_bias: Optional[torch.Tensor],
    lnk_scale: Optional[torch.Tensor], lnk_bias: Optional[torch.Tensor],
    num_heads: int,
    gw: int,
    j: int,
    use_ln: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same function in f32 tensor
    ops, outputs in the input dtype.  Returns ``(rf_k_bar, beta)``, each
    ``[B, C, H*D]``."""
    B, N, three_hd = qkv.shape
    nh = num_heads
    hd = three_hd // 3
    d = hd // nh
    gh = N // gw
    hc, wc = gh // j, gw // j
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32,
                            device=qkv.device)
    q, k, v = qkv.float().reshape(B, gh, gw, 3, nh, d).unbind(3)

    def chunked(t):  # [B, gh, gw, nh, d] -> [B, hc, wc, nh, j*j, d]
        return (t.reshape(B, hc, j, wc, j, nh, d)
                .permute(0, 1, 3, 5, 2, 4, 6).reshape(B, hc, wc, nh, j * j, d))

    k_c, v_c = chunked(k), chunked(v)
    rf_q = chunked(q).mean(-2) @ f32(wq) + f32(bq)   # [B, hc, wc, nh, d]
    rf_k = k_c.mean(-2) @ f32(wk) + f32(bk)
    if use_ln:
        rf_q = F.layer_norm(rf_q, (d,), f32(lnq_scale), f32(lnq_bias), 1e-6)
        rf_k = F.layer_norm(rf_k, (d,), f32(lnk_scale), f32(lnk_bias), 1e-6)
    mu = 0.5 * (rf_q + rf_k)
    dn = d ** -0.5
    logp = (dn * (k_c * mu.unsqueeze(-2)).sum(-1)
            - (0.5 * dn) * k_c.square().sum(-1))     # [B, hc, wc, nh, j*j]
    p = torch.softmax(logp, dim=-1)                   # true per-chunk max
    beta = (p.unsqueeze(-1) * v_c).sum(-2)            # [B, hc, wc, nh, d]
    C = hc * wc
    return (rf_k.reshape(B, C, hd).to(qkv.dtype),
            beta.reshape(B, C, hd).to(qkv.dtype))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.eva_summaries_launch.argtypes = [ptr] * 11 + [i32] * 12 + [ptr]
    lib.eva_summaries_launch.restype = i32
    lib.eva_summaries_smem_bytes.argtypes = [i32] * 4
    lib.eva_summaries_smem_bytes.restype = i32
    lib.eva_summaries_mma_smem_bytes.argtypes = [i32] * 7
    lib.eva_summaries_mma_smem_bytes.restype = i32
    lib.eva_summaries_mma_blocks_per_sm.argtypes = [i32] * 4
    lib.eva_summaries_mma_blocks_per_sm.restype = i32
    lib.eva_summaries_error_string.argtypes = [i32]
    lib.eva_summaries_error_string.restype = ctypes.c_char_p
    return lib


def adaptive_operands(like: torch.Tensor, d: int, wq, bq, wk, bk, lnq_scale,
                      lnq_bias, lnk_scale, lnk_bias, use_ln: bool,
                      what: str) -> Sequence[Optional[torch.Tensor]]:
    """The adaptive Dense (+ LN) weights as the kernels take them: f32,
    contiguous, on ``like``'s device, of their shapes; the LN four None
    unless ``use_ln``."""
    def operand(t, shape, name):
        if t is None:
            raise ValueError(f"{what} needs {name}")
        if t.device != like.device:
            raise ValueError(f"{name} is on {t.device}, the input on {like.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        return t.to(torch.float32).contiguous()

    weights = [operand(wq, (d, d), "wq"), operand(bq, (d,), "bq"),
               operand(wk, (d, d), "wk"), operand(bk, (d,), "bk")]
    if use_ln:
        weights += [operand(lnq_scale, (d,), "lnq_scale"),
                    operand(lnq_bias, (d,), "lnq_bias"),
                    operand(lnk_scale, (d,), "lnk_scale"),
                    operand(lnk_bias, (d,), "lnk_bias")]
    return weights + [None] * (8 - len(weights))


def eva_summaries_packed(
    qkv: torch.Tensor,                   # [B, N, 3*H*D]
    wq: torch.Tensor, bq: torch.Tensor,  # adaptive_mu_q Dense [d, d] (in, out), [d]
    wk: torch.Tensor, bk: torch.Tensor,  # adaptive_mu_k Dense
    lnq_scale: Optional[torch.Tensor], lnq_bias: Optional[torch.Tensor],
    lnk_scale: Optional[torch.Tensor], lnk_bias: Optional[torch.Tensor],
    num_heads: int,
    gw: int,                             # token-grid width
    j: int,                              # chunk side
    use_ln: bool,
    *,
    config=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval chunk summaries ``(rf_k_bar, beta)``, each ``[B, C, H*D]`` in
    qkv's dtype.  A CPU tensor goes to the plain version; a CUDA tensor
    launches the kernel or raises.  ``config`` (to time the routes) forces
    the first kernel (0) or a layout of the persistent route ((warps,
    stages, blocks an SM, teams)); by default ``mma_plan`` chooses."""
    args = (qkv, wq, bq, wk, bk, lnq_scale, lnq_bias, lnk_scale, lnk_bias,
            num_heads, gw, j, use_ln)
    if qkv.device.type == "cpu":
        return eva_summaries_packed_ref(*args)
    if qkv.device.type != "cuda":
        raise ValueError(f"eva_summaries runs on CUDA or CPU tensors, got {qkv.device}")
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, N, 3*H*D], got {tuple(qkv.shape)}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"eva_summaries takes float32 or bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    B, N, three_hd = qkv.shape
    nh = num_heads
    if three_hd % (3 * nh) or gw <= 0 or N % gw:
        raise ValueError(f"qkv {tuple(qkv.shape)} does not split into {nh} "
                         f"heads over a grid of width {gw}")
    d = three_hd // (3 * nh)
    gh = N // gw
    if plan(B, nh, gh, gw, j, d, qkv.element_size()) is None:
        raise ValueError(
            f"eva_summaries cannot take B={B}, grid {gh}x{gw}, chunk {j}, head "
            f"dim {d}, {qkv.dtype}; see supports_summaries")
    cfg = route_config(B, nh, gh, gw, j, d, qkv.element_size(), 0, config,
                       "eva_summaries")
    weights = adaptive_operands(qkv, d, wq, bq, wk, bk, lnq_scale, lnq_bias,
                                lnk_scale, lnk_bias, use_ln, "eva_summaries")
    C = (gh // j) * (gw // j)
    rf = torch.empty((B, C, nh * d), dtype=qkv.dtype, device=qkv.device)
    beta = torch.empty_like(rf)
    lib = _lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.eva_summaries_launch(
            qkv.data_ptr(), *[None if t is None else t.data_ptr() for t in weights],
            rf.data_ptr(), beta.data_ptr(), B, N, gw, j, nh, d, int(use_ln),
            int(qkv.dtype == torch.bfloat16), *cfg, stream)
    if rc != 0:
        raise RuntimeError(
            f"eva_summaries launch failed: {lib.eva_summaries_error_string(rc).decode()}")
    global LAUNCHES, LAUNCHES_MMA
    LAUNCHES += 1
    LAUNCHES_MMA += int(cfg[0] > 0)
    return rf, beta

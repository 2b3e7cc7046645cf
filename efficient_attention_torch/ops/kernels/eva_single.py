"""K2 ``eva_single``: 2-D EVA chunk summaries and joint softmax in one kernel.

Replaces ``efficient_attention_tpu/ops/pallas/eva_single.py::
eva_attention_single``, the kernel that the eval forward of every 2-D EVA
block goes through.  For each image and head it computes

* phase 1, the chunk summaries: the means of q and k over each ``j x j``
  chunk, ``rf_q = LN(mean_q Wq + bq)`` and ``rf_k = LN(mean_k Wk + bk)``
  (the adaptive Dense and LN act on ``head_dim`` and are shared by the
  heads), ``mu = (rf_q + rf_k) / 2``, and per chunk a softmax over its
  member tokens of ``<mu, k_t>/sqrt(d) - |k_t|^2/(2 sqrt(d))`` that weights
  their values into ``beta``;
* phase 2, the joint softmax: each query attends over its own window's keys
  (plus the RPE bias) and all ``C`` chunk keys ``rf_k``, with values
  ``[window v | beta]``, scaled by ``d**-0.5``.

The per-chunk softmax is shifted by its true maximum over the chunk's
members, as the JAX eager path does.  The TPU kernel shifts by the bound
``|mu|^2/(2 sqrt(d))`` instead, which underflows to ``beta = 0`` when every
member lies far from ``mu``; the two agree wherever that exp does not
underflow.  Phase 1 runs in f32 (the TPU kernel's bf16 operands there are no
more exact).  In bf16 phase 2 rounds as the TPU kernel does: ``rf_k`` and
``beta`` to bf16 as keys and values, the numerators ``exp(l - max)`` to
bf16 for the value product, over the f32 sum of the unrounded ones.

``eva_attention_single`` launches the CUDA kernel (``csrc/eva_single.cu``)
for a CUDA tensor, and raises where the kernel cannot take its input.  bf16
at head dims 16, 32 and 64 (``uses_mma``) takes the tensor-core kernel,
f32 and head dim 12 the CUDA-core one; ``plan`` names the route.  For a
CPU tensor it computes the same function with ``eva_attention_single_ref``,
the plain PyTorch version, which is also what the kernel is held against on
the card.  ``LAUNCHES`` counts the kernel's launches on either route,
``LAUNCHES_MMA`` those of the tensor-core kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from efficient_attention_torch.ops.kernels import _build

LAUNCHES = 0
LAUNCHES_MMA = 0

NAME = "eva_single"
SOURCE = "efficient_attention_torch/csrc/eva_single.cu"
REPLACES = "efficient_attention_tpu/ops/pallas/eva_single.py:388"

# the kernel's own limits: head dims it is instantiated for, threads per
# block, the shared memory a block may use on Hopper, and the cluster sizes
# it tries (largest first; portable cluster sizes go up to 8); the
# tensor-core route's head dims and cluster sizes
HEAD_DIMS = (12, 16, 32, 64)
THREADS = 128
SMEM_LIMIT = 232448
CLUSTER_SIZES = (8, 4, 2, 1)
MMA_HEAD_DIMS = (16, 32, 64)
MMA_CLUSTER_SIZES = (1, 2, 4, 8, 16)
# a block's shared memory that leaves three, or two, blocks an SM (228 KB an
# SM, 1 KB of it reserved a block); the kernel's 168 registers a thread
# allow three
MMA_SMEM_BLOCKS = {3: 233472 // 3 - 1024, 2: 233472 // 2 - 1024}
_MAX_GRID_YZ = 65535


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def uses_mma(d: int, itemsize: int) -> bool:
    """Whether bf16 (itemsize 2) or f32 (4) at head dim ``d`` takes the
    tensor-core kernel (``uses_mma`` in ``csrc/eva_single.cu``)."""
    return itemsize == 2 and d in MMA_HEAD_DIMS


def owned_chunks(cluster: int, wpb: int, nww: int, ws: int, j: int) -> int:
    """The most chunks a block of the cluster owns on the tensor-core route
    (``owned_chunks`` in ``csrc/eva_single.cu``): a chunk belongs to the
    block that holds its first token, so window ``w`` brings the chunks whose
    first row and column lie in it."""
    def own(w):
        wy, wx = (w // nww) * ws, (w % nww) * ws
        return (((wy + ws + j - 1) // j - (wy + j - 1) // j)
                * ((wx + ws + j - 1) // j - (wx + j - 1) // j))
    return max(sum(own(w) for w in range(r * wpb, r * wpb + wpb))
               for r in range(cluster))


def mma_smem_bytes(gh: int, gw: int, ws: int, j: int, d: int,
                   cluster: int) -> int:
    """Dynamic shared memory of one block of the tensor-core kernel; the
    same layout as ``make_mma_layout`` in ``csrc/eva_single.cu``, each region
    128-byte aligned: the block's q, k and v rows ``[T][d + 8]`` and the
    chunk rows rf_k and beta ``[C][d + 8]`` in bf16; the bias ``[S][S]`` in
    f32; the int32 token table ``[T]`` and owned chunks ``[CO]``; their
    members ``[CO][j * j]`` in uint16; their means ``[CO][2][d]``, mu and
    rf_k ``[CO][d]`` each and a warp's member weights ``[4][2][j * j]`` in
    f32."""
    nww = gw // ws
    wpb = (gh // ws) * nww // cluster
    S, T = ws * ws, wpb * ws * ws
    C = (gh // j) * (gw // j)
    CO, JJ, db = owned_chunks(cluster, wpb, nww, ws, j), j * j, d + 8
    return (3 * _align128(T * db * 2) + 2 * _align128(C * db * 2)
            + _align128(S * S * 4) + _align128(T * 4) + _align128(CO * 4)
            + _align128(CO * JJ * 2) + _align128(CO * 2 * d * 4)
            + 2 * _align128(CO * d * 4) + _align128(THREADS // 32 * 2 * JJ * 4))


def smem_bytes(tokens: int, d: int, itemsize: int, chunks: int,
               own_chunks: int, ws: int) -> int:
    """Dynamic shared memory of one block of the CUDA-core kernel; the same
    layout as ``make_layout`` in ``csrc/eva_single.cu``: the block's q/k/v rows, all
    chunk keys and values (f32), the chunks this block summarises (f32), the
    head's window bias (f32) and per-warp scratch."""
    warps = THREADS // 32
    return (_align16(tokens * 3 * d * itemsize)
            + 2 * _align16(chunks * d * 4)
            + 2 * _align16(own_chunks * d * 4)
            + _align16(ws * ws * ws * ws * 4)
            + _align16(warps * 2 * d * 4))


@functools.lru_cache(maxsize=1024)
def plan(B: int, num_heads: int, gh: int, gw: int, ws: int, j: int, d: int,
         itemsize: int, *, cuda_cores: bool = False) -> Optional[Tuple[int, int, bool]]:
    """``(cluster_size, smem_bytes, tensor_cores)`` for a launch, or None
    where the kernel cannot take it.  A cluster of blocks shares one (image,
    head), each block holding ``windows / cluster`` whole windows.  The
    CUDA-core kernel takes the largest cluster size (up to 8) that divides
    the window count, the least memory, and the geometries it fits are the
    ones K2 takes.  bf16 at head dims 16, 32 and 64 (``uses_mma``) takes the
    tensor-core kernel; a geometry whose padded rows fit a block at no
    cluster size (blocks of hundreds of tokens, or one-token chunks) keeps
    the CUDA-core kernel.  ``cuda_cores`` forces the CUDA-core kernel, to
    time it beside the default.  Cached: the model's blocks ask at every
    forward."""
    if not 1 <= B <= _MAX_GRID_YZ or not 1 <= num_heads <= _MAX_GRID_YZ:
        return None
    if ws <= 0 or j <= 0 or gh % ws or gw % ws or gh % j or gw % j:
        return None
    if d not in HEAD_DIMS or itemsize not in (2, 4):
        return None
    n_win = (gh // ws) * (gw // ws)
    chunks = (gh // j) * (gw // j)
    cs = next(c for c in CLUSTER_SIZES if n_win % c == 0)
    smem = smem_bytes(n_win // cs * ws * ws, d, itemsize, chunks,
                      -(-chunks // cs), ws)
    if smem > SMEM_LIMIT:  # the geometries K2 takes stay what they were
        return None
    if uses_mma(d, itemsize) and not cuda_cores:
        # the cluster sizes whose padded rows fit a block, smallest first (a
        # member is rank << 12 | slot in 16 bits)
        fits = [(c, m) for c in MMA_CLUSTER_SIZES
                if n_win % c == 0 and n_win // c * ws * ws <= 4096
                for m in (mma_smem_bytes(gh, gw, ws, j, d, c),) if m <= SMEM_LIMIT]
        # the most windows a block among blocks of two windows or more, then
        # of one, that leave three blocks an SM, else two; else the least
        # memory.  A block's summaries and cluster barriers are a fixed cost
        # that its strips share (a window of 49 rows has 4).  At the models'
        # five shapes on the H100 this picks the fastest cluster size that
        # scripts/torch_eva_single_phases.py measures (PERF.md)
        for windows, blocks in ((2, 3), (2, 2), (1, 3), (1, 2)):
            ok = [(c, m) for c, m in fits
                  if n_win // c >= windows and m <= MMA_SMEM_BLOCKS[blocks]]
            if ok:
                return ok[0][0], ok[0][1], True
        if fits:
            c, m = min(fits, key=lambda f: f[1])
            return c, m, True
    return (cs, smem, False) if smem <= SMEM_LIMIT else None


def supports_single(B: int, gh: int, gw: int, ws: int, j: int,
                    adaptive_proj: str, three_hd: int, num_heads: int,
                    itemsize: int = 2) -> bool:
    """Geometry gate of the CUDA kernel: square windows and chunks dividing
    the grid, a head dim it is built for, a block's shared memory within
    Hopper's limit, and an adaptive projection of Dense (+ LN)."""
    if adaptive_proj not in ("default", "no-ln") or three_hd % (3 * num_heads):
        return False
    d = three_hd // (3 * num_heads)
    return plan(B, num_heads, gh, gw, ws, j, d, itemsize) is not None


def eva_attention_single_ref(
    qkv: torch.Tensor,                   # [B, N, 3*H*D]
    wq: torch.Tensor, bq: torch.Tensor,  # adaptive_mu_q Dense [d, d] (in, out), [d]
    wk: torch.Tensor, bk: torch.Tensor,  # adaptive_mu_k Dense
    lnq_scale: Optional[torch.Tensor], lnq_bias: Optional[torch.Tensor],
    lnk_scale: Optional[torch.Tensor], lnk_bias: Optional[torch.Tensor],
    scale: float,
    num_heads: int,
    gw: int,
    ws: int,
    j: int,
    use_ln: bool,
    bias: Optional[torch.Tensor] = None,  # [H, S, S] window RPE bias
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function in f32 tensor
    ops, output in the input dtype.  Below f32 it rounds as the TPU kernel
    does: ``rf_k`` and ``beta`` to the input dtype as keys and values, the
    numerators ``exp(l - max)`` to it for the value product, divided after
    the product by the f32 sum of the unrounded ones.  Returns
    ``[B, N, H*D]``."""
    B, N, three_hd = qkv.shape
    nh = num_heads
    hd = three_hd // 3
    d = hd // nh
    gh = N // gw
    hc, wc = gh // j, gw // j
    C = hc * wc
    gwin_h, gwin_w = gh // ws, gw // ws
    S = ws * ws
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
    rf_k = rf_k.reshape(B, C, nh, d).transpose(1, 2)  # [B, nh, C, d]
    beta = beta.reshape(B, C, nh, d).transpose(1, 2)

    def windows(t):  # [B, gh, gw, nh, d] -> [B, nh, G, S, d]
        return (t.reshape(B, gwin_h, ws, gwin_w, ws, nh, d)
                .permute(0, 5, 1, 3, 2, 4, 6).reshape(B, nh, -1, S, d))

    low = qkv.dtype != torch.float32
    if low:  # the TPU kernel's keys and values: rfh.astype(kh.dtype)
        rf_k = rf_k.to(qkv.dtype).float()
        beta = beta.to(qkv.dtype).float()
    w_q, w_k, w_v = windows(q), windows(k), windows(v)
    local = torch.einsum("bhgsd,bhgtd->bhgst", w_q, w_k) * scale
    if bias is not None:
        local = local + f32(bias)[None, :, None]
    chunk = torch.einsum("bhgsd,bhcd->bhgsc", w_q, rf_k) * scale
    logits = torch.cat([local, chunk], dim=-1)
    if low:  # p.astype(vals.dtype) before the value product, f32 denominator
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        pr = p.to(qkv.dtype).float()
        out = (torch.einsum("bhgst,bhgtd->bhgsd", pr[..., :S], w_v)
               + torch.einsum("bhgsc,bhcd->bhgsd", pr[..., S:], beta)
               ) / p.sum(dim=-1, keepdim=True)
    else:
        attn = torch.softmax(logits, dim=-1)
        out = (torch.einsum("bhgst,bhgtd->bhgsd", attn[..., :S], w_v)
               + torch.einsum("bhgsc,bhcd->bhgsd", attn[..., S:], beta))
    out = (out.reshape(B, nh, gwin_h, gwin_w, ws, ws, d)
           .permute(0, 2, 4, 3, 5, 1, 6).reshape(B, N, hd))
    return out.to(qkv.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.eva_single_launch.argtypes = [ptr] * 11 + [i32] * 10 + [ctypes.c_float, ptr]
    lib.eva_single_launch.restype = i32
    lib.eva_single_mma_launch.argtypes = [ptr] * 11 + [i32] * 9 + [ctypes.c_float, ptr]
    lib.eva_single_mma_launch.restype = i32
    lib.eva_single_smem_bytes.argtypes = [i32] * 6
    lib.eva_single_smem_bytes.restype = i32
    lib.eva_single_uses_mma.argtypes = [i32] * 2
    lib.eva_single_uses_mma.restype = i32
    lib.eva_single_mma_smem_bytes.argtypes = [i32] * 6
    lib.eva_single_mma_smem_bytes.restype = i32
    lib.eva_single_mma_blocks_per_sm.argtypes = [i32] * 6
    lib.eva_single_mma_blocks_per_sm.restype = i32
    lib.eva_single_error_string.argtypes = [i32]
    lib.eva_single_error_string.restype = ctypes.c_char_p
    return lib


def eva_attention_single(
    qkv: torch.Tensor,                   # [B, N, 3*H*D]
    wq: torch.Tensor, bq: torch.Tensor,  # adaptive_mu_q Dense [d, d] (in, out), [d]
    wk: torch.Tensor, bk: torch.Tensor,  # adaptive_mu_k Dense
    lnq_scale: Optional[torch.Tensor], lnq_bias: Optional[torch.Tensor],
    lnk_scale: Optional[torch.Tensor], lnk_bias: Optional[torch.Tensor],
    scale: float,
    num_heads: int,
    gw: int,                             # token-grid width
    ws: int,                             # window side
    j: int,                              # chunk side
    use_ln: bool,
    bias: Optional[torch.Tensor] = None,  # [H, S, S] window RPE bias
    *,
    cuda_cores: bool = False,
) -> torch.Tensor:
    """Single-pass EVA eval forward; returns ``[B, N, H*D]`` in qkv's dtype.

    A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernel of the route ``plan`` names or raises.  ``cuda_cores`` forces the
    CUDA-core kernel, to time it beside the default; nothing on a model's
    path sets it."""
    args = (qkv, wq, bq, wk, bk, lnq_scale, lnq_bias, lnk_scale, lnk_bias,
            scale, num_heads, gw, ws, j, use_ln)
    if qkv.device.type == "cpu":
        return eva_attention_single_ref(*args, bias=bias)
    if qkv.device.type != "cuda":
        raise ValueError(f"eva_single runs on CUDA or CPU tensors, got {qkv.device}")
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, N, 3*H*D], got {tuple(qkv.shape)}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"eva_single takes float32 or bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    B, N, three_hd = qkv.shape
    nh = num_heads
    if three_hd % (3 * nh) or N % gw:
        raise ValueError(f"qkv {tuple(qkv.shape)} does not split into {nh} "
                         f"heads over a grid of width {gw}")
    d = three_hd // (3 * nh)
    gh = N // gw
    geometry = plan(B, nh, gh, gw, ws, j, d, qkv.element_size(),
                    cuda_cores=cuda_cores)
    if geometry is None:
        raise ValueError(
            f"eva_single cannot take B={B}, grid {gh}x{gw}, window {ws}, "
            f"chunk {j}, head dim {d}, {qkv.dtype}; see supports_single")
    cluster, _, mma = geometry

    def operand(t, shape, what):
        if t is None:
            raise ValueError(f"eva_single needs {what}")
        if t.device != qkv.device:
            raise ValueError(f"{what} is on {t.device}, qkv on {qkv.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} must be {shape}, got {tuple(t.shape)}")
        return t.to(torch.float32).contiguous()

    weights = [operand(wq, (d, d), "wq"), operand(bq, (d,), "bq"),
               operand(wk, (d, d), "wk"), operand(bk, (d,), "bk")]
    if use_ln:
        weights += [operand(lnq_scale, (d,), "lnq_scale"),
                    operand(lnq_bias, (d,), "lnq_bias"),
                    operand(lnk_scale, (d,), "lnk_scale"),
                    operand(lnk_bias, (d,), "lnk_bias")]
    if bias is not None:
        bias = operand(bias, (nh, ws * ws, ws * ws), "bias")
    ptrs = [t.data_ptr() for t in weights] + [None] * (8 - len(weights))
    out = torch.empty((B, N, nh * d), dtype=qkv.dtype, device=qkv.device)
    lib = _lib()
    operands = (qkv.data_ptr(), out.data_ptr(), *ptrs,
                None if bias is None else bias.data_ptr(),
                B, N, gw, ws, j, nh, d, cluster, int(use_ln))
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        if mma:
            rc = lib.eva_single_mma_launch(*operands, float(scale), stream)
        else:
            rc = lib.eva_single_launch(*operands, int(qkv.dtype == torch.bfloat16),
                                       float(scale), stream)
    if rc != 0:
        raise RuntimeError(
            f"eva_single launch failed: {lib.eva_single_error_string(rc).decode()}")
    global LAUNCHES, LAUNCHES_MMA
    LAUNCHES += 1
    LAUNCHES_MMA += int(mma)
    return out

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
underflow.

``eva_attention_single`` launches the CUDA kernel (``csrc/eva_single.cu``)
for a CUDA tensor, and raises where the kernel cannot take its input.  For a
CPU tensor it computes the same function with ``eva_attention_single_ref``,
the plain PyTorch version, which is also what the kernel is held against on
the card.  ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from efficient_attention_torch.ops.kernels import _build

LAUNCHES = 0

NAME = "eva_single"
SOURCE = "efficient_attention_torch/csrc/eva_single.cu"
REPLACES = "efficient_attention_tpu/ops/pallas/eva_single.py:388"

# the kernel's own limits: head dims it is instantiated for, threads per
# block, the shared memory a block may use on Hopper, and the cluster sizes
# it tries (largest first; portable cluster sizes go up to 8)
HEAD_DIMS = (12, 16, 32, 64)
THREADS = 128
SMEM_LIMIT = 232448
CLUSTER_SIZES = (8, 4, 2, 1)
_MAX_GRID_YZ = 65535


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(tokens: int, d: int, itemsize: int, chunks: int,
               own_chunks: int, ws: int) -> int:
    """Dynamic shared memory of one block; the same layout as
    ``make_layout`` in ``csrc/eva_single.cu``: the block's q/k/v rows, all
    chunk keys and values (f32), the chunks this block summarises (f32), the
    head's window bias (f32) and per-warp scratch."""
    warps = THREADS // 32
    return (_align16(tokens * 3 * d * itemsize)
            + 2 * _align16(chunks * d * 4)
            + 2 * _align16(own_chunks * d * 4)
            + _align16(ws * ws * ws * ws * 4)
            + _align16(warps * 2 * d * 4))


def plan(B: int, num_heads: int, gh: int, gw: int, ws: int, j: int, d: int,
         itemsize: int) -> Optional[Tuple[int, int]]:
    """``(cluster_size, smem_bytes)`` for a launch, or None where the
    kernel cannot take it.  A cluster of blocks shares one (image, head):
    each block holds ``windows / cluster`` whole windows, so the largest
    cluster size that divides the window count gives the least memory."""
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
    return (cs, smem) if smem <= SMEM_LIMIT else None


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
    ops, output in the input dtype.  Returns ``[B, N, H*D]``."""
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

    w_q, w_k, w_v = windows(q), windows(k), windows(v)
    local = torch.einsum("bhgsd,bhgtd->bhgst", w_q, w_k) * scale
    if bias is not None:
        local = local + f32(bias)[None, :, None]
    chunk = torch.einsum("bhgsd,bhcd->bhgsc", w_q, rf_k) * scale
    attn = torch.softmax(torch.cat([local, chunk], dim=-1), dim=-1)
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
    lib.eva_single_smem_bytes.argtypes = [i32] * 6
    lib.eva_single_smem_bytes.restype = i32
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
) -> torch.Tensor:
    """Single-pass EVA eval forward; returns ``[B, N, H*D]`` in qkv's dtype.

    A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernel or raises."""
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
    geometry = plan(B, nh, gh, gw, ws, j, d, qkv.element_size())
    if geometry is None:
        raise ValueError(
            f"eva_single cannot take B={B}, grid {gh}x{gw}, window {ws}, "
            f"chunk {j}, head dim {d}, {qkv.dtype}; see supports_single")
    cluster, _ = geometry

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
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.eva_single_launch(
            qkv.data_ptr(), out.data_ptr(), *ptrs,
            None if bias is None else bias.data_ptr(),
            B, N, gw, ws, j, nh, d, cluster, int(use_ln),
            int(qkv.dtype == torch.bfloat16), float(scale), stream)
    if rc != 0:
        raise RuntimeError(
            f"eva_single launch failed: {lib.eva_single_error_string(rc).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    return out

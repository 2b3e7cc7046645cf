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
``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from efficient_attention_torch.ops.kernels import _build

LAUNCHES = 0

NAME = "eva_summaries"
SOURCE = "efficient_attention_torch/csrc/eva_summaries.cu"
REPLACES = "efficient_attention_tpu/ops/pallas/eva_summaries.py:217"

# the kernel's own limits: head dims it is instantiated for, threads per
# block and the shared memory a block may use on Hopper
HEAD_DIMS = (12, 16, 32, 64)
THREADS = 256
SMEM_LIMIT = 232448
_MAX_GRID_YZ = 65535


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


def supports_summaries(B: int, gh: int, gw: int, j: int, adaptive_proj: str,
                       three_hd: int, num_heads: int, itemsize: int = 2) -> bool:
    """Geometry gate of the kernel (JAX ``supports_summaries``, with the head
    dim, element size and shared memory that the kernel is built for)."""
    if adaptive_proj not in ("default", "no-ln") or three_hd % (3 * num_heads):
        return False
    d = three_hd // (3 * num_heads)
    return plan(B, num_heads, gh, gw, j, d, itemsize) is not None


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
    lib.eva_summaries_launch.argtypes = [ptr] * 11 + [i32] * 8 + [ptr]
    lib.eva_summaries_launch.restype = i32
    lib.eva_summaries_smem_bytes.argtypes = [i32] * 4
    lib.eva_summaries_smem_bytes.restype = i32
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval chunk summaries ``(rf_k_bar, beta)``, each ``[B, C, H*D]`` in
    qkv's dtype.  A CPU tensor goes to the plain version; a CUDA tensor
    launches the kernel or raises."""
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
            int(qkv.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(
            f"eva_summaries launch failed: {lib.eva_summaries_error_string(rc).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    return rf, beta

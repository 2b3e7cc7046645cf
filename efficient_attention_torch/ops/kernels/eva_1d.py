"""K4 ``eva_1d``: the 1-D EVA joint softmax with a halo and a key-padding mask.

Replaces ``efficient_attention_tpu/ops/pallas/eva_1d.py::eva_attention_1d``,
the kernel that every encoder layer of the WMT translation model (EVA, 1-D
overlapping windows, T5 bias, padded sentence batches) goes through at eval.
From the packed projection output ``qkv [B, N, 3*H*D]`` (``N`` a multiple of
the window ``ws``) each query attends in one softmax over the ``ws + 2*ext``
halo'd keys of its own window, plus the per-head bias ``[H, ws, ws + 2*ext]``
(T5 or learned), and over the ``C`` chunk keys ``rf_k_bar [B, C, H*D]`` with
values ``beta [B, C, H*D]``.  Local columns that are padding (``mask [B, N]``,
True = pad) get ``MASK_VAL`` added; columns outside ``[0, N)`` get
``MASK_VAL`` with zero keys and values; chunk columns are never masked.  The
output is ``[B, N, H*D]`` in qkv's dtype.

Roundings follow the TPU kernel: f32 logits, ``p = exp(logit - max)`` in f32,
``p`` rounded to qkv's dtype before its product with ``[v | beta]``, the
product summed in f32 and divided by the f32 sum of the unrounded ``p`` last
(K4 normalises after its product; K7 before).  At a query that is not
padding the masked columns get exactly 0, so there the function equals the
eager path's, which replaces masked logits by ``MASK_VAL`` instead of adding
it.

``eva_attention_1d`` launches the CUDA kernel (``csrc/eva_1d.cu``) for CUDA
tensors and raises where it cannot take them; for CPU tensors it computes
the same function with ``eva_1d_ref``, the plain PyTorch version, which is
also what the kernel is held against on the card.  The kernel serves eval
only (the JAX kernel has no VJP): the wrapper raises if asked for a
gradient.  ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from efficient_attention_torch.ops import windows as W
from efficient_attention_torch.ops.kernels import _build

LAUNCHES = 0

NAME = "eva_1d"
SOURCE = "efficient_attention_torch/csrc/eva_1d.cu"
REPLACES = "efficient_attention_tpu/ops/pallas/eva_1d.py:214"

MASK_VAL = -5e4
HEAD_DIMS = (16, 32, 64, 128)
SMEM_LIMIT = 232448
# query rows a block (whole windows): at the WMT shapes 16 measured as fast
# as 64 at N=32 and 1.6x faster at N=256 (PERF.md)
ROWS_PER_BLOCK = 16
_WARPS = 4
_MAX_GRID_YZ = 65535


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(d: int, ws: int, ext: int, C: int, wpb: int) -> int:
    """Dynamic shared memory of one block; the same layout as
    ``make_layout`` in ``csrc/eva_1d.cu``: the run's ``wpb * ws`` q rows, its
    k and v rows with the halos, the chunk keys and values (all f32 rows of
    ``d + 1``), the bias table, the additive key mask and one row of
    ``ws + 2*ext + C`` logits a warp."""
    DP, R, L = d + 1, wpb * ws, ws + 2 * ext
    KR = R + 2 * ext
    return (_align16(R * DP * 4) + 2 * _align16(KR * DP * 4)
            + 2 * _align16(C * DP * 4) + _align16(ws * L * 4)
            + _align16(KR * 4) + _align16(_WARPS * (L + C) * 4))


def plan(B: int, N: int, ws: int, ext: int, C: int, num_heads: int, d: int,
         itemsize: int) -> Optional[int]:
    """Windows per block for a launch, or None where the kernel cannot take
    the geometry: ``N`` a multiple of ``ws``, at least one chunk, a head dim
    it is built for, float32 or bfloat16, the grid within its limits and
    the block within Hopper's shared memory."""
    if not 1 <= B <= _MAX_GRID_YZ or not 1 <= num_heads <= _MAX_GRID_YZ:
        return None
    if ws <= 0 or ext < 0 or C <= 0 or N <= 0 or N % ws:
        return None
    if d not in HEAD_DIMS or itemsize not in (2, 4):
        return None
    wpb = max(1, min(N // ws, ROWS_PER_BLOCK // ws))
    if smem_bytes(d, ws, ext, C, wpb) > SMEM_LIMIT:
        return None
    return wpb


def supports_1d(B: int, N: int, ws: int, ext: int, C: int, num_heads: int,
                head_dim: int, itemsize: int = 4) -> bool:
    """Geometry gate of the kernel (JAX ``supports_1d``, with the head dims,
    element sizes and shared memory of this kernel)."""
    return plan(B, N, ws, ext, C, num_heads, head_dim, itemsize) is not None


def eva_1d_ref(qkv: torch.Tensor, rf_k_bar: torch.Tensor, beta: torch.Tensor,
               key_padding_mask: Optional[torch.Tensor], scale: float,
               num_heads: int, ws: int, ext: int,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version (the counterpart of ``_kernel``): the same
    function and roundings in f32 tensor ops; ``[B, N, H*D]`` in qkv's
    dtype."""
    T = qkv.dtype
    B, N, three_hd = qkv.shape
    H = num_heads
    d = three_hd // (3 * H)
    G, L = N // ws, ws + 2 * ext

    def heads(t):  # [B, n, H*d] -> [B, H, n, d] in f32
        return t.to(T).float().reshape(B, -1, H, d).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.chunk(3, dim=-1))
    w_q = q.reshape(B, H, G, ws, d)
    w_k = W.window_1d_partition(k, ws, ext)  # zero outside [0, N)
    w_v = W.window_1d_partition(v, ws, ext)
    # additive key mask [B, G, L]: MASK_VAL outside [0, N) and on padding
    pos = (torch.arange(G, device=qkv.device)[:, None] * ws - ext
           + torch.arange(L, device=qkv.device)[None, :])
    add = torch.where((pos >= 0) & (pos < N), 0.0, MASK_VAL).expand(B, G, L)
    if key_padding_mask is not None:
        pad = W.window_1d_partition(key_padding_mask.float()[:, :, None], ws, ext)
        add = add + MASK_VAL * pad[..., 0]
    local = torch.einsum("bhgid,bhgjd->bhgij", w_q, w_k) * scale
    if bias is not None:
        local = local + bias.float()[None, :, None]
    local = local + add[:, None, :, None, :]
    rf, bt = heads(rf_k_bar), heads(beta)
    chunk = torch.einsum("bhgid,bhcd->bhgic", w_q, rf) * scale
    logits = torch.cat([local, chunk], dim=-1)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True)
    pr = p.to(T).float()
    out = (torch.einsum("bhgij,bhgjd->bhgid", pr[..., :L], w_v)
           + torch.einsum("bhgic,bhcd->bhgid", pr[..., L:], bt)) / den
    return out.reshape(B, H, N, d).transpose(1, 2).reshape(B, N, H * d).to(T)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.eva_1d_launch.argtypes = [ptr] * 6 + [i32] * 9 + [ctypes.c_float, ptr]
    lib.eva_1d_launch.restype = i32
    lib.eva_1d_smem_bytes.argtypes = [i32] * 5
    lib.eva_1d_smem_bytes.restype = i32
    lib.eva_1d_error_string.argtypes = [i32]
    lib.eva_1d_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(qkv, rf_k_bar, beta, key_padding_mask, scale, num_heads, ws, ext,
            bias):
    if qkv.dim() != 3 or qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qkv must be a float32 or bfloat16 [B, N, 3*H*D], got "
                         f"{qkv.dtype} {tuple(qkv.shape)}")
    B, N, three_hd = qkv.shape
    nh = num_heads
    if three_hd % (3 * nh):
        raise ValueError(f"qkv {tuple(qkv.shape)} does not split into {nh} heads")
    d = three_hd // (3 * nh)
    C = rf_k_bar.shape[1]
    if (rf_k_bar.shape != (B, C, nh * d) or beta.shape != (B, C, nh * d)
            or rf_k_bar.device != qkv.device or beta.device != qkv.device):
        raise ValueError(f"rf_k_bar and beta must be {(B, C, nh * d)} on "
                         f"{qkv.device}, got {tuple(rf_k_bar.shape)} and "
                         f"{tuple(beta.shape)}")
    wpb = plan(B, N, ws, ext, C, nh, d, qkv.element_size())
    if wpb is None:
        raise ValueError(f"eva_1d cannot take B={B}, N={N}, window {ws}, halo "
                         f"{ext}, {C} chunks, head dim {d}, {qkv.dtype}; see "
                         "supports_1d")
    L = ws + 2 * ext
    if bias is not None and (tuple(bias.shape) != (nh, ws, L)
                             or bias.device != qkv.device):
        raise ValueError(f"bias must be {(nh, ws, L)} on {qkv.device}, got "
                         f"{tuple(bias.shape)} on {bias.device}")
    if key_padding_mask is not None and (
            tuple(key_padding_mask.shape) != (B, N)
            or key_padding_mask.device != qkv.device):
        raise ValueError(f"key_padding_mask must be {(B, N)} on {qkv.device}, "
                         f"got {tuple(key_padding_mask.shape)}")
    # the kernel reads 16-byte pieces: contiguous, 16-byte aligned operands
    qkv, rf_k_bar, beta = (_aligned(t.to(qkv.dtype)) for t in (qkv, rf_k_bar, beta))
    mask = (None if key_padding_mask is None  # a bool is one byte, 0 or 1
            else key_padding_mask.to(torch.bool).contiguous())
    bias = None if bias is None else bias.to(torch.float32).contiguous()
    out = torch.empty((B, N, nh * d), dtype=qkv.dtype, device=qkv.device)
    lib = _lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.eva_1d_launch(
            qkv.data_ptr(), rf_k_bar.data_ptr(), beta.data_ptr(),
            None if mask is None else mask.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, N, nh, d, ws, ext, C, wpb, int(qkv.dtype == torch.bfloat16),
            float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"eva_1d launch failed: {lib.eva_1d_error_string(rc).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def eva_attention_1d(
    qkv: torch.Tensor,        # [B, N, 3*H*D], N a multiple of ws
    rf_k_bar: torch.Tensor,   # [B, C, H*D]
    beta: torch.Tensor,       # [B, C, H*D]
    key_padding_mask: Optional[torch.Tensor],  # [B, N] bool, True = pad
    scale: float,
    num_heads: int,
    ws: int,
    ext: int,
    bias: Optional[torch.Tensor] = None,  # [H, ws, ws + 2*ext] local bias
) -> torch.Tensor:
    """Halo'd, padding-masked 1-D EVA joint softmax; returns ``[B, N, H*D]``
    in qkv's dtype.  Eval only: raises if a gradient is asked for.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (qkv, rf_k_bar, beta, bias)):
        raise RuntimeError("eva_attention_1d has no backward (the kernel serves "
                           "eval); run it under torch.no_grad()")
    if qkv.device.type == "cpu":
        return eva_1d_ref(qkv, rf_k_bar, beta, key_padding_mask, scale,
                          num_heads, ws, ext, bias)
    if qkv.device.type != "cuda":
        raise ValueError(f"eva_1d runs on CUDA or CPU tensors, got {qkv.device}")
    return _launch(qkv, rf_k_bar, beta, key_padding_mask, scale, int(num_heads),
                   int(ws), int(ext), bias)

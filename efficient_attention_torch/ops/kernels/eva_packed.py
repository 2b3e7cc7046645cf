"""K1 ``eva_packed``: the 2-D EVA joint softmax of the training step.

Replaces ``efficient_attention_tpu/ops/pallas/eva_packed.py::
eva_attention_packed``, the kernel that every EVA block of the training step
goes through, with its fused backward.  From the packed projection output
``qkv [B, N, 3*H*D]`` and the chunk summaries ``rf_k_bar, beta [B, C, H*D]``
each query attends over its own window's keys (plus the window RPE bias
``[H, S, S]``) and all ``C`` chunk keys, with values ``[window v | beta]``,
in one softmax; the output is ``[B, N, H*D]``.

The TPU kernel computes this over row strips with masked cross-window
logits; the masked entries are exactly 0 after its softmax, so the
window-local form here is the same function.  Roundings follow the TPU
kernel: the chunk summaries are taken in qkv's dtype, the softmax
numerators (forward) and the normalised ``P`` and ``dS`` (backward) are
rounded to that dtype before the products that consume them, every sum is
f32, and the output is ``out / denom`` in f32, then cast.

``eva_attention_packed`` is a ``torch.autograd.Function``.  For CUDA
tensors its forward and backward launch the kernels of
``csrc/eva_packed.cu`` or raise; for CPU tensors they compute the same
function with ``eva_packed_fwd_ref`` and ``eva_packed_bwd_ref``, the plain
PyTorch versions (the backward in explicit formulas, not autograd), which
are also what the kernels are held against on the card.  The forward and
the backward have two routes each, chosen by ``fwd_uses_mma`` and
``bwd_uses_mma``: bf16 with a head dim that is a multiple of 16 runs on
tensor cores (mma.sync, per-warp softmax on the accumulator fragments),
everything else on CUDA cores in f32.  ``LAUNCHES_FWD`` and
``LAUNCHES_BWD`` count the kernels' launches on either route,
``LAUNCHES_FWD_MMA`` and ``LAUNCHES_BWD_MMA`` those on the tensor-core
route.

K9 ``eva_packed_out`` (``csrc/eva_packed_out.cu``) replaces
``eva_packed.py::eva_attention_packed_out``, the eval forward behind EVA's
``fuse_output_proj``: the forward above with the output projection
``out Wo + bo`` in the kernel (the attention output rounded to qkv's dtype
first, the projection summed in f32), so the ``[B, N, H*D]`` intermediate
never reaches device memory.  ``eva_attention_packed_out`` has no gradient;
its plain version is ``eva_packed_out_ref``, ``LAUNCHES_OUT`` counts its
launches and ``LAUNCHES_OUT_MMA`` those on its tensor-core route
(``out_uses_mma``: bf16, head dims a multiple of 16).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from efficient_attention_torch.ops import windows
from efficient_attention_torch.ops.kernels import _build

LAUNCHES_FWD = 0
LAUNCHES_FWD_MMA = 0
LAUNCHES_BWD = 0
LAUNCHES_BWD_MMA = 0
LAUNCHES_OUT = 0
LAUNCHES_OUT_MMA = 0

NAME = "eva_packed"
SOURCE = "efficient_attention_torch/csrc/eva_packed.cu"
REPLACES_FWD = "efficient_attention_tpu/ops/pallas/eva_packed.py:238"
REPLACES_BWD = "efficient_attention_tpu/ops/pallas/eva_packed.py:467"
NAME_OUT = "eva_packed_out"
SOURCE_OUT = "efficient_attention_torch/csrc/eva_packed_out.cu"
REPLACES_OUT = "efficient_attention_tpu/ops/pallas/eva_packed.py:288"

# the kernel's own limits: head dims it is instantiated for (multiples of
# 4, for its 16-byte shared-memory loads), the shared
# memory a block may use on Hopper, and the most windows a block takes in
# turn (the largest of WINDOWS_PER_BLOCK that divides the window count)
HEAD_DIMS = (12, 16, 32, 64)
SMEM_LIMIT = 232448
WINDOWS_PER_BLOCK = (4, 2, 1)
_MAX_GRID_YZ = 65535


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def bwd_uses_mma(d: int, itemsize: int) -> bool:
    """Whether the backward takes its tensor-core route (``bwd_uses_mma`` in
    ``csrc/eva_packed.cu``): bf16, and a head dim that is a multiple of 16."""
    return itemsize == 2 and d % 16 == 0


def fwd_uses_mma(d: int, itemsize: int) -> bool:
    """Whether the forward takes its tensor-core route (``fwd_uses_mma`` in
    ``csrc/eva_packed.cu``): bf16, and a head dim that is a multiple of 16."""
    return itemsize == 2 and d % 16 == 0


def row_stride(d: int) -> int:
    """Floats between rows of ``d`` in shared memory (``row_stride`` in
    ``csrc/eva_packed.cu``): a multiple of 4 that is 4 mod 8."""
    return ((d // 4 + 1) | 1) * 4


def smem_bytes(backward: bool, d: int, S: int, C: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of one block of the route that ``(backward, d,
    itemsize)`` takes.  CUDA-core route (``make_layout`` in
    ``csrc/eva_packed.cu``): keys ``[window k | rf]`` and values ``[window v
    | beta]``, the query rows, the logits and the bias, all f32, rows of
    ``d`` at ``row_stride(d)`` and logit rows padded by one float; the
    backward adds the g rows, ``dS``, and the block's dbias, drf and dbeta
    sums.  The backward's tensor-core route (``make_mma_layout``): q and g
    ``[S][d+8]``, keys and values ``[S+C][d+8]``, P and dS ``[S][KB]`` and a
    zero row ``[KB]`` in bf16 (``KB = round16(S+C) + 8``), the bias and
    dbias ``[S][S]`` and the drf and dbeta sums ``[C][d]`` in f32, the
    token index of each row of a block's windows ``[4][S]`` in int32, each
    region 128-byte aligned.  The forward's tensor-core route
    (``make_fwd_mma_layout``): a window's q, k and v rows ``[S][d+8]`` in two
    buffers each and the chunk rows rf and beta ``[C][d+8]`` in bf16, the
    bias ``[S][S]`` in f32, the token table, each region 128-byte aligned."""
    if not backward and fwd_uses_mma(d, itemsize):
        db = d + 8
        return (6 * _align128(S * db * 2) + 2 * _align128(C * db * 2)
                + _align128(S * S * 4) + _align128(max(WINDOWS_PER_BLOCK) * S * 4))
    if backward and bwd_uses_mma(d, itemsize):
        db, kb = d + 8, _round16(S + C) + 8
        return (2 * _align128(S * db * 2) + 2 * _align128((S + C) * db * 2)
                + 2 * _align128(S * kb * 2) + _align128(kb * 2)
                + 2 * _align128(S * S * 4) + 2 * _align128(C * d * 4)
                + _align128(max(WINDOWS_PER_BLOCK) * S * 4))
    rows_d = lambda n: _align16(n * row_stride(d) * 4)  # noqa: E731
    logits = _align16(S * (S + C + 1) * 4)
    total = 2 * rows_d(S + C) + rows_d(S) + logits + _align16(S * S * 4)
    if backward:
        return (total + rows_d(S) + logits + _align16(S * S * 4)
                + 2 * _align16(C * d * 4))
    return total + _align16(S * 4)


def plan(B: int, N: int, W: int, ws: int, C: int, num_heads: int, d: int,
         itemsize: int) -> Optional[int]:
    """Windows per block for a launch, or None where the kernels cannot take
    the geometry: square windows dividing a ``N/W x W`` grid, a head dim they
    are built for, float32 or bfloat16, and the blocks within Hopper's
    shared memory: the CUDA-core backward's (the largest of K1's layouts, so
    both types accept the same geometries) and the routes' own."""
    if not 1 <= B <= _MAX_GRID_YZ or not 1 <= num_heads <= _MAX_GRID_YZ:
        return None
    if W <= 0 or ws <= 0 or C <= 0 or N % W or (N // W) % ws or W % ws:
        return None
    if d not in HEAD_DIMS or itemsize not in (2, 4):
        return None
    if max(smem_bytes(True, d, ws * ws, C),
           smem_bytes(True, d, ws * ws, C, itemsize),
           smem_bytes(False, d, ws * ws, C, itemsize)) > SMEM_LIMIT:
        return None
    n_win = (N // W // ws) * (W // ws)
    return next(g for g in WINDOWS_PER_BLOCK if n_win % g == 0)


def supports_packed(B: int, N: int, W: int, ws: int, c: int, head_dim: int,
                    itemsize: int = 2, num_heads: int = 1) -> bool:
    """Geometry gate of the kernels (JAX ``supports_packed``, with the head
    dim and element size that the kernels are built for)."""
    return plan(B, N, W, ws, c, num_heads, head_dim, itemsize) is not None


def _windows(t: torch.Tensor, gh: int, gw: int, ws: int, nh: int
             ) -> torch.Tensor:
    """``[B, N, nh*d] -> [B, nh, G, S, d]`` in f32 (window-major)."""
    heads = t.float().reshape(t.shape[0], gh, gw, nh, -1).permute(0, 3, 1, 2, 4)
    return windows.window_2d_partition(heads, ws)


def _merge(t: torch.Tensor, gh: int, gw: int, ws: int) -> torch.Tensor:
    """Inverse of ``_windows``: ``[B, nh, G, S, d] -> [B, N, nh*d]``."""
    B, nh, _, _, d = t.shape
    grid = windows.window_2d_merge(t, ws, (gh, gw))  # [B, nh, gh, gw, d]
    return grid.permute(0, 2, 3, 1, 4).reshape(B, gh * gw, nh * d)


def _heads(t: torch.Tensor, nh: int) -> torch.Tensor:
    """``[B, C, nh*d] -> [B, nh, C, d]`` in f32."""
    B, C, hd = t.shape
    return t.float().reshape(B, C, nh, hd // nh).transpose(1, 2)


def _logits(qkv, rf, scale, nh, W, ws, bias):
    """Joint logits ``[B, nh, G, S, S + C]`` and the window q, k, v, rf."""
    B, N, _ = qkv.shape
    gh = N // W
    q, k, v = (_windows(t, gh, W, ws, nh) for t in qkv.chunk(3, dim=-1))
    rfh = _heads(rf.to(qkv.dtype), nh)
    local = torch.einsum("bhgsd,bhgtd->bhgst", q, k) * scale
    if bias is not None:
        local = local + bias.float()[None, :, None]
    chunk = torch.einsum("bhgsd,bhcd->bhgsc", q, rfh) * scale
    return torch.cat([local, chunk], dim=-1), q, k, v, rfh


def eva_packed_fwd_ref(qkv: torch.Tensor, rf_k_bar: torch.Tensor,
                       beta: torch.Tensor, scale: float, num_heads: int,
                       W: int, ws: int,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch forward (the counterpart of ``_kernel``): the same
    function and roundings as the kernel in f32 tensor ops.  Differentiable
    by autograd, which the tests hold the explicit backward against."""
    T = qkv.dtype
    gh = qkv.shape[1] // W
    S = ws * ws
    logits, _, _, v, _ = _logits(qkv, rf_k_bar, scale, num_heads, W, ws, bias)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    pr = p.to(T).float()
    bth = _heads(beta.to(T), num_heads)
    out = (torch.einsum("bhgst,bhgtd->bhgsd", pr[..., :S], v)
           + torch.einsum("bhgsc,bhcd->bhgsd", pr[..., S:], bth))
    return _merge(out / denom, gh, W, ws).to(T)


def eva_packed_bwd_ref(qkv: torch.Tensor, rf_k_bar: torch.Tensor,
                       beta: torch.Tensor, bias: Optional[torch.Tensor],
                       g: torch.Tensor, scale: float, num_heads: int, W: int,
                       ws: int) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch backward in explicit formulas (the counterpart of
    ``_bwd_kernel``): recompute the softmax ``P``, then ``dP = g vals^T``,
    ``dS = P (dP - sum(P dP))`` and its products.  Returns ``(dqkv, drf,
    dbeta, dbias)``: dqkv in qkv's dtype, drf/dbeta in the summaries'
    dtypes (computed in f32), dbias ``[H, S, S]`` summed over every window
    of every image (None without a bias)."""
    T = qkv.dtype
    gh = qkv.shape[1] // W
    S = ws * ws
    nh = num_heads
    logits, q, k, v, rfh = _logits(qkv, rf_k_bar, scale, nh, W, ws, bias)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    P = p / p.sum(dim=-1, keepdim=True)
    gw_ = _windows(g.to(T), gh, W, ws, nh)
    bth = _heads(beta.to(T), nh)
    dP = torch.cat([torch.einsum("bhgsd,bhgtd->bhgst", gw_, v),
                    torch.einsum("bhgsd,bhcd->bhgsc", gw_, bth)], dim=-1)
    dSf = P * (dP - (P * dP).sum(dim=-1, keepdim=True))
    dS = dSf.to(T).float()
    Pr = P.to(T).float()
    dq = scale * (torch.einsum("bhgst,bhgtd->bhgsd", dS[..., :S], k)
                  + torch.einsum("bhgsc,bhcd->bhgsd", dS[..., S:], rfh))
    dk = scale * torch.einsum("bhgst,bhgsd->bhgtd", dS[..., :S], q)
    dv = torch.einsum("bhgst,bhgsd->bhgtd", Pr[..., :S], gw_)
    drf = scale * torch.einsum("bhgsc,bhgsd->bhcd", dS[..., S:], q)
    dbeta = torch.einsum("bhgsc,bhgsd->bhcd", Pr[..., S:], gw_)
    dqkv = torch.cat([_merge(t, gh, W, ws) for t in (dq, dk, dv)], dim=-1)

    def packed(t):  # [B, nh, C, d] -> [B, C, nh*d]
        return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], -1)

    dbias = None
    if bias is not None:
        dbias = dSf[..., :S].sum(dim=(0, 2)).to(bias.dtype)
    return (dqkv.to(T), packed(drf).to(rf_k_bar.dtype),
            packed(dbeta).to(beta.dtype), dbias)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.eva_packed_fwd_launch.argtypes = ([ptr] * 5 + [i32] * 9
                                          + [ctypes.c_float, ptr])
    lib.eva_packed_fwd_launch.restype = i32
    lib.eva_packed_fwd_mma_launch.argtypes = ([ptr] * 5 + [i32] * 8
                                              + [ctypes.c_float, ptr])
    lib.eva_packed_fwd_mma_launch.restype = i32
    lib.eva_packed_bwd_launch.argtypes = ([ptr] * 9 + [i32] * 9
                                          + [ctypes.c_float, ptr])
    lib.eva_packed_bwd_launch.restype = i32
    lib.eva_packed_bwd_mma_launch.argtypes = ([ptr] * 9 + [i32] * 8
                                              + [ctypes.c_float, ptr])
    lib.eva_packed_bwd_mma_launch.restype = i32
    lib.eva_packed_smem_bytes.argtypes = [i32] * 5
    lib.eva_packed_smem_bytes.restype = i32
    for gate in (lib.bwd_uses_mma, lib.fwd_uses_mma):
        gate.argtypes = [i32] * 2
        gate.restype = i32
    lib.eva_packed_mma_blocks_per_sm.argtypes = [i32] * 4
    lib.eva_packed_mma_blocks_per_sm.restype = i32
    lib.eva_packed_error_string.argtypes = [i32]
    lib.eva_packed_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_operands(qkv, rf, beta, bias, num_heads, W, ws):
    """Checked, contiguous kernel operands and the launch geometry."""
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, N, 3*H*D], got {tuple(qkv.shape)}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"eva_packed takes float32 or bfloat16, got {qkv.dtype}")
    B, N, three_hd = qkv.shape
    nh = num_heads
    if three_hd % (3 * nh) or W <= 0 or N % W:
        raise ValueError(f"qkv {tuple(qkv.shape)} does not split into {nh} "
                         f"heads over a grid of width {W}")
    d = three_hd // (3 * nh)
    if rf.dim() != 3 or rf.shape[0] != B or rf.shape[2] != nh * d:
        raise ValueError(f"rf_k_bar must be [B, C, H*D], got {tuple(rf.shape)}")
    C = rf.shape[1]
    if tuple(beta.shape) != tuple(rf.shape):
        raise ValueError(f"beta {tuple(beta.shape)} != rf_k_bar {tuple(rf.shape)}")
    wpb = plan(B, N, W, ws, C, nh, d, qkv.element_size())
    if wpb is None:
        raise ValueError(
            f"eva_packed cannot take B={B}, grid {N // W}x{W}, window {ws}, "
            f"{C} chunks, head dim {d}, {qkv.dtype}; see supports_packed")
    for t, what in ((rf, "rf_k_bar"), (beta, "beta"), (bias, "bias")):
        if t is not None and t.device != qkv.device:
            raise ValueError(f"{what} is on {t.device}, qkv on {qkv.device}")
    if bias is not None and tuple(bias.shape) != (nh, ws * ws, ws * ws):
        raise ValueError(f"bias must be {(nh, ws * ws, ws * ws)}, got "
                         f"{tuple(bias.shape)}")
    qkv = qkv.contiguous()
    rf = rf.to(qkv.dtype).contiguous()
    beta = beta.to(qkv.dtype).contiguous()
    bias = None if bias is None else bias.to(torch.float32).contiguous()
    return qkv, rf, beta, bias, (B, N, nh, d, C, wpb)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"eva_packed {what} launch failed: "
                           f"{_lib().eva_packed_error_string(rc).decode()}")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (the tensor-core routes
    copy rows 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fwd_operands(qkv, rf, beta, bias, num_heads, W, ws, cuda_cores=False):
    """The forward's checked operands, launch geometry and route (True for
    the tensor-core one), or a ValueError before anything is launched."""
    qkv, rf, beta, bias, geometry = _cuda_operands(qkv, rf, beta, bias,
                                                   num_heads, W, ws)
    uses_mma = not cuda_cores and fwd_uses_mma(geometry[3], qkv.element_size())
    if uses_mma:
        qkv, rf, beta = (_aligned16(t) for t in (qkv, rf, beta))
    return qkv, rf, beta, bias, geometry, uses_mma


def _forward(qkv, rf, beta, bias, scale, num_heads, W, ws,
             cuda_cores: bool = False):
    """The forward on the route ``fwd_uses_mma`` picks, or with
    ``cuda_cores`` on the CUDA-core route whatever the type (to time and
    check it beside the tensor-core one)."""
    if qkv.device.type == "cpu":
        return eva_packed_fwd_ref(qkv, rf, beta, scale, num_heads, W, ws, bias)
    if qkv.device.type != "cuda":
        raise ValueError(f"eva_packed runs on CUDA or CPU tensors, got {qkv.device}")
    qkv, rf, beta, bias, (B, N, nh, d, C, wpb), uses_mma = _fwd_operands(
        qkv, rf, beta, bias, num_heads, W, ws, cuda_cores)
    out = torch.empty((B, N, nh * d), dtype=qkv.dtype, device=qkv.device)
    lib = _lib()
    pointers = (qkv.data_ptr(), rf.data_ptr(), beta.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr())
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        if uses_mma:
            rc = lib.eva_packed_fwd_mma_launch(
                *pointers, B, N, W, ws, nh, d, C, wpb, float(scale), stream)
        else:
            rc = lib.eva_packed_fwd_launch(
                *pointers, B, N, W, ws, nh, d, C, wpb,
                int(qkv.dtype == torch.bfloat16), float(scale), stream)
    _check(rc, "forward")
    global LAUNCHES_FWD, LAUNCHES_FWD_MMA
    LAUNCHES_FWD += 1
    LAUNCHES_FWD_MMA += int(uses_mma)
    return out


def _backward(qkv, rf, beta, bias, g, scale, num_heads, W, ws,
              cuda_cores: bool = False):
    """The backward on the route ``bwd_uses_mma`` picks, or with
    ``cuda_cores`` on the CUDA-core route whatever the type (to time it
    beside the tensor-core one)."""
    if qkv.device.type == "cpu":
        return eva_packed_bwd_ref(qkv, rf, beta, bias, g, scale, num_heads, W, ws)
    if qkv.device.type != "cuda":
        raise ValueError(f"eva_packed runs on CUDA or CPU tensors, got {qkv.device}")
    rf_dtype, beta_dtype = rf.dtype, beta.dtype
    bias_dtype = None if bias is None else bias.dtype
    qkv, rf, beta, bias, (B, N, nh, d, C, wpb) = _cuda_operands(
        qkv, rf, beta, bias, num_heads, W, ws)
    if tuple(g.shape) != (B, N, nh * d) or g.device != qkv.device:
        raise ValueError(f"g must be [{B}, {N}, {nh * d}] on {qkv.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    g = g.to(qkv.dtype).contiguous()
    uses_mma = not cuda_cores and bwd_uses_mma(d, qkv.element_size())
    if uses_mma:
        qkv, rf, beta, g = (_aligned16(t) for t in (qkv, rf, beta, g))
    S = ws * ws
    dqkv = torch.empty_like(qkv)
    # the kernels add into zeroed f32 drf, dbeta and per-image dbias
    # partials, here one buffer (one fill; drf and dbeta start 64-byte
    # aligned for the four-wide atomics)
    n = B * C * nh * d
    sums = torch.zeros(2 * n + B * nh * S * S, dtype=torch.float32, device=qkv.device)
    drf, dbeta = sums[:n].view(B, C, nh * d), sums[n:2 * n].view(B, C, nh * d)
    dbias_part = sums[2 * n:].view(B, nh, S, S)
    lib = _lib()
    pointers = (qkv.data_ptr(), rf.data_ptr(), beta.data_ptr(),
                None if bias is None else bias.data_ptr(), g.data_ptr(),
                dqkv.data_ptr(), drf.data_ptr(), dbeta.data_ptr(),
                dbias_part.data_ptr())
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        if uses_mma:
            rc = lib.eva_packed_bwd_mma_launch(
                *pointers, B, N, W, ws, nh, d, C, wpb, float(scale), stream)
        else:
            rc = lib.eva_packed_bwd_launch(
                *pointers, B, N, W, ws, nh, d, C, wpb,
                int(qkv.dtype == torch.bfloat16), float(scale), stream)
    _check(rc, "backward")
    global LAUNCHES_BWD, LAUNCHES_BWD_MMA
    LAUNCHES_BWD += 1
    LAUNCHES_BWD_MMA += int(uses_mma)
    # the per-image dbias partials are summed here, as the TPU kernel's
    # caller sums its batch-group partials
    dbias = None if bias is None else dbias_part.sum(dim=0).to(bias_dtype)
    if rf_dtype == beta_dtype:  # one cast for both
        both = sums[:2 * n].to(rf_dtype)
        return dqkv, both[:n].view(B, C, nh * d), both[n:].view(B, C, nh * d), dbias
    return dqkv, drf.to(rf_dtype), dbeta.to(beta_dtype), dbias


class _EvaPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, rf_k_bar, beta, bias, scale, num_heads, W, ws):
        ctx.save_for_backward(qkv, rf_k_bar, beta, bias)
        ctx.geometry = (scale, num_heads, W, ws)
        return _forward(qkv, rf_k_bar, beta, bias, scale, num_heads, W, ws)

    @staticmethod
    def backward(ctx, g):
        qkv, rf_k_bar, beta, bias = ctx.saved_tensors
        dqkv, drf, dbeta, dbias = _backward(qkv, rf_k_bar, beta, bias, g,
                                            *ctx.geometry)
        return dqkv, drf, dbeta, dbias, None, None, None, None


def eva_attention_packed(
    qkv: torch.Tensor,       # [B, N, 3*H*D] fused projection output
    rf_k_bar: torch.Tensor,  # [B, C, H*D]
    beta: torch.Tensor,      # [B, C, H*D]
    scale: float,
    num_heads: int,
    W: int,                  # token-grid width
    ws: int,                 # window side
    bias: Optional[torch.Tensor] = None,  # [H, S, S] window RPE bias
) -> torch.Tensor:
    """EVA joint softmax over the packed layout; returns ``[B, N, H*D]`` in
    qkv's dtype, differentiable in qkv, rf_k_bar, beta and bias.

    CPU tensors take the plain versions; CUDA tensors launch the kernels or
    raise."""
    return _EvaPacked.apply(qkv, rf_k_bar, beta, bias, float(scale),
                            int(num_heads), int(W), int(ws))


# ---- K9: the eval forward with the output projection in the kernel

def out_uses_mma(d: int, itemsize: int, xdim: int = 0) -> bool:
    """Whether K9 (K10's attention with ``xdim > 0``) takes its tensor-core
    route: bf16, and the head dim and x's width multiples of 16."""
    return itemsize == 2 and d % 16 == 0 and xdim % 16 == 0


# the tensor-core route's constants (csrc/eva_eval.cuh): the rows of each of
# the ring's two weight slabs (the small ring's where the other does not
# fit), the columns a product pass holds and the most windows a block takes
OUT_SLAB_ROWS = 96
OUT_SMALL_SLAB_ROWS = 16
OUT_PROJ_COLS = 192
OUT_MAX_WPB = 8


def out_mma_layout(d: int, S: int, C: int, num_heads: int, xdim: int, hg: int,
                   wo_whole: bool, split: bool, slab: int) -> int:
    """Shared memory of one block of K9's (K10's with ``xdim > 0``)
    tensor-core route, ``out_mma_layout`` in ``csrc/eva_eval.cuh``: the
    window's q, k, v rows ``[S][3*H*d + 8]`` (with ``split`` those of
    ``hg`` heads, ``[S][3*hg*d + 8]``), K10's x rows ``[S][xdim + 8]``, with
    ``split`` the attention rows ``[S][H*d + 8]``, the chunk rows rf and
    beta of ``hg`` heads ``[hg][C][d + 8]`` (all bf16), their bias
    ``[hg][S][S]`` (f32), the weight region (bf16: the ring ``[2][slab]
    [OUT_PROJ_COLS + 8]`` where a product streams, Wo ``[H*d][H*d + 8]``
    with ``wo_whole``, or the larger of the two), the bias vectors (f32:
    K10's bqkv ``[3*H*d]``, then bo ``[H*d]``) and the token table
    ``[8][S]`` (int32), each region 128-byte aligned."""
    hd = num_heads * d
    streams = bool(xdim) or not wo_whole
    ring = 2 * slab * (OUT_PROJ_COLS + 8) * 2 if streams else 0
    whole = hd * (hd + 8) * 2 if wo_whole else 0
    return (_align128(S * (3 * (hg * d if split else hd) + 8) * 2)
            + (_align128(S * (xdim + 8) * 2) if xdim else 0)
            + (_align128(S * (hd + 8) * 2) if split else 0)
            + 2 * _align128(hg * C * (d + 8) * 2) + _align128(hg * S * S * 4)
            + _align128(max(ring, whole)) + _align128((4 if xdim else 1) * hd * 4)
            + _align128(OUT_MAX_WPB * S * 4))


def out_mma_plan(d: int, S: int, C: int, num_heads: int,
                 xdim: int = 0) -> Tuple[int, bool, bool, int, int]:
    """``(hg, wo_whole, split, slab, bytes)`` of a tensor-core launch,
    ``out_mma_plan`` in ``csrc/eva_eval.cuh``, the first layout that fits
    of: the attention rows over the q columns, then in a buffer of their
    own (``split``), then that with the small ring; in each, every head in
    one group where it fits, else the most heads that fit, and for those Wo
    whole in shared memory where it fits, else streamed.  Where none fits,
    the last layout tried (over ``SMEM_LIMIT``)."""
    for split, slab in ((False, OUT_SLAB_ROWS), (True, OUT_SLAB_ROWS),
                        (True, OUT_SMALL_SLAB_ROWS)):
        for hg in range(num_heads, 0, -1):
            for wo_whole in (True, False):
                smem = out_mma_layout(d, S, C, num_heads, xdim, hg, wo_whole, split, slab)
                if smem <= SMEM_LIMIT:
                    return hg, wo_whole, split, slab, smem
    return hg, wo_whole, split, slab, smem


def smem_bytes_out(d: int, S: int, C: int, num_heads: int, itemsize: int,
                   xdim: int = 0) -> int:
    """Dynamic shared memory of one K9 block (or, with ``xdim > 0``, one
    ``eva_attention_from_x`` block of K10); the same layouts as
    ``make_out_layout`` and ``out_mma_plan`` in ``csrc/eva_eval.cuh``.
    CUDA-core route: keys ``[k | rf]``, values ``[v | beta]``, the query
    rows, the logits, the bias and the row sums of one head in f32 (as in
    ``smem_bytes``), the window's output rows of every head in the input
    type, the window's x rows for K10.  Tensor-core route:
    ``out_mma_layout`` at the plan ``out_mma_plan`` picks."""
    if out_uses_mma(d, itemsize, xdim):
        return out_mma_plan(d, S, C, num_heads, xdim)[-1]
    hd, DP = num_heads * d, row_stride(d)
    total = (2 * _align128((S + C) * DP * 4) + _align128(S * DP * 4)
             + _align128(S * (S + C + 1) * 4) + _align128(S * S * 4)
             + _align128(S * 4) + _align128(S * (hd + 8) * itemsize))
    if xdim:
        total += _align128(S * (xdim + 8) * itemsize)
    return total


def plan_out(B: int, N: int, W: int, ws: int, C: int, num_heads: int, d: int,
             itemsize: int, xdim: int = 0) -> Optional[int]:
    """Shared memory of a K9 (or K10 attention) launch, or None where the
    kernel cannot take the geometry: square windows dividing a ``N/W x W``
    grid, a head dim it is built for, float32 or bfloat16, and a block within
    Hopper's shared memory."""
    if not 1 <= B <= _MAX_GRID_YZ or num_heads < 1 or xdim < 0:
        return None
    if W <= 0 or ws <= 0 or C <= 0 or N % W or (N // W) % ws or W % ws:
        return None
    if d not in HEAD_DIMS or itemsize not in (2, 4):
        return None
    smem = smem_bytes_out(d, ws * ws, C, num_heads, itemsize, xdim)
    return smem if smem <= SMEM_LIMIT else None


def supports_packed_out(B: int, N: int, W: int, ws: int, c: int, head_dim: int,
                        itemsize: int = 2, num_heads: int = 1) -> bool:
    """Geometry gate of K9."""
    return plan_out(B, N, W, ws, c, num_heads, head_dim, itemsize) is not None


def eva_packed_out_ref(qkv: torch.Tensor, rf_k_bar: torch.Tensor,
                       beta: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                       scale: float, num_heads: int, W: int, ws: int,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K9 (the counterpart of
    ``_kernel_fused_out``): ``eva_packed_fwd_ref``, rounded to qkv's dtype,
    times ``wo`` in that dtype, summed in f32, plus ``bo`` in f32, then
    cast.  ``wo [H*D, H*D]`` is in ``[in, out]`` layout."""
    T = qkv.dtype
    attn = eva_packed_fwd_ref(qkv, rf_k_bar, beta, scale, num_heads, W, ws, bias)
    return (attn.float() @ wo.to(T).float() + bo.float()).to(T)


def kernel_weight(t: torch.Tensor, shape, dtype: torch.dtype,
                  like: torch.Tensor, what: str) -> torch.Tensor:
    """A weight as the eval kernels take it: of ``shape``, on ``like``'s
    device, in ``dtype``, contiguous and 32-byte aligned (the tensor-core
    fragments are loaded straight from it)."""
    if t.device != like.device:
        raise ValueError(f"{what} is on {t.device}, the input on {like.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must be {tuple(shape)}, got {tuple(t.shape)}")
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 32 == 0 else t.clone()


def summaries_operands(rf: torch.Tensor, beta: torch.Tensor, bias, like, B: int,
                       nh: int, d: int, ws: int):
    """Checked chunk summaries (in ``like``'s dtype) and bias (f32) of K9
    and K10's attention, and their chunk count."""
    if rf.dim() != 3 or rf.shape[0] != B or rf.shape[2] != nh * d:
        raise ValueError(f"rf_k_bar must be [B, C, H*D], got {tuple(rf.shape)}")
    if tuple(beta.shape) != tuple(rf.shape):
        raise ValueError(f"beta {tuple(beta.shape)} != rf_k_bar {tuple(rf.shape)}")
    for t, what in ((rf, "rf_k_bar"), (beta, "beta"), (bias, "bias")):
        if t is not None and t.device != like.device:
            raise ValueError(f"{what} is on {t.device}, the input on {like.device}")
    if bias is not None and tuple(bias.shape) != (nh, ws * ws, ws * ws):
        raise ValueError(f"bias must be {(nh, ws * ws, ws * ws)}, got "
                         f"{tuple(bias.shape)}")
    # 16-byte aligned: the tensor-core route reads their rows 16 bytes a load
    rf, beta = (t if t.data_ptr() % 16 == 0 else t.clone()
                for t in (rf.to(like.dtype).contiguous(),
                          beta.to(like.dtype).contiguous()))
    bias = None if bias is None else bias.to(torch.float32).contiguous()
    return rf, beta, bias, rf.shape[1]


@functools.lru_cache(maxsize=None)
def _lib_out() -> ctypes.CDLL:
    lib = _build.load(NAME_OUT)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.eva_packed_out_launch.argtypes = [ptr] * 7 + [i32] * 8 + [ctypes.c_float, ptr]
    lib.eva_packed_out_launch.restype = i32
    lib.eva_packed_out_smem_bytes.argtypes = [i32] * 6
    lib.eva_packed_out_smem_bytes.restype = i32
    lib.eva_packed_out_mma_blocks_per_sm.argtypes = [i32] * 4
    lib.eva_packed_out_mma_blocks_per_sm.restype = i32
    lib.eva_packed_out_error_string.argtypes = [i32]
    lib.eva_packed_out_error_string.restype = ctypes.c_char_p
    return lib


def eva_attention_packed_out(
    qkv: torch.Tensor,       # [B, N, 3*H*D] fused projection output
    rf_k_bar: torch.Tensor,  # [B, C, H*D]
    beta: torch.Tensor,      # [B, C, H*D]
    wo: torch.Tensor,        # [H*D, H*D] output projection (in, out)
    bo: torch.Tensor,        # [H*D]
    scale: float,
    num_heads: int,
    W: int,                  # token-grid width
    ws: int,                 # window side
    bias: Optional[torch.Tensor] = None,  # [H, S, S] window RPE bias
) -> torch.Tensor:
    """Eval forward with the output projection; returns ``[B, N, H*D]`` in
    qkv's dtype (no gradient).  A CPU tensor goes to the plain version; a
    CUDA tensor launches the kernel or raises."""
    if qkv.device.type == "cpu":
        return eva_packed_out_ref(qkv, rf_k_bar, beta, wo, bo, scale, num_heads,
                                  W, ws, bias)
    if qkv.device.type != "cuda":
        raise ValueError(f"eva_packed_out runs on CUDA or CPU tensors, got {qkv.device}")
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, N, 3*H*D], got {tuple(qkv.shape)}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"eva_packed_out takes float32 or bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    B, N, three_hd = qkv.shape
    nh = num_heads
    if three_hd % (3 * nh) or W <= 0 or N % W:
        raise ValueError(f"qkv {tuple(qkv.shape)} does not split into {nh} "
                         f"heads over a grid of width {W}")
    d = three_hd // (3 * nh)
    hd = nh * d
    rf, beta, bias, C = summaries_operands(rf_k_bar, beta, bias, qkv, B, nh, d, ws)
    if plan_out(B, N, W, ws, C, nh, d, qkv.element_size()) is None:
        raise ValueError(
            f"eva_packed_out cannot take B={B}, grid {N // W}x{W}, window {ws}, "
            f"{C} chunks, head dim {d}, {qkv.dtype}; see supports_packed_out")
    wo = kernel_weight(wo, (hd, hd), qkv.dtype, qkv, "wo")
    bo = kernel_weight(bo, (hd,), torch.float32, qkv, "bo")
    out = torch.empty((B, N, hd), dtype=qkv.dtype, device=qkv.device)
    lib = _lib_out()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.eva_packed_out_launch(
            qkv.data_ptr(), rf.data_ptr(), beta.data_ptr(),
            None if bias is None else bias.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            out.data_ptr(), B, N, W, ws, nh, d, C, int(qkv.dtype == torch.bfloat16),
            float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"eva_packed_out launch failed: "
                           f"{lib.eva_packed_out_error_string(rc).decode()}")
    global LAUNCHES_OUT, LAUNCHES_OUT_MMA
    LAUNCHES_OUT += 1
    LAUNCHES_OUT_MMA += int(out_uses_mma(d, qkv.element_size()))
    return out

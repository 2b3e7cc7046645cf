"""K12 ``eva_rowmajor``: the 2-D EVA joint softmax on row-major tokens.

Replaces ``efficient_attention_tpu/ops/pallas/eva_rowmajor.py::
eva_attention_rowmajor``, the route of the JAX ``EVA`` with
``impl='rowmajor'``.  It is K11 (``eva_kernel``) on ``q, k, v [B, H, N, D]``
in the token order of an ``N/W x W`` grid, returning ``[B, H, N, D]`` in
token order: each query attends over the keys of its own ``ws x ws`` window,
plus the bias ``[H, S, S]`` (``S = ws*ws``) at the in-window positions, and
all C chunk keys, with values ``[window v | beta]``, in one softmax.  The
kernel finds a window's tokens from their indices, so the window partition
and merge copies that K11's route pays for, and the TPU kernel's
``[H, TGS, TGS + C]`` permuted bias, do not exist.  Roundings and the
promotion of mixed input types are K11's.

``eva_attention_rowmajor`` launches the kernel of ``csrc/eva_rowmajor.cu``
(device code shared with K11 in ``csrc/eva_window.cuh``, with K11's two
routes and gate, ``eva_kernel.uses_mma``) for CUDA tensors or raises; for
CPU tensors it computes the same function with
``eva_rowmajor_ref``, the plain version: the window partition, K11's plain
version, the merge (the same function as the TPU kernel's
``_xla_reference_rowmajor`` without its ``[B, H, N, N]`` logits).  Its
gradient is autograd's over the plain version.  ``LAUNCHES`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from efficient_attention_torch.ops import windows
from efficient_attention_torch.ops.kernels import _build
from efficient_attention_torch.ops.kernels.eva_kernel import (
    check_cuda,
    eva_fused_ref,
    kernel_operands,
    plan,
    ref_backward,
)

LAUNCHES = 0

NAME = "eva_rowmajor"
SOURCE = "efficient_attention_torch/csrc/eva_rowmajor.cu"
REPLACES = "efficient_attention_tpu/ops/pallas/eva_rowmajor.py:110"


def plan_rowmajor(B: int, N: int, W: int, ws: int, C: int, num_heads: int,
                  d: int, itemsize: int) -> Optional[int]:
    """Windows per block for a launch, or None where the kernel cannot take
    the geometry: square windows dividing an ``N/W x W`` grid, and K11's
    gate (``eva_kernel.plan``) for its windows."""
    if W <= 0 or ws <= 0 or N % W or W % ws or (N // W) % ws:
        return None
    return plan(B, N // (ws * ws), ws * ws, C, num_heads, d, itemsize)


def supports_rowmajor(B: int, N: int, W: int, ws: int, C: int, d: int,
                      itemsize: int = 2, num_heads: int = 1) -> bool:
    """Geometry gate of the kernel: the port's own, standing in for the TPU
    kernel's ``supports_rowmajor``."""
    return plan_rowmajor(B, N, W, ws, C, num_heads, d, itemsize) is not None


def eva_rowmajor_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rf_k_bar: torch.Tensor, beta: torch.Tensor, scale: float,
                     W: int, ws: int, bias: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Plain PyTorch version: the tokens partitioned into Swin windows, K11's
    plain version, the merge back to token order; ``[B, H, N, D]`` in q's
    dtype.  Differentiable by autograd, which gives the wrapper's
    gradient."""
    B, H, N, d = q.shape
    gh = N // W

    def part(t):
        return windows.window_2d_partition(t.reshape(B, H, gh, W, d), ws)

    out = eva_fused_ref(part(q), part(k), part(v), rf_k_bar, beta, scale, bias)
    return windows.window_2d_merge(out, ws, (gh, W)).reshape(B, H, N, d)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.eva_rowmajor_launch.argtypes = [ptr] * 7 + [i32] * 9 + [ctypes.c_float, ptr]
    lib.eva_rowmajor_launch.restype = i32
    lib.eva_rowmajor_smem_bytes.argtypes = [i32] * 4
    lib.eva_rowmajor_smem_bytes.restype = i32
    lib.eva_rowmajor_uses_mma.argtypes = [i32] * 2
    lib.eva_rowmajor_uses_mma.restype = i32
    lib.eva_rowmajor_mma_blocks_per_sm.argtypes = [i32] * 3
    lib.eva_rowmajor_mma_blocks_per_sm.restype = i32
    lib.eva_rowmajor_error_string.argtypes = [i32]
    lib.eva_rowmajor_error_string.restype = ctypes.c_char_p
    return lib


def _operands(q, k, v, rf, beta, bias, W, ws):
    """The kernel's checked operands (q, k, v, rf, beta), bias and launch
    geometry ``(B, H, N, C, d, wpb)``, or a ValueError before anything is
    launched."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one [B, H, N, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, N, d = q.shape
    if rf.dim() != 4 or tuple(rf.shape[:2]) != (B, H) or rf.shape[3] != d \
            or beta.shape != rf.shape:
        raise ValueError(f"rf_k_bar and beta must be one [{B}, {H}, C, {d}], got "
                         f"{tuple(rf.shape)}, {tuple(beta.shape)}")
    C = rf.shape[2]
    ops, bias = kernel_operands(NAME, (q, k, v, rf, beta), bias, H, ws * ws)
    wpb = plan_rowmajor(B, N, W, ws, C, H, d, ops[0].element_size())
    if wpb is None:
        raise ValueError(f"eva_rowmajor cannot take B={B}, {H} heads, {N} tokens "
                         f"of a grid {W} wide, window {ws}, {C} chunks, head dim "
                         f"{d}, {ops[0].dtype}; see supports_rowmajor")
    return ops, bias, (B, H, N, C, d, wpb)


def _launch(q, k, v, rf, beta, bias, scale, W, ws):
    check_cuda(NAME, q)
    (qc, kc, vc, rf, beta), bias, (B, H, N, C, d, wpb) = _operands(
        q, k, v, rf, beta, bias, W, ws)
    out = torch.empty_like(qc)
    lib = _lib()
    with torch.cuda.device(qc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.eva_rowmajor_launch(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), rf.data_ptr(),
            beta.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), B, H, N, W, ws, C, d, wpb,
            int(qc.dtype == torch.bfloat16), float(scale), stream)
    if rc != 0:
        raise RuntimeError("eva_rowmajor launch failed: "
                           f"{lib.eva_rowmajor_error_string(rc).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    return out.to(q.dtype)


class _EvaRowmajor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rf, beta, bias, scale, W, ws):
        ctx.save_for_backward(q, k, v, rf, beta, bias)
        ctx.geometry = (scale, W, ws)
        if q.device.type == "cpu":
            return eva_rowmajor_ref(q, k, v, rf, beta, scale, W, ws, bias)
        return _launch(q, k, v, rf, beta, bias, scale, W, ws)

    @staticmethod
    def backward(ctx, g):
        return ref_backward(eva_rowmajor_ref, ctx, g, 3)


def eva_attention_rowmajor(
    q: torch.Tensor,          # [B, H, N, D] in token order
    k: torch.Tensor,
    v: torch.Tensor,
    rf_k_bar: torch.Tensor,   # [B, H, C, D] chunk summaries
    beta: torch.Tensor,
    scale: float,
    W: int,                   # grid width (tokens per image row)
    ws: int,                  # window side
    bias: Optional[torch.Tensor] = None,  # [H, S, S] Swin-local bias
) -> torch.Tensor:
    """The joint softmax over the 2-D windows of row-major tokens; returns
    ``[B, H, N, D]`` in token order and q's dtype, differentiable in every
    tensor argument.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    return _EvaRowmajor.apply(q, k, v, rf_k_bar, beta, bias, float(scale), int(W),
                              int(ws))

"""K7 ``local_packed``: exact 2-D window attention over the packed qkv.

Replaces ``efficient_attention_tpu/ops/pallas/local_packed.py::
local_attention_packed``, the kernel that every 2-D local-attention block
(no halo, no padding mask, no attention dropout) goes through.  From the
packed projection output ``qkv [B, N, 3*H*D]`` each query attends over the
keys of its own ``ws x ws`` window, plus the RPE bias ``[H, S, S]``, in one
softmax scaled by ``scale``; the output is ``[B, N, H*D]``.  It is K1
(``eva_packed``) with no chunk columns.

The TPU kernel computes this over row strips with masked cross-window
logits, whose entries are exactly 0 after its softmax, so the window-local
form here is the same function.  Roundings follow the TPU kernel: logits and
the softmax are f32, the normalised probabilities are rounded to qkv's dtype
before their product with v, the product sums in f32 and the output is cast
last.  In bf16 at head dims that are multiples of 16 (``uses_mma``) the
kernel takes its tensor-core route, K1's mma.sync forward design without the
chunk columns, with the probabilities normalised before they are rounded (K1
rounds the numerators and divides after the product); f32 and other head
dims take the CUDA-core kernel.

``local_attention_packed`` launches the CUDA kernel (``csrc/local_packed.cu``)
for CUDA tensors and raises where it cannot take them; for CPU tensors it
computes the same function with ``local_packed_ref``, the plain PyTorch
version, which is also what the kernel is held against on the card.  Its
gradient is autograd's over the plain version, as the JAX package takes the
VJP of its ``_xla_rowmajor``.  ``LAUNCHES`` counts the kernel's launches on
both routes, ``LAUNCHES_MMA`` those on the tensor-core route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from efficient_attention_torch.ops.kernels import _build
from efficient_attention_torch.ops.kernels.eva_packed import (
    HEAD_DIMS,
    _merge,
    _windows,
    row_stride,
)

LAUNCHES = 0
LAUNCHES_MMA = 0

NAME = "local_packed"
SOURCE = "efficient_attention_torch/csrc/local_packed.cu"
REPLACES = "efficient_attention_tpu/ops/pallas/local_packed.py:64"

SMEM_LIMIT = 232448
WINDOWS_PER_BLOCK = (4, 2, 1)
_MAX_GRID_YZ = 65535


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def uses_mma(d: int, itemsize: int) -> bool:
    """Whether the kernel takes its bf16 tensor-core route (the C export
    ``local_packed_uses_mma``): bfloat16 and a head dim that is a multiple of
    16."""
    return itemsize == 2 and d % 16 == 0


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def smem_bytes(d: int, S: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of one block of the route ``(d, S, itemsize)``
    takes; the same layouts as ``make_layout`` and ``make_mma_layout`` in
    ``csrc/local_packed.cu``.  CUDA-core route: a window's q, k and v rows
    (f32, rows of d at ``row_stride(d)``), its logits (rows of S + 1) and the
    head's bias.  Tensor-core route: a window's q, k and v rows in bf16
    (rows of d + 8) in two buffers each, the bias in f32 and the token table
    of ``max(WINDOWS_PER_BLOCK)`` windows in int32."""
    if uses_mma(d, itemsize):
        win = _align128(S * (d + 8) * 2)
        return (6 * win + _align128(S * S * 4)
                + _align128(max(WINDOWS_PER_BLOCK) * S * 4))
    rows = _align16(S * row_stride(d) * 4)
    return 3 * rows + _align16(S * (S + 1) * 4) + _align16(S * S * 4)


def plan(B: int, N: int, W: int, ws: int, num_heads: int, d: int,
         itemsize: int) -> Optional[int]:
    """Windows per block for a launch, or None where the kernel cannot take
    the geometry: square windows dividing a ``N/W x W`` grid, a head dim it
    is built for, float32 or bfloat16, and the block within Hopper's shared
    memory."""
    if not 1 <= B <= _MAX_GRID_YZ or not 1 <= num_heads <= _MAX_GRID_YZ:
        return None
    if W <= 0 or ws <= 0 or N % W or (N // W) % ws or W % ws:
        return None
    if d not in HEAD_DIMS or itemsize not in (2, 4):
        return None
    if smem_bytes(d, ws * ws, itemsize) > SMEM_LIMIT:
        return None
    n_win = (N // W // ws) * (W // ws)
    return next(g for g in WINDOWS_PER_BLOCK if n_win % g == 0)


def supports_packed(B: int, N: int, W: int, ws: int, head_dim: int,
                    itemsize: int = 2, num_heads: int = 1) -> bool:
    """Geometry gate of the kernel (JAX ``supports_packed`` with no chunk
    columns, with the head dims and element sizes the kernel is built for)."""
    return plan(B, N, W, ws, num_heads, head_dim, itemsize) is not None


def local_packed_ref(qkv: torch.Tensor, scale: float, num_heads: int, W: int,
                     ws: int, bias: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Plain PyTorch version (the counterpart of ``_kernel``): the same
    function and roundings in f32 tensor ops; ``[B, N, H*D]`` in qkv's
    dtype.  Differentiable by autograd, which gives the wrapper's
    gradient."""
    T = qkv.dtype
    gh = qkv.shape[1] // W
    q, k, v = (_windows(t, gh, W, ws, num_heads) for t in qkv.chunk(3, dim=-1))
    logits = torch.einsum("bhgsd,bhgtd->bhgst", q, k) * scale
    if bias is not None:
        logits = logits + bias.float()[None, :, None]
    p = torch.softmax(logits, dim=-1).to(T).float()
    out = torch.einsum("bhgst,bhgtd->bhgsd", p, v)
    return _merge(out, gh, W, ws).to(T)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.local_packed_launch.argtypes = [ptr] * 3 + [i32] * 8 + [ctypes.c_float, ptr]
    lib.local_packed_launch.restype = i32
    for fn in ("local_packed_uses_mma", "local_packed_smem_bytes",
               "local_packed_mma_blocks_per_sm"):
        getattr(lib, fn).restype = i32
    lib.local_packed_uses_mma.argtypes = [i32, i32]
    lib.local_packed_smem_bytes.argtypes = [i32, i32, i32]
    lib.local_packed_mma_blocks_per_sm.argtypes = [i32, i32]
    lib.local_packed_error_string.argtypes = [i32]
    lib.local_packed_error_string.restype = ctypes.c_char_p
    return lib


def _launch(qkv, bias, scale, num_heads, W, ws):
    if qkv.device.type != "cuda":
        raise ValueError(f"local_packed runs on CUDA or CPU tensors, got {qkv.device}")
    if qkv.dim() != 3 or qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qkv must be a float32 or bfloat16 [B, N, 3*H*D], got "
                         f"{qkv.dtype} {tuple(qkv.shape)}")
    B, N, three_hd = qkv.shape
    nh = num_heads
    if three_hd % (3 * nh) or W <= 0 or N % W:
        raise ValueError(f"qkv {tuple(qkv.shape)} does not split into {nh} "
                         f"heads over a grid of width {W}")
    d = three_hd // (3 * nh)
    wpb = plan(B, N, W, ws, nh, d, qkv.element_size())
    if wpb is None:
        raise ValueError(f"local_packed cannot take B={B}, grid {N // W}x{W}, "
                         f"window {ws}, head dim {d}, {qkv.dtype}; see "
                         "supports_packed")
    if bias is not None and (tuple(bias.shape) != (nh, ws * ws, ws * ws)
                             or bias.device != qkv.device):
        raise ValueError(f"bias must be {(nh, ws * ws, ws * ws)} on {qkv.device}, "
                         f"got {tuple(bias.shape)} on {bias.device}")
    qkv = qkv.contiguous()
    bias = None if bias is None else bias.to(torch.float32).contiguous()
    out = torch.empty((B, N, nh * d), dtype=qkv.dtype, device=qkv.device)
    lib = _lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.local_packed_launch(
            qkv.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), B, N, W, ws, nh, d, wpb,
            int(qkv.dtype == torch.bfloat16), float(scale), stream)
    if rc != 0:
        raise RuntimeError("local_packed launch failed: "
                           f"{lib.local_packed_error_string(rc).decode()}")
    global LAUNCHES, LAUNCHES_MMA
    LAUNCHES += 1
    LAUNCHES_MMA += uses_mma(d, qkv.element_size())
    return out


class _LocalPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, scale, num_heads, W, ws):
        ctx.save_for_backward(qkv, bias)
        ctx.geometry = (scale, num_heads, W, ws)
        if qkv.device.type == "cpu":
            return local_packed_ref(qkv, scale, num_heads, W, ws, bias)
        return _launch(qkv, bias, scale, num_heads, W, ws)

    @staticmethod
    def backward(ctx, g):
        qkv, bias = ctx.saved_tensors
        leaves = [qkv.detach().requires_grad_()]
        if bias is not None:
            leaves.append(bias.detach().requires_grad_())
        with torch.enable_grad():
            out = local_packed_ref(leaves[0], *ctx.geometry,
                                   leaves[1] if bias is not None else None)
        grads = torch.autograd.grad(out, leaves, g)
        return (grads[0], grads[1] if bias is not None else None,
                None, None, None, None)


def local_attention_packed(
    qkv: torch.Tensor,   # [B, N, 3*H*D] fused projection output
    scale: float,
    num_heads: int,
    W: int,              # token-grid width
    ws: int,             # window side
    bias: Optional[torch.Tensor] = None,  # [H, S, S] window RPE bias
) -> torch.Tensor:
    """Window attention over the packed layout; returns ``[B, N, H*D]`` in
    qkv's dtype, differentiable in qkv and bias.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    return _LocalPacked.apply(qkv, bias, float(scale), int(num_heads), int(W),
                              int(ws))

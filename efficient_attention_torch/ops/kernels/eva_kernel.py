"""K11 ``eva_kernel``: the EVA joint softmax over Swin-partitioned windows.

Replaces ``efficient_attention_tpu/ops/pallas/eva_kernel.py::
eva_attention_fused``, the route of the JAX ``EVA`` with ``impl='pallas'``
and its ``auto`` fallback wherever the packed kernels do not engage.  From
window-partitioned ``w_q, w_k, w_v [B, H, G, S, D]`` (2-D windows of
``S = ws*ws`` tokens in Swin order, or 1-D windows of ``S = ws``) and the
chunk summaries ``rf_k_bar, beta [B, H, C, D]``, each query attends over its
own window's S keys, plus the bias ``[H, S, S]``, and all C chunk keys, with
values ``[window v | beta]``, in one softmax scaled by ``scale``; the output
is ``[B, H, G, S, D]``.

The TPU kernel packs several windows into one dense logits product and masks
the cross-window entries with ``MASK_VAL``; those are exactly 0 after its
f32 softmax, so the window-local form here is the same function.  Roundings
follow the TPU kernel (``_eva_kernel``): logits in f32 with the f32 bias
added, the numerators ``exp(l - max)`` rounded to the value dtype before
their product with ``[v | beta]``, f32 sums, ``out / denom`` in f32, then
cast to q's dtype.  Where rf/beta come in a wider type than q/k/v, the TPU
kernel's concatenation promotes the products to that type; here every input
is cast to the promoted type first, which is the same function.

``eva_attention_fused`` is a ``torch.autograd.Function``: for CUDA tensors
its forward launches the kernel of ``csrc/eva_kernel.cu`` (device code in
``csrc/eva_window.cuh``) or raises: bfloat16 at head dims that are
multiples of 16 (``uses_mma``) on tensor cores, with K1's tensor-core
forward design and strip tiles (``csrc/eva_strip.cuh``), float32 and the
other head dims on CUDA cores; for CPU tensors it computes the same
function with ``eva_fused_ref``, the plain PyTorch version, which is also
what the kernel is held against on the card.  Its gradient is autograd's
over the plain version, as the JAX package's custom VJP differentiates its
``_xla_reference``.  ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from efficient_attention_torch.ops.kernels import _build
from efficient_attention_torch.ops.kernels.eva_packed import row_stride

LAUNCHES = 0

NAME = "eva_kernel"
SOURCE = "efficient_attention_torch/csrc/eva_kernel.cu"
REPLACES = "efficient_attention_tpu/ops/pallas/eva_kernel.py:142"

# the head dims the kernel is instantiated for (launch_any in
# csrc/eva_window.cuh; multiples of 4 for its 16-byte shared-memory loads),
# the shared memory a block may use on Hopper, and the most windows a block
# takes in turn (the largest of WINDOWS_PER_BLOCK that divides the count)
HEAD_DIMS = (8, 12, 16, 24, 32, 48, 64, 128)
SMEM_LIMIT = 232448
WINDOWS_PER_BLOCK = (4, 2, 1)
_MAX_GRID_YZ = 65535


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


def uses_mma(d: int, itemsize: int) -> bool:
    """Whether the kernel takes its bf16 tensor-core route (``uses_mma`` in
    ``csrc/eva_window.cuh``): bfloat16 and a head dim that is a multiple of
    16 (of ``HEAD_DIMS``, 16, 32, 48, 64 and 128): K1's tensor-core forward
    design, on the strip tiles it shares with K1 (``csrc/eva_strip.cuh``)."""
    return itemsize == 2 and d % 16 == 0


def smem_bytes(d: int, S: int, C: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of one block of the route ``(d, S, C,
    itemsize)`` takes; the same layouts as ``make_layout`` and
    ``make_mma_layout`` in ``csrc/eva_window.cuh``.  CUDA-core route, all
    f32: keys ``[k | rf]`` and values ``[v | beta]`` (rows of d at
    ``row_stride(d)``), the query rows, the logits (rows of S + C + 1), the
    bias and the denominators.  Tensor-core route: a window's q, k and v
    rows (rows of d + 8 bf16) in two buffers each, the chunk rows rf and
    beta, the f32 bias and the int32 token table of ``max(WINDOWS_PER_BLOCK)``
    windows, each region 128-byte aligned."""
    if uses_mma(d, itemsize):
        win = _align(S * (d + 8) * 2, 128)
        return (6 * win + 2 * _align(C * (d + 8) * 2, 128) + _align(S * S * 4, 128)
                + _align(max(WINDOWS_PER_BLOCK) * S * 4, 128))
    rows = lambda n: _align(n * row_stride(d) * 4, 16)  # noqa: E731
    return (2 * rows(S + C) + rows(S) + _align(S * (S + C + 1) * 4, 16)
            + _align(S * S * 4, 16) + _align(S * 4, 16))


def plan(B: int, G: int, S: int, C: int, num_heads: int, d: int,
         itemsize: int) -> Optional[int]:
    """Windows per block for a launch, or None where the kernel cannot take
    the geometry: a head dim it is built for, float32 or bfloat16, and a
    block within Hopper's shared memory."""
    if not 1 <= B <= _MAX_GRID_YZ or not 1 <= num_heads <= _MAX_GRID_YZ:
        return None
    if G <= 0 or S <= 0 or C <= 0:
        return None
    if d not in HEAD_DIMS or itemsize not in (2, 4):
        return None
    if smem_bytes(d, S, C, itemsize) > SMEM_LIMIT:
        return None
    return next(g for g in WINDOWS_PER_BLOCK if G % g == 0)


def supports_fused(B: int, G: int, S: int, C: int, d: int, itemsize: int = 2,
                   num_heads: int = 1) -> bool:
    """Geometry gate of the kernel: the port's own, standing in for the TPU
    kernel's ``supports_shapes`` (whose sublane rule is the TPU's)."""
    return plan(B, G, S, C, num_heads, d, itemsize) is not None


def compute_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """The type the products run in: the promotion of the inputs' types,
    as the TPU kernel's ``concatenate([k, rf])`` promotes."""
    return functools.reduce(torch.promote_types, (t.dtype for t in tensors))


def eva_fused_ref(w_q: torch.Tensor, w_k: torch.Tensor, w_v: torch.Tensor,
                  rf_k_bar: torch.Tensor, beta: torch.Tensor, scale: float,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version (the counterpart of ``_eva_kernel``): the same
    function and roundings in f32 tensor ops; ``[B, H, G, S, D]`` in w_q's
    dtype.  Differentiable by autograd, which gives the wrapper's
    gradient."""
    T = compute_dtype(w_q, w_k, w_v, rf_k_bar, beta)
    q = w_q.float()
    local = torch.einsum("bhgsd,bhgtd->bhgst", q, w_k.float()) * scale
    if bias is not None:
        local = local + bias.float()[None, :, None]
    chunk = torch.einsum("bhgsd,bhcd->bhgsc", q, rf_k_bar.float()) * scale
    logits = torch.cat([local, chunk], dim=-1)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    denom = p.sum(dim=-1, keepdim=True)
    pr = p.to(T).float()
    S = w_q.shape[3]
    out = (torch.einsum("bhgst,bhgtd->bhgsd", pr[..., :S], w_v.to(T).float())
           + torch.einsum("bhgsc,bhcd->bhgsd", pr[..., S:], beta.to(T).float()))
    return (out / denom).to(w_q.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.eva_kernel_launch.argtypes = [ptr] * 7 + [i32] * 8 + [ctypes.c_float, ptr]
    lib.eva_kernel_launch.restype = i32
    lib.eva_kernel_smem_bytes.argtypes = [i32] * 4
    lib.eva_kernel_smem_bytes.restype = i32
    lib.eva_kernel_uses_mma.argtypes = [i32] * 2
    lib.eva_kernel_uses_mma.restype = i32
    lib.eva_kernel_mma_blocks_per_sm.argtypes = [i32] * 3
    lib.eva_kernel_mma_blocks_per_sm.restype = i32
    lib.eva_kernel_error_string.argtypes = [i32]
    lib.eva_kernel_error_string.restype = ctypes.c_char_p
    return lib


def kernel_operands(name: str, tensors, bias: Optional[torch.Tensor], nh: int,
                    S: int) -> Tuple[list, Optional[torch.Tensor]]:
    """q, k, v, rf, beta checked to lie on one device, cast to their
    promoted float32 or bfloat16 type, contiguous and 16-byte aligned (the
    kernels' vector loads), and the bias as f32 ``[nh, S, S]`` or None; a
    ValueError before anything is launched."""
    dev = tensors[0].device
    T = compute_dtype(*tensors)
    if T not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes float32 or bfloat16, got {T}")
    out = []
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        t = t.to(T).contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    if bias is not None:
        if tuple(bias.shape) != (nh, S, S) or bias.device != dev:
            raise ValueError(f"{name}: bias must be {(nh, S, S)} on {dev}, got "
                             f"{tuple(bias.shape)} on {bias.device}")
        bias = bias.to(torch.float32).contiguous()
    return out, bias


def check_cuda(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on a CUDA device (the kernels' only one)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {t.device}")


def _operands(w_q, w_k, w_v, rf, beta, bias):
    """The kernel's checked operands (q, k, v, rf, beta), bias and launch
    geometry ``(B, H, G, S, C, d, wpb)``, or a ValueError before anything
    is launched."""
    if w_q.dim() != 5 or w_k.shape != w_q.shape or w_v.shape != w_q.shape:
        raise ValueError(f"w_q, w_k, w_v must be one [B, H, G, S, D], got "
                         f"{tuple(w_q.shape)}, {tuple(w_k.shape)}, {tuple(w_v.shape)}")
    B, H, G, S, d = w_q.shape
    if rf.dim() != 4 or tuple(rf.shape[:2]) != (B, H) or rf.shape[3] != d \
            or beta.shape != rf.shape:
        raise ValueError(f"rf_k_bar and beta must be one [{B}, {H}, C, {d}], got "
                         f"{tuple(rf.shape)}, {tuple(beta.shape)}")
    C = rf.shape[2]
    ops, bias = kernel_operands(NAME, (w_q, w_k, w_v, rf, beta), bias, H, S)
    wpb = plan(B, G, S, C, H, d, ops[0].element_size())
    if wpb is None:
        raise ValueError(f"eva_kernel cannot take B={B}, {H} heads, {G} windows "
                         f"of {S}, {C} chunks, head dim {d}, {ops[0].dtype}; see "
                         "supports_fused")
    return ops, bias, (B, H, G, S, C, d, wpb)


def _launch(w_q, w_k, w_v, rf, beta, bias, scale):
    check_cuda(NAME, w_q)
    (q, k, v, rf, beta), bias, (B, H, G, S, C, d, wpb) = _operands(
        w_q, w_k, w_v, rf, beta, bias)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.eva_kernel_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rf.data_ptr(), beta.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, H, G, S, C, d, wpb, int(q.dtype == torch.bfloat16), float(scale),
            stream)
    if rc != 0:
        raise RuntimeError("eva_kernel launch failed: "
                           f"{lib.eva_kernel_error_string(rc).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    return out.to(w_q.dtype)


def ref_backward(ref, ctx, g, n_geometry):
    """Gradients of the saved inputs by autograd over the plain version
    ``ref`` (called as ``ref(q, k, v, rf, beta, *geometry, bias)``), None
    for the bias when there was none and for the geometry arguments."""
    *ops, bias = ctx.saved_tensors
    leaves = [t.detach().requires_grad_() for t in ops]
    if bias is not None:
        leaves.append(bias.detach().requires_grad_())
    with torch.enable_grad():
        out = ref(*leaves[:5], *ctx.geometry,
                  leaves[5] if bias is not None else None)
    grads = torch.autograd.grad(out, leaves, g)
    return (*grads[:5], grads[5] if bias is not None else None,
            *([None] * n_geometry))


class _EvaFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_q, w_k, w_v, rf, beta, bias, scale):
        ctx.save_for_backward(w_q, w_k, w_v, rf, beta, bias)
        ctx.geometry = (scale,)
        if w_q.device.type == "cpu":
            return eva_fused_ref(w_q, w_k, w_v, rf, beta, scale, bias)
        return _launch(w_q, w_k, w_v, rf, beta, bias, scale)

    @staticmethod
    def backward(ctx, g):
        return ref_backward(eva_fused_ref, ctx, g, 1)


def eva_attention_fused(
    w_q: torch.Tensor,   # [B, H, G, S, D] window-partitioned projections
    w_k: torch.Tensor,
    w_v: torch.Tensor,
    rf_k_bar: torch.Tensor,  # [B, H, C, D] chunk summaries
    beta: torch.Tensor,
    scale: float,
    bias: Optional[torch.Tensor] = None,  # [H, S, S] window bias
) -> torch.Tensor:
    """The joint softmax over windows; returns ``[B, H, G, S, D]`` in w_q's
    dtype, differentiable in every tensor argument.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    return _EvaFused.apply(w_q, w_k, w_v, rf_k_bar, beta, bias, float(scale))

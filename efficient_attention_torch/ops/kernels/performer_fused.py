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
and the output is cast last.  In bf16 (head dims and feature counts that are
multiples of 16) the products run on tensor cores.

``performer_attention_fused`` launches the CUDA kernel
(``csrc/performer_fused.cu``) for CUDA tensors and raises where it cannot
take them; for CPU tensors it computes the same function with
``performer_fused_ref``, the plain PyTorch version, which is also what the
kernel is held against on the card.  Its gradient is autograd's over the
plain version, as the JAX package takes the VJP of its twin.  ``LAUNCHES``
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from efficient_attention_torch.ops.kernels import _build

LAUNCHES = 0

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


def performer_fused_ref(qkv: torch.Tensor, projection: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """Plain PyTorch version (the counterpart of ``_kernel``): the same
    function and roundings in f32 tensor ops; ``[B, N, H*D]`` in qkv's
    dtype."""
    T = qkv.dtype
    B, N, three_hd = qkv.shape
    hd = three_hd // 3
    nh = num_heads
    d = hd // nh
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
    z = kp.sum(-2)                                           # [B, H, m]
    kv = torch.einsum("bhnm,bhnd->bhmd", rnd(kp), v)
    dash_q = dn4 * torch.einsum("bhnd,hmd->bhnm", q, w)
    s_q = dash_q.amax(dim=-1, keepdim=True).detach()
    qp = ratio * torch.exp(dash_q - half * q.square().sum(-1)[..., None] - s_q) \
        + FEAT_EPS
    num = torch.einsum("bhnm,bhmd->bhnd", rnd(qp), rnd(kv))
    den = (qp * z[:, :, None, :]).sum(-1)
    out = num / den.clamp(min=DEN_EPS)[..., None]
    return out.transpose(1, 2).reshape(B, N, hd).to(T)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.performer_fused_launch.argtypes = ([ptr] * 3 + [i32] * 6 + [f32] * 3
                                           + [ptr])
    lib.performer_fused_launch.restype = i32
    lib.performer_fused_smem_bytes.argtypes = [i32, i32, i32]
    lib.performer_fused_smem_bytes.restype = i32
    lib.performer_fused_error_string.argtypes = [i32]
    lib.performer_fused_error_string.restype = ctypes.c_char_p
    return lib


def _launch(qkv, projection, num_heads):
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
    qkv = qkv.contiguous()
    w = projection.to(torch.float32).contiguous()
    out = torch.empty((B, N, nh * d), dtype=qkv.dtype, device=qkv.device)
    lib = _lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.performer_fused_launch(
            qkv.data_ptr(), w.data_ptr(), out.data_ptr(), B, N, nh, d, m,
            int(qkv.dtype == torch.bfloat16), float(d ** -0.25),
            float(0.5 * d ** -0.5), float(m ** -0.5), stream)
    if rc != 0:
        raise RuntimeError("performer_fused launch failed: "
                           f"{lib.performer_fused_error_string(rc).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    return out


class _PerformerFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, projection, num_heads):
        ctx.save_for_backward(qkv, projection)
        ctx.num_heads = num_heads
        if qkv.device.type == "cpu":
            return performer_fused_ref(qkv, projection, num_heads)
        return _launch(qkv, projection, num_heads)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = performer_fused_ref(*leaves, ctx.num_heads)
        return (*torch.autograd.grad(out, leaves, g), None)


def performer_attention_fused(
    qkv: torch.Tensor,         # [B, N, 3*H*D] fused projection output
    projection: torch.Tensor,  # [H, m, D] random-feature matrix
    num_heads: int,
) -> torch.Tensor:
    """Fused FAVOR+ linear attention; returns ``[B, N, H*D]`` in qkv's
    dtype, differentiable in qkv and the projection.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    return _PerformerFused.apply(qkv, projection, int(num_heads))

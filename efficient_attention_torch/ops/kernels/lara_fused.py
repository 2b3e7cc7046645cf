"""K5 ``lara_fused``: the mis-opt LARA combine of the eval forward in one kernel.

Replaces ``efficient_attention_tpu/ops/pallas/lara_fused.py::
lara_attention_fused``, the kernel that every LARA block (mis-opt, eval)
goes through.  From the packed projection output ``qkv [B, N, 3*H*D]``, the
proposal means ``w [B, H, C, D]`` (at eval the RF weights are the means),
the query landmarks ``q_bar [B, H, C, D]`` and the landmark-side terms
``balance, log_proposal [B, H, C]`` it computes, for each image and head,

* the landmark statistics: ``lpk[c, n] = <w_c, k_n>/sqrt(d) -
  |k_n|^2/(2 sqrt(d))``, ``kv[c] = softmax_n(lpk[c]) @ v``,
  ``lse_k[c] = logsumexp_n lpk[c]`` and ``lse_t[c] = logsumexp_n
  scale <q_bar_c, q_n>``;
* per token ``n`` the mis-opt weights ``alpha = balance + coeff (t_nc -
  mean_c t_nc)`` with ``t_nc = exp(scale <q_bar_c, q_n> - lse_t[c])``, the
  SNIS softmax over the landmarks of ``log alpha + lpq[n, c] + lse_k[c] -
  log_proposal[c]`` and its product with ``kv``.

The softmaxes over tokens are shifted by their true maximum, as the JAX
package's twin (``lara_fused_twin``) and its eager path are; the TPU kernel
shifts ``lse_k`` by the bound ``|w_c|^2/(2 sqrt(d))`` instead, which
underflows when every key lies far from ``w_c``.  Roundings follow the TPU
kernel: both operands of every product are taken in qkv's dtype (so in
bf16 the landmarks, the token-softmax numerators, the SNIS weights and
``kv`` are rounded first), every sum is f32, and the output is cast last.
In bf16 (head dims that are multiples of 16) the products run on tensor
cores.

``lara_attention_fused`` launches the CUDA kernel (``csrc/lara_fused.cu``)
for CUDA tensors and raises where it cannot take them; for CPU tensors it
computes the same function with ``lara_fused_ref``, the plain PyTorch
version, which is also what the kernel is held against on the card.  Its
gradient is autograd's over the plain version, as the JAX package takes the
VJP of its twin.  ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from efficient_attention_torch.ops.kernels import _build

LAUNCHES = 0

NAME = "lara_fused"
SOURCE = "efficient_attention_torch/csrc/lara_fused.cu"
REPLACES = "efficient_attention_tpu/ops/pallas/lara_fused.py:201"

# the kernel's token tile (rows of q/k/v it holds at once), its warps, the
# kv accumulator tiles a warp of the bf16 route holds, and the shared memory
# a block may use on Hopper
TOKEN_TILE = 32
WARPS = 8
MMA_MAX_ACC = 4
SMEM_LIMIT = 232448
_MAX_GRID_YZ = 65535


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


def uses_mma(d: int, C: int, itemsize: int) -> bool:
    """Whether the kernel takes its bf16 tensor-core route (``uses_mma`` in
    ``csrc/lara_fused.cu``): bfloat16, a head dim that is a multiple of 16,
    and the kv tiles within the warps' accumulators."""
    return (itemsize == 2 and d % 16 == 0
            and (_align(C, 16) // 16) * (d // 16) <= WARPS * MMA_MAX_ACC)


def smem_bytes(d: int, C: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of one block of the route ``(d, C, itemsize)``
    takes; the same layouts as ``make_layout`` and ``make_mma_layout`` in
    ``csrc/lara_fused.cu``.  CUDA-core route: the landmarks w and q_bar and
    the kv sums (f32 rows of d at d + 1), one token tile each of q (which v
    reuses) and k, two logit tiles, eight per-landmark statistics and one
    per-token row.  bf16 route: w, q_bar, kv and the q, k, v tiles in bf16
    (rows of d + 8, landmarks padded to a multiple of 16), an f32 region for
    the logit tiles, the kv sums or the output tile, the rounded numerators
    or SNIS weights in bf16, the statistics and a per-token row."""
    TT = TOKEN_TILE
    if uses_mma(d, C, itemsize):
        CP, DB = _align(C, 16), d + 8
        LF = max(CP * (TT + 4), TT * (CP + 4))
        FS = max(2 * LF, CP * (d + 4), TT * (d + 4))
        PB = max(CP * (TT + 8), TT * (CP + 8))
        return (3 * _align(CP * DB * 2, 128) + 3 * _align(TT * DB * 2, 128)
                + _align(FS * 4, 128) + _align(PB * 2, 128)
                + _align(8 * CP * 4, 128) + _align(TT * 4, 128))
    DP = d + 1
    logits = _align(max(C * (TT + 1), TT * (C + 1)) * 4, 16)
    return (3 * _align(C * DP * 4, 16) + 2 * _align(TT * DP * 4, 16)
            + 2 * logits + _align(8 * C * 4, 16) + _align(TT * 4, 16))


def supports_lara_fused(B: int, N: int, three_hd: int, num_heads: int, C: int,
                        itemsize: int = 2) -> bool:
    """Geometry gate of the kernel: float32 or bfloat16, heads dividing the
    width, at least one landmark, and the block within Hopper's shared
    memory."""
    if not 1 <= B <= _MAX_GRID_YZ or num_heads < 1 or C < 1 or N < 1:
        return False
    if three_hd % (3 * num_heads) or itemsize not in (2, 4):
        return False
    return smem_bytes(three_hd // (3 * num_heads), C, itemsize) <= SMEM_LIMIT


def lara_fused_ref(qkv: torch.Tensor, weights: torch.Tensor,
                   q_bar: torch.Tensor, balance: torch.Tensor,
                   log_proposal: torch.Tensor, scale: float, num_heads: int,
                   alpha_coeff: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version (the counterpart of ``_kernel``): the same
    function and roundings in f32 tensor ops; ``[B, N, H*D]`` in qkv's
    dtype."""
    T = qkv.dtype
    B, N, three_hd = qkv.shape
    hd = three_hd // 3
    nh = num_heads
    d = hd // nh
    C = weights.shape[2]
    dn = d ** -0.5

    def rnd(t):  # the value a product in qkv's dtype sees
        return t.to(T).float()

    x = qkv.float().reshape(B, N, 3, nh, d)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, N, D]
    w, qb = rnd(weights.float()), rnd(q_bar.float())
    # landmark statistics, each softmax over tokens shifted by its maximum
    lpk = (dn * torch.einsum("bhcd,bhnd->bhcn", w, k)
           - (0.5 * dn) * k.square().sum(-1)[:, :, None, :])
    m_k = lpk.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(lpk - m_k)
    den = p.sum(-1).clamp(min=1e-15)
    kv = torch.einsum("bhcn,bhnd->bhcd", rnd(p), v) / den[..., None]
    lse_k = torch.log(den) + m_k[..., 0]
    lse_t = torch.logsumexp(scale * torch.einsum("bhcd,bhnd->bhcn", qb, q), -1)
    # per-token mis-opt combine
    lpq = (dn * torch.einsum("bhnd,bhcd->bhnc", q, w)
           - (0.5 * dn) * q.square().sum(-1)[..., None])
    t_nc = torch.exp(scale * torch.einsum("bhnd,bhcd->bhnc", q, qb)
                     - lse_t[:, :, None, :])
    mean_c = t_nc.sum(-1, keepdim=True) / float(C)
    alpha = balance.float()[:, :, None, :] + alpha_coeff * (t_nc - mean_c)
    log_iw = (torch.log(alpha.clamp(min=1e-8)) + lpq + lse_k[:, :, None, :]
              - log_proposal.float()[:, :, None, :])
    sniw = torch.softmax(log_iw, dim=-1)
    out = torch.einsum("bhnc,bhcd->bnhd", rnd(sniw), rnd(kv))
    return out.reshape(B, N, hd).to(T)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lara_fused_launch.argtypes = ([ptr] * 6 + [i32] * 6 + [f32] * 3
                                      + [ptr])
    lib.lara_fused_launch.restype = i32
    lib.lara_fused_smem_bytes.argtypes = [i32, i32, i32]
    lib.lara_fused_smem_bytes.restype = i32
    lib.lara_fused_error_string.argtypes = [i32]
    lib.lara_fused_error_string.restype = ctypes.c_char_p
    return lib


def _launch(qkv, weights, q_bar, balance, log_proposal, scale, num_heads,
            alpha_coeff):
    if qkv.device.type != "cuda":
        raise ValueError(f"lara_fused runs on CUDA or CPU tensors, got {qkv.device}")
    if qkv.dim() != 3 or qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qkv must be a float32 or bfloat16 [B, N, 3*H*D], got "
                         f"{qkv.dtype} {tuple(qkv.shape)}")
    B, N, three_hd = qkv.shape
    nh = num_heads
    if three_hd % (3 * nh):
        raise ValueError(f"qkv {tuple(qkv.shape)} does not split into {nh} heads")
    d = three_hd // (3 * nh)
    if weights.dim() != 4 or tuple(weights.shape[:2]) != (B, nh) \
            or weights.shape[3] != d:
        raise ValueError(f"weights must be [{B}, {nh}, C, {d}], got "
                         f"{tuple(weights.shape)}")
    C = weights.shape[2]
    for t, what, shape in ((q_bar, "q_bar", (B, nh, C, d)),
                           (balance, "balance", (B, nh, C)),
                           (log_proposal, "log_proposal", (B, nh, C))):
        if tuple(t.shape) != shape or t.device != qkv.device:
            raise ValueError(f"{what} must be {list(shape)} on {qkv.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if not supports_lara_fused(B, N, three_hd, nh, C, qkv.element_size()):
        raise ValueError(f"lara_fused cannot take B={B}, N={N}, {nh} heads of "
                         f"{d}, {C} landmarks; see supports_lara_fused")
    qkv = qkv.contiguous()
    ops = [t.to(torch.float32).contiguous()
           for t in (weights, q_bar, balance, log_proposal)]
    out = torch.empty((B, N, nh * d), dtype=qkv.dtype, device=qkv.device)
    lib = _lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lara_fused_launch(
            qkv.data_ptr(), *(t.data_ptr() for t in ops), out.data_ptr(),
            B, N, nh, d, C, int(qkv.dtype == torch.bfloat16), float(scale),
            float(d ** -0.5), float(alpha_coeff), stream)
    if rc != 0:
        raise RuntimeError("lara_fused launch failed: "
                           f"{lib.lara_fused_error_string(rc).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    return out


class _LaraFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, weights, q_bar, balance, log_proposal, scale,
                num_heads, alpha_coeff):
        ctx.save_for_backward(qkv, weights, q_bar, balance, log_proposal)
        ctx.geometry = (scale, num_heads, alpha_coeff)
        if qkv.device.type == "cpu":
            return lara_fused_ref(qkv, weights, q_bar, balance, log_proposal,
                                  scale, num_heads, alpha_coeff)
        return _launch(qkv, weights, q_bar, balance, log_proposal, scale,
                       num_heads, alpha_coeff)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = lara_fused_ref(*leaves, *ctx.geometry)
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
        return (*grads, None, None, None)


def lara_attention_fused(
    qkv: torch.Tensor,           # [B, N, 3*H*D] fused projection output
    weights: torch.Tensor,       # [B, H, C, D] proposal means
    q_bar: torch.Tensor,         # [B, H, C, D]
    balance: torch.Tensor,       # [B, H, C]
    log_proposal: torch.Tensor,  # [B, H, C]
    scale: float,
    num_heads: int,
    alpha_coeff: float = 1.0,
) -> torch.Tensor:
    """Fused mis-opt LARA; returns ``[B, N, H*D]`` in qkv's dtype,
    differentiable in every tensor input.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    return _LaraFused.apply(qkv, weights, q_bar, balance, log_proposal,
                            float(scale), int(num_heads), float(alpha_coeff))

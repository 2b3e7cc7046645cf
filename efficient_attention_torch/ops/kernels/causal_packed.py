"""K3 ``causal_packed``: the causal-EVA joint softmax of the LM training step.

Replaces ``efficient_attention_tpu/ops/pallas/causal_packed.py::
causal_eva_packed``, the kernel that every causal-EVA decoder layer of the
LM train step (and its validation) goes through, with its fused backward.
For batch row b, window g of ``w`` tokens and head h, the queries
``q[b, g*w:(g+1)*w, h]`` attend over ``[k of the window | rf_k_bar[b, :, h]]``
with values ``[v of the window | beta[b, :, h]]`` in one softmax over
``w + C`` columns.  The additive table is the ``[w, w]`` ``bias_tab``
(causal triangle at ``MASK_VAL`` plus the head-shared T5 bias) on the local
columns; chunk column c is masked to ``MASK_VAL`` unless
``c < g*(w/cs) + i/cs`` for window row i.

Roundings follow the TPU kernel (``_joint_P``, ``_kernel``, ``_bwd_kernel``):
the summaries are taken in q's dtype; the scaled logits are rounded to the
input dtype and back before the table is added; ``P`` is normalised in f32,
then rounded to the value dtype for the value product; in the backward
``dS`` is rounded to q's dtype and ``P``'s local and chunk parts to g's
dtype before the products that use them; dbias sums the unrounded f32
``dS``; drf and dbeta are summed in f32 and cast to the summaries' dtypes.

``causal_eva_packed`` is a ``torch.autograd.Function``.  For CUDA tensors its
forward and backward launch the kernels of ``csrc/causal_packed.cu`` or
raise; for CPU tensors they compute the same function with
``causal_packed_fwd_ref`` and ``causal_packed_bwd_ref``, the plain PyTorch
versions (the backward in explicit formulas, not autograd), which are also
what the kernels are held against on the card.  ``LAUNCHES_FWD`` and
``LAUNCHES_BWD`` count the kernels' launches.

The forward and the backward each have two routes.  float32 at head dims
64 and 128 with ``w % 16 == 0`` (``fwd_uses_tf32x3``; the LM step) runs
the forward on a tensor-core kernel in split TF32 (each product as three
TF32 products, f32 sums) with an online softmax that skips the tiles the
causal mask hides for a whole 16-row strip; ``LAUNCHES_FWD_TF32`` counts
it.  The backward takes the same products where ``bwd_uses_tf32x3`` holds
(also ``w <= 128``): a block a window, row statistics in a first pass, the
five products in a second, dk and dv stored whole; ``LAUNCHES_BWD_TF32``
counts it.  Both rely on the table's strict upper triangle holding
``MASK_VAL`` (as ``causal_table`` makes it), whose columns contribute 0 in
f32.  bf16 and the other float32 geometries take the CUDA-core kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from efficient_attention_torch.ops.kernels import _build

LAUNCHES_FWD = 0
LAUNCHES_BWD = 0
LAUNCHES_FWD_TF32 = 0
LAUNCHES_BWD_TF32 = 0

NAME = "causal_packed"
SOURCE = "efficient_attention_torch/csrc/causal_packed.cu"
REPLACES_FWD = "efficient_attention_tpu/ops/pallas/causal_packed.py:165"
REPLACES_BWD = "efficient_attention_tpu/ops/pallas/causal_packed.py:284"

MASK_VAL = -5e4

# the kernels' own limits: the head dims they are instantiated for, the
# shared memory a block may use on Hopper, and the query rows a block takes
# (the largest that divides the window; the backward holds two more
# row-tiles in shared memory, so it takes fewer)
HEAD_DIMS = (64, 128)
SMEM_LIMIT = 232448
FWD_ROWS = (64, 32, 16, 8)
BWD_ROWS = (32, 16, 8)
_MAX_GRID_YZ = 65535
# the split-TF32 forward's key (and value) rows a stage, of two stages, and
# the query rows whose q it stages
TF32_KEYS = 16
TF32_MAX_ROWS = 64
# the split-TF32 backward's widest window (a block takes one, a warp a
# 16-row strip)
TF32_BWD_MAX_W = 128


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def row_stride(d: int) -> int:
    """Floats between rows of ``d`` in shared memory (``row_stride`` in
    ``csrc/causal_packed.cu``): a multiple of 4 that is 4 mod 8."""
    return ((d // 4 + 1) | 1) * 4


def smem_bytes(backward: bool, d: int, w: int, C: int, qt: int) -> int:
    """Dynamic shared memory of one block; the same layout as
    ``make_layout`` in ``csrc/causal_packed.cu``: the tile's query rows (and
    g rows in the backward), one buffer of ``w + C`` key or value rows, and
    the ``qt x (w + C)`` logits (and ``dS`` in the backward), all f32, rows
    of ``d`` at ``row_stride(d)`` and logit rows padded by one float."""
    rows = _align16(qt * row_stride(d) * 4)
    logits = _align16(qt * (w + C + 1) * 4)
    kv = _align16((w + C) * row_stride(d) * 4)
    if backward:
        return 2 * rows + kv + 2 * logits
    return rows + kv + logits


def fwd_uses_tf32x3(d: int, w: int, itemsize: int) -> bool:
    """Whether the forward takes the split-TF32 tensor-core kernel
    (``uses_tf32x3`` in ``csrc/causal_packed.cu``): float32, a head dim it
    is built for and windows of whole 16-row strips."""
    return itemsize == 4 and d in HEAD_DIMS and w % 16 == 0


def tf32_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block of the split-TF32 forward; the
    same layout as ``make_tf32_layout`` in ``csrc/causal_packed.cu``: the
    q rows of ``TF32_MAX_ROWS`` queries at a stride of ``d + 16`` floats,
    then two stages of ``TF32_KEYS`` key rows at ``d + 16`` and as many
    value rows at ``d + 4``, all f32.  It depends on nothing but ``d``."""
    return (TF32_MAX_ROWS * (d + 16) + 2 * TF32_KEYS * ((d + 16) + (d + 4))) * 4


def tf32_tiles(g: int, last: int, w: int, cs: int, C: int) -> Tuple[int, int]:
    """Local and chunk tiles of ``TF32_KEYS`` columns that window row
    ``last`` of window ``g`` can see, counted from the first: a block of the
    split-TF32 forward walks those of its last row, a 16-row strip computes
    those of its own last row and skips the rest (the kernel's ``nloc`` /
    ``sloc`` and chunk tile counts)."""
    limit = min(C, g * (w // cs) + last // cs)
    return last // TF32_KEYS + 1, -(-limit // TF32_KEYS)


def bwd_uses_tf32x3(d: int, w: int, itemsize: int) -> bool:
    """Whether the backward takes the split-TF32 tensor-core kernel
    (``bwd_uses_tf32x3`` in ``csrc/causal_packed.cu``): the forward's gate
    and windows of at most ``TF32_BWD_MAX_W`` rows, a block's."""
    return fwd_uses_tf32x3(d, w, itemsize) and w <= TF32_BWD_MAX_W


def tf32_bwd_smem_bytes(d: int, w: int) -> int:
    """Dynamic shared memory of one block of the split-TF32 backward; the
    same layout as ``make_tf32_bwd_layout`` in ``csrc/causal_packed.cu``:
    the window's ``w`` q rows and ``w`` g rows of ``d`` floats, two stages
    of ``TF32_KEYS`` key rows and as many value rows, then the P and dS
    tiles of ``TF32_KEYS`` keys by ``w`` queries at a stride of ``w + 8``,
    all f32."""
    return (2 * w * d + 2 * TF32_KEYS * 2 * d + 2 * TF32_KEYS * (w + 8)) * 4


def tf32_bwd_walk(g: int, w: int, cs: int, C: int) -> List[Tuple[bool, int, int]]:
    """The tiles that a block of the split-TF32 backward (window ``g``, all
    ``w`` rows) walks, in order, each as ``(local, u, first)``: local or
    chunk tile ``u`` of ``TF32_KEYS`` columns, and the first window row of
    the strips that compute it, whose rows to the window's end take part
    in its dk and dv (drf and dbeta).  A 16-row strip computes the tiles
    ``tf32_tiles`` gives for its last row; they form a suffix of strips."""
    nloc, nch = tf32_tiles(g, w - 1, w, cs, C)
    strips = [tf32_tiles(g, rs + 15, w, cs, C) for rs in range(0, w, 16)]
    walk = []
    for kind, (local, n) in enumerate(((True, nloc), (False, nch))):
        for u in range(n):
            first = next(s for s, seen in enumerate(strips) if u < seen[kind])
            walk.append((local, u, 16 * first))
    return walk


def plan(B: int, T: int, w: int, cs: int, C: int, num_heads: int, d: int,
         itemsize: int) -> Optional[Tuple[int, int]]:
    """Query rows a block takes in the forward and the backward, or None
    where the kernels cannot take the geometry: windows tiling the
    sequence, chunks tiling a window, a head dim they are built for,
    float32 or bfloat16, and both blocks within Hopper's shared memory."""
    if not 1 <= B <= _MAX_GRID_YZ or not 1 <= num_heads <= _MAX_GRID_YZ:
        return None
    if w <= 0 or cs <= 0 or C <= 0 or T % w or w % cs or w % 8:
        return None
    if d not in HEAD_DIMS or itemsize not in (2, 4):
        return None
    fwd = next(q for q in FWD_ROWS if w % q == 0)
    bwd = next(q for q in BWD_ROWS if w % q == 0)
    if (smem_bytes(False, d, w, C, fwd) > SMEM_LIMIT
            or smem_bytes(True, d, w, C, bwd) > SMEM_LIMIT):
        return None
    return fwd, bwd


def supports_causal_packed(B: int, T: int, w: int, cs: int, num_heads: int,
                           head_dim: int, itemsize: int = 2) -> bool:
    """Geometry gate of the kernels (JAX ``supports_causal_packed``, with the
    head dim and element size that the kernels are built for)."""
    return plan(B, T, w, cs, T // cs if cs > 0 else 0, num_heads, head_dim,
                itemsize) is not None


def causal_table(w: int, bias: Optional[torch.Tensor] = None,
                 device=None) -> torch.Tensor:
    """The ``[w, w]`` f32 additive table: ``MASK_VAL`` above the diagonal,
    plus ``bias`` (the T5 bias, already scaled) where given."""
    tab = torch.triu(torch.full((w, w), MASK_VAL, device=device), diagonal=1)
    return tab if bias is None else tab + bias.float()


def _windows(t: torch.Tensor, w: int, nh: int) -> torch.Tensor:
    """``[B, T, nh*d] -> [B, nh, G, w, d]`` in f32."""
    B, T, hd = t.shape
    return t.float().reshape(B, T // w, w, nh, hd // nh).permute(0, 3, 1, 2, 4)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_windows``: ``[B, nh, G, w, d] -> [B, T, nh*d]``."""
    B, nh, G, w, d = t.shape
    return t.permute(0, 2, 3, 1, 4).reshape(B, G * w, nh * d)


def _heads(t: torch.Tensor, nh: int) -> torch.Tensor:
    """``[B, C, nh*d] -> [B, nh, C, d]`` in f32."""
    B, C, hd = t.shape
    return t.float().reshape(B, C, nh, hd // nh).transpose(1, 2)


def _joint_add(bias_tab: torch.Tensor, G: int, w: int, cs: int, C: int
               ) -> torch.Tensor:
    """``[G, w, w + C]`` additive table of every window (``_joint_add``)."""
    dev = bias_tab.device
    row = torch.arange(w, device=dev)[None, :, None]
    first = torch.arange(G, device=dev)[:, None, None] * (w // cs)
    blocked = torch.arange(C, device=dev)[None, None, :] >= first + row // cs
    chunk = torch.where(blocked, MASK_VAL, 0.0)
    return torch.cat([bias_tab.float().expand(G, w, w), chunk], dim=-1)


def _probs(q, k, rf, bias_tab, scale, nh, w, cs):
    """Normalised joint probabilities ``[B, nh, G, w, w + C]`` (f32) and the
    window q, k and head-major rf (``_joint_P``)."""
    T = q.dtype
    qw, kw = _windows(q, w, nh), _windows(k, w, nh)
    rfh = _heads(rf.to(T), nh)
    logits = torch.cat([torch.einsum("bhgid,bhgjd->bhgij", qw, kw),
                        torch.einsum("bhgid,bhcd->bhgic", qw, rfh)],
                       dim=-1) * scale
    logits = logits.to(T).float() + _joint_add(
        bias_tab, qw.shape[2], w, cs, rfh.shape[2])
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True), qw, kw, rfh


def causal_packed_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          rf_k_bar: torch.Tensor, beta: torch.Tensor,
                          bias_tab: torch.Tensor, scale: float,
                          num_heads: int, w: int, cs: int) -> torch.Tensor:
    """Plain PyTorch forward (the counterpart of ``_kernel``): the same
    function and roundings as the kernel in f32 tensor ops.  Differentiable
    by autograd, which the tests hold the explicit backward against."""
    T = q.dtype
    P, _, _, _ = _probs(q, k, rf_k_bar, bias_tab, scale, num_heads, w, cs)
    Pr = P.to(v.dtype).float()
    out = (torch.einsum("bhgij,bhgjd->bhgid", Pr[..., :w],
                        _windows(v, w, num_heads))
           + torch.einsum("bhgic,bhcd->bhgid", Pr[..., w:],
                          _heads(beta.to(v.dtype), num_heads)))
    return _merge(out).to(T)


def causal_packed_bwd_ref(q, k, v, rf_k_bar, beta, bias_tab, g, scale: float,
                          num_heads: int, w: int, cs: int):
    """Plain PyTorch backward in explicit formulas (the counterpart of
    ``_bwd_kernel``): recompute ``P``, then ``dP = g vals^T``,
    ``dS = P (dP - sum(P dP))`` and its products.  Returns ``(dq, dk, dv,
    drf, dbeta, dbias)``: dq, dk, dv in q's dtype, drf/dbeta in the
    summaries' dtypes (summed in f32), dbias ``[w, w]`` in the table's dtype,
    summed over batch, windows and heads."""
    T = q.dtype
    nh = num_heads
    P, qw, kw, rfh = _probs(q, k, rf_k_bar, bias_tab, scale, nh, w, cs)
    gw = _windows(g.to(T), w, nh)
    vw = _windows(v, w, nh)
    bth = _heads(beta.to(T), nh)
    dP = torch.cat([torch.einsum("bhgid,bhgjd->bhgij", gw, vw),
                    torch.einsum("bhgid,bhcd->bhgic", gw, bth)], dim=-1)
    dSf = P * (dP - (P * dP).sum(dim=-1, keepdim=True))
    dS = dSf.to(T).float()
    Pr = P.to(T).float()
    dq = scale * (torch.einsum("bhgij,bhgjd->bhgid", dS[..., :w], kw)
                  + torch.einsum("bhgic,bhcd->bhgid", dS[..., w:], rfh))
    dk = scale * torch.einsum("bhgij,bhgid->bhgjd", dS[..., :w], qw)
    dv = torch.einsum("bhgij,bhgid->bhgjd", Pr[..., :w], gw)
    drf = scale * torch.einsum("bhgic,bhgid->bhcd", dS[..., w:], qw)
    dbeta = torch.einsum("bhgic,bhgid->bhcd", Pr[..., w:], gw)

    def packed(t):  # [B, nh, C, d] -> [B, C, nh*d]
        return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], -1)

    dbias = dSf[..., :w].sum(dim=(0, 1, 2)).to(bias_tab.dtype)
    return (_merge(dq).to(T), _merge(dk).to(T), _merge(dv).to(T),
            packed(drf).to(rf_k_bar.dtype), packed(dbeta).to(beta.dtype), dbias)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.causal_packed_fwd_launch.argtypes = ([ptr] * 7 + [i32] * 9
                                             + [ctypes.c_float, ptr])
    lib.causal_packed_fwd_launch.restype = i32
    lib.causal_packed_bwd_launch.argtypes = ([ptr] * 13 + [i32] * 9
                                             + [ctypes.c_float, ptr])
    lib.causal_packed_bwd_launch.restype = i32
    lib.causal_packed_fwd_tf32x3_launch.argtypes = ([ptr] * 7 + [i32] * 8
                                                    + [ctypes.c_float, ptr])
    lib.causal_packed_fwd_tf32x3_launch.restype = i32
    lib.causal_packed_bwd_tf32x3_launch.argtypes = ([ptr] * 13 + [i32] * 7
                                                    + [ctypes.c_float, ptr])
    lib.causal_packed_bwd_tf32x3_launch.restype = i32
    lib.causal_packed_smem_bytes.argtypes = [i32] * 5
    lib.causal_packed_smem_bytes.restype = i32
    lib.causal_packed_fwd_uses_tf32x3.argtypes = [i32] * 3
    lib.causal_packed_fwd_uses_tf32x3.restype = i32
    lib.causal_packed_tf32_smem_bytes.argtypes = [i32]
    lib.causal_packed_tf32_smem_bytes.restype = i32
    lib.causal_packed_tf32_blocks_per_sm.argtypes = [i32]
    lib.causal_packed_tf32_blocks_per_sm.restype = i32
    lib.causal_packed_bwd_uses_tf32x3.argtypes = [i32] * 3
    lib.causal_packed_bwd_uses_tf32x3.restype = i32
    lib.causal_packed_tf32_bwd_smem_bytes.argtypes = [i32] * 2
    lib.causal_packed_tf32_bwd_smem_bytes.restype = i32
    lib.causal_packed_tf32_bwd_blocks_per_sm.argtypes = [i32]
    lib.causal_packed_tf32_bwd_blocks_per_sm.restype = i32
    lib.causal_packed_error_string.argtypes = [i32]
    lib.causal_packed_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_operands(q, k, v, rf, beta, bias_tab, num_heads, w, cs):
    """Checked, contiguous kernel operands and the launch geometry."""
    if q.dim() != 3:
        raise ValueError(f"q must be [B, T, H*D], got {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"causal_packed takes float32 or bfloat16, got {q.dtype}")
    B, T, hd = q.shape
    nh = num_heads
    if hd % nh or w <= 0 or T % w:
        raise ValueError(f"q {tuple(q.shape)} does not split into {nh} heads "
                         f"and windows of {w}")
    for t, what in ((k, "k"), (v, "v")):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(f"{what} {tuple(t.shape)} {t.dtype} != q "
                             f"{tuple(q.shape)} {q.dtype}")
    if rf.dim() != 3 or rf.shape[0] != B or rf.shape[2] != hd:
        raise ValueError(f"rf_k_bar must be [B, C, H*D], got {tuple(rf.shape)}")
    C = rf.shape[1]
    if tuple(beta.shape) != tuple(rf.shape):
        raise ValueError(f"beta {tuple(beta.shape)} != rf_k_bar {tuple(rf.shape)}")
    if tuple(bias_tab.shape) != (w, w):
        raise ValueError(f"bias_tab must be {(w, w)}, got {tuple(bias_tab.shape)}")
    d = hd // nh
    rows = plan(B, T, w, cs, C, nh, d, q.element_size())
    if rows is None:
        raise ValueError(
            f"causal_packed cannot take B={B}, T={T}, window {w}, chunk {cs}, "
            f"{C} chunks, head dim {d}, {q.dtype}; see supports_causal_packed")
    for t, what in ((k, "k"), (v, "v"), (rf, "rf_k_bar"), (beta, "beta"),
                    (bias_tab, "bias_tab")):
        if t.device != q.device:
            raise ValueError(f"{what} is on {t.device}, q on {q.device}")
    ops = [t.contiguous() for t in (q, k, v)]
    ops += [rf.to(q.dtype).contiguous(), beta.to(q.dtype).contiguous(),
            bias_tab.to(torch.float32).contiguous()]
    return ops, (B, T, nh, d, C, rows)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where it does not start 16-byte aligned: the
    split-TF32 kernels copy rows 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"causal_packed {what} launch failed: "
                           f"{_lib().causal_packed_error_string(rc).decode()}")


def _forward(q, k, v, rf, beta, bias_tab, scale, num_heads, w, cs,
             cuda_cores=False):
    """The forward on the route ``fwd_uses_tf32x3`` picks; ``cuda_cores``
    forces the CUDA-core kernel (to time and check it beside the other)."""
    if q.device.type == "cpu":
        return causal_packed_fwd_ref(q, k, v, rf, beta, bias_tab, scale,
                                     num_heads, w, cs)
    if q.device.type != "cuda":
        raise ValueError(f"causal_packed runs on CUDA or CPU tensors, got {q.device}")
    ops, (B, T, nh, d, C, (qt, _)) = _cuda_operands(
        q, k, v, rf, beta, bias_tab, num_heads, w, cs)
    tf32 = not cuda_cores and fwd_uses_tf32x3(d, w, q.element_size())
    if tf32:
        ops = [_aligned16(t) for t in ops]
    out = torch.empty_like(ops[0])
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tf32:
            rc = lib.causal_packed_fwd_tf32x3_launch(
                *(t.data_ptr() for t in ops), out.data_ptr(), B, T, nh, d, w,
                cs, C, qt, float(scale), stream)
        else:
            rc = lib.causal_packed_fwd_launch(
                *(t.data_ptr() for t in ops), out.data_ptr(), B, T, nh, d, w,
                cs, C, qt, int(q.dtype == torch.bfloat16), float(scale), stream)
    _check(rc, "forward")
    global LAUNCHES_FWD, LAUNCHES_FWD_TF32
    LAUNCHES_FWD += 1
    LAUNCHES_FWD_TF32 += int(tf32)
    return out


def _backward(q, k, v, rf, beta, bias_tab, g, scale, num_heads, w, cs,
              cuda_cores=False):
    """The backward on the route ``bwd_uses_tf32x3`` picks; ``cuda_cores``
    forces the CUDA-core kernel (to time and check it beside the other)."""
    if q.device.type == "cpu":
        return causal_packed_bwd_ref(q, k, v, rf, beta, bias_tab, g, scale,
                                     num_heads, w, cs)
    if q.device.type != "cuda":
        raise ValueError(f"causal_packed runs on CUDA or CPU tensors, got {q.device}")
    ops, (B, T, nh, d, C, (_, qt)) = _cuda_operands(
        q, k, v, rf, beta, bias_tab, num_heads, w, cs)
    if tuple(g.shape) != tuple(q.shape) or g.device != q.device:
        raise ValueError(f"g must be {tuple(q.shape)} on {q.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    g = g.to(q.dtype).contiguous()
    tf32 = not cuda_cores and bwd_uses_tf32x3(d, w, q.element_size())
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty_like(ops[0])
    if tf32:
        # its 16-byte copies need 16-byte aligned rows; a block stores its
        # window's dk and dv whole
        ops, g = [_aligned16(t) for t in ops], _aligned16(g)
        dk, dv = torch.empty_like(ops[0]), torch.empty_like(ops[0])
    else:
        # dk, dv sum over query tiles with f32 atomics
        dk = torch.zeros((B, T, nh * d), **f32)
        dv = torch.zeros_like(dk)
    # drf, dbeta sum over windows, the dbias partials over windows and
    # query tiles, with f32 atomics
    drf = torch.zeros((B, C, nh * d), **f32)
    dbeta = torch.zeros_like(drf)
    dbias_part = torch.zeros((B, nh, w, w), **f32)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (*ops, g, dq, dk, dv, drf, dbeta, dbias_part)]
        if tf32:
            rc = lib.causal_packed_bwd_tf32x3_launch(
                *ptrs, B, T, nh, d, w, cs, C, float(scale), stream)
        else:
            rc = lib.causal_packed_bwd_launch(
                *ptrs, B, T, nh, d, w, cs, C, qt,
                int(q.dtype == torch.bfloat16), float(scale), stream)
    _check(rc, "backward")
    global LAUNCHES_BWD, LAUNCHES_BWD_TF32
    LAUNCHES_BWD += 1
    LAUNCHES_BWD_TF32 += int(tf32)
    # the per-(row, head) dbias partials are summed here, as the TPU
    # kernel's caller sums its batch-group partials
    return (dq, dk.to(q.dtype), dv.to(q.dtype), drf.to(rf.dtype),
            dbeta.to(beta.dtype), dbias_part.sum(dim=(0, 1)).to(bias_tab.dtype))


class _CausalPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rf_k_bar, beta, bias_tab, scale, num_heads, w, cs):
        ctx.save_for_backward(q, k, v, rf_k_bar, beta, bias_tab)
        ctx.geometry = (scale, num_heads, w, cs)
        return _forward(q, k, v, rf_k_bar, beta, bias_tab, scale, num_heads,
                        w, cs)

    @staticmethod
    def backward(ctx, g):
        grads = _backward(*ctx.saved_tensors, g, *ctx.geometry)
        return (*grads, None, None, None, None)


def causal_eva_packed(
    q: torch.Tensor,         # [B, T, H*D]
    k: torch.Tensor,
    v: torch.Tensor,
    rf_k_bar: torch.Tensor,  # [B, C, H*D]
    beta: torch.Tensor,      # [B, C, H*D]
    scale: float,
    num_heads: int,
    window: int,
    chunk: int,
    bias_tab: Optional[torch.Tensor] = None,  # [w, w] additive (bias + mask)
) -> torch.Tensor:
    """Causal-EVA parallel attention; returns ``[B, T, H*D]`` in q's dtype,
    differentiable in every operand, ``bias_tab`` included.

    ``bias_tab`` must already hold the local causal mask (``MASK_VAL`` above
    the diagonal) and any T5 bias; without one, the causal mask alone.  CPU
    tensors take the plain versions; CUDA tensors launch the kernels or
    raise."""
    if bias_tab is None:
        bias_tab = causal_table(window, device=q.device)
    return _CausalPacked.apply(q, k, v, rf_k_bar, beta, bias_tab, float(scale),
                               int(num_heads), int(window), int(chunk))

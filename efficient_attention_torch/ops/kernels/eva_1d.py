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

``eva_attention_1d`` launches a CUDA kernel (``csrc/eva_1d.cu``) for CUDA
tensors and raises where it cannot take them; for CPU tensors it computes
the same function with ``eva_1d_ref``, the plain PyTorch version, which is
also what the kernels are held against on the card.  f32 takes the route on
split-TF32 mma.sync strips fed by cp.async (``eva_1d_tf32x3_kernel``), a
block an item of the query rows ``plan`` picks; bf16, and f32 where
``plan`` finds no item size, the CUDA-core kernel at ``wpb_plan``'s windows
a block.
``eva_1d_strip_ref`` is the plain version with the f32 route's walk: a
16-row strip over the union of its windows' columns, groups of 32 columns
under a running max.  The kernels serve eval only (the JAX kernel has no
VJP): the wrapper raises if asked for a gradient.  ``LAUNCHES`` counts
launches on either kernel, ``LAUNCHES_TF32`` those of the f32 route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Optional, Tuple

import torch

from efficient_attention_torch.ops import windows as W
from efficient_attention_torch.ops.kernels import _build

LAUNCHES = 0
LAUNCHES_TF32 = 0

NAME = "eva_1d"
SOURCE = "efficient_attention_torch/csrc/eva_1d.cu"
REPLACES = "efficient_attention_tpu/ops/pallas/eva_1d.py:214"

MASK_VAL = -5e4
HEAD_DIMS = (16, 32, 64, 128)
SMEM_LIMIT = 232448
# query rows a block of the CUDA-core kernel (whole windows): at the WMT
# shapes 16 measured as fast as 64 at N=32 and 1.6x faster at N=256
# (PERF.md)
ROWS_PER_BLOCK = 16
_WARPS = 4
_MAX_GRID_YZ = 65535
# the f32 route: the most query rows an item (a block, a warp a 16-row
# strip), and the items of a launch (its grid)
TF32_MAX_ROWS = 128
_MAX_ITEMS = 2 ** 31 - 1
# the f32 route's query rows an item, in the order plan() tries them: the
# first whose block fits, cut to the sentence (N rounded up to 16) where it
# is shorter.  The first that fits was the fastest item size at both WMT
# shapes in the sweep (PERF.md)
TF32_ROWS = (64, 32, 16)


class Tf32Config(NamedTuple):
    """The f32 route's query rows an item (a block of ``rows // 16``
    warps) and its block's shared memory."""
    rows: int
    smem: int

    @property
    def warps(self) -> int:
        return self.rows // 16


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


def smem_bytes(d: int, ws: int, ext: int, C: int, wpb: int) -> int:
    """Dynamic shared memory of one block of the CUDA-core kernel; the same
    layout as ``make_layout`` in ``csrc/eva_1d.cu``: the run's ``wpb * ws``
    q rows, its k and v rows with the halos, the chunk keys and values (all
    f32 rows of ``d + 1``), the bias table, the additive key mask and one
    row of ``ws + 2*ext + C`` logits a warp."""
    DP, R, L = d + 1, wpb * ws, ws + 2 * ext
    KR = R + 2 * ext
    return (_align(R * DP * 4, 16) + 2 * _align(KR * DP * 4, 16)
            + 2 * _align(C * DP * 4, 16) + _align(ws * L * 4, 16)
            + _align(KR * 4, 16) + _align(_WARPS * (L + C) * 4, 16))


def wpb_plan(B: int, N: int, ws: int, ext: int, C: int, num_heads: int, d: int,
             itemsize: int) -> Optional[int]:
    """Windows a block of the CUDA-core kernel, or None where it cannot
    take the geometry: ``N`` a multiple of ``ws``, at least one chunk, a
    head dim it is built for, float32 or bfloat16, the grid within its
    limits and the block within Hopper's shared memory."""
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


def tf32_k_stride(d: int) -> int:
    """Row stride (floats) of the f32 route's q, key and chunk-key rows:
    16 mod 32 (``tf_k_stride``)."""
    return d + 16 if d % 32 == 0 else d + 32


def tf32_v_stride(d: int) -> int:
    """Row stride (floats) of the value and chunk-value rows
    (``tf_v_stride``)."""
    return d + 4


def tf32_key_rows(rows: int, ws: int, ext: int) -> int:
    """Key rows of a slot (``tf_key_rows``): the halo'd windows a run of
    ``rows`` query rows touches, plus 7 for a strip's last column tile, in
    rows of 8."""
    if rows % ws == 0:
        windows = rows // ws
    elif ws % rows == 0:
        windows = 1
    else:
        windows = rows // ws + 2
    return _align(windows * ws + 2 * ext + 7, 8)


def tf32_smem_bytes(d: int, ws: int, ext: int, C: int, rows: int) -> int:
    """Dynamic shared memory of one block of the f32 route (``make_tf_layout``
    in ``csrc/eva_1d.cu``): one item's q rows, key rows, value rows, chunk
    keys and chunk values in f32 (key-side rows at ``tf32_k_stride``,
    value-side at ``tf32_v_stride``) and its key rows' additive mask (a
    float a row), each region 128-byte aligned."""
    KS, VS = tf32_k_stride(d), tf32_v_stride(d)
    KR, CR = tf32_key_rows(rows, ws, ext), _align(C, 8)
    return (_align(rows * KS * 4, 128) + _align(KR * KS * 4, 128)
            + _align(KR * VS * 4, 128) + _align(CR * KS * 4, 128)
            + _align(CR * VS * 4, 128) + _align(KR * 4, 128))


def tf32_config_ok(d: int, ws: int, ext: int, C: int, rows: int) -> bool:
    """Whether the f32 route takes a geometry and item size
    (``tf_config_ok`` in the source): head dim 16, 32, 64 or 128, a window,
    a halo >= 0, a chunk; items of 16 to 128 query rows in steps of 16, and
    the block within Hopper's shared memory."""
    if d not in HEAD_DIMS or ws < 1 or ext < 0 or C < 1:
        return False
    if not 16 <= rows <= TF32_MAX_ROWS or rows % 16:
        return False
    return tf32_smem_bytes(d, ws, ext, C, rows) <= SMEM_LIMIT


def _tf32_fits(B: int, N: int, ws: int, ext: int, C: int, num_heads: int, d: int,
               itemsize: int, rows: int) -> Optional[Tf32Config]:
    if itemsize != 4 or B < 1 or num_heads < 1 or N < 1 or ws < 1 or N % ws:
        return None
    if (not tf32_config_ok(d, ws, ext, C, rows)
            or B * num_heads * -(-N // rows) > _MAX_ITEMS):
        return None
    return Tf32Config(rows, tf32_smem_bytes(d, ws, ext, C, rows))


@functools.lru_cache(maxsize=1024)
def plan(B: int, N: int, ws: int, ext: int, C: int, num_heads: int, d: int,
         itemsize: int) -> Optional[Tf32Config]:
    """The f32 route's item size for a launch, or None where the launch
    takes the CUDA-core kernel: float32, head dim 16, 32, 64 or 128, ``N``
    a multiple of ``ws``, at least one chunk, and the first of
    ``TF32_ROWS``, cut to ``N`` rounded up to 16, whose block fits.
    Cached: each encoder layer asks at every forward."""
    for rows in TF32_ROWS:
        cfg = _tf32_fits(B, N, ws, ext, C, num_heads, d, itemsize,
                         min(rows, _align(N, 16)))
        if cfg is not None:
            return cfg
    return None


def tf32_walk(B: int, N: int, num_heads: int,
              rows: int) -> Iterator[Tuple[int, int, int]]:
    """(sentence, head, first query row) of the f32 route's blocks in order
    (``tf_item``): block i takes head i % H of run (i / H) % runs of
    sentence i / (H runs), so the heads of one run are neighbours in the
    grid."""
    runs = -(-N // rows)
    for i in range(B * num_heads * runs):
        rest = i // num_heads
        yield rest // runs, i % num_heads, (rest % runs) * rows


def supports_1d(B: int, N: int, ws: int, ext: int, C: int, num_heads: int,
                head_dim: int, itemsize: int = 4) -> bool:
    """Geometry gate of the kernels (JAX ``supports_1d``, with the head
    dims, element sizes and shared memory of this port's kernels)."""
    return (wpb_plan(B, N, ws, ext, C, num_heads, head_dim, itemsize) is not None
            or plan(B, N, ws, ext, C, num_heads, head_dim, itemsize) is not None)


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


def eva_1d_strip_ref(qkv: torch.Tensor, rf_k_bar: torch.Tensor, beta: torch.Tensor,
                     key_padding_mask: Optional[torch.Tensor], scale: float,
                     num_heads: int, ws: int, ext: int,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version walked as the f32 route walks it, in f32 tensor
    ops: a 16-row strip at a time (the last one ragged where 16 does not
    divide N), over the union of its rows' halo'd windows in tiles of 8
    (zero keys outside [0, N) and past the last window's halo) and the
    chunk keys in tiles of 8 (zero past C); a local column outside a row's
    own window, and a chunk column past C, weigh nothing; columns in groups
    of 32 under a running max, p summed and multiplied unrounded, out = O /
    sum last.  ``[B, N, H*D]`` in f32."""
    B, N, three_hd = qkv.shape
    H, dev = num_heads, qkv.device
    d = three_hd // (3 * H)
    C, L = rf_k_bar.shape[1], ws + 2 * ext
    CR = _align(C, 8)

    def heads(t):  # [B, n, H*d] -> [B, H, n, d] in f32
        return t.float().reshape(B, -1, H, d).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.chunk(3, dim=-1))
    rf = torch.zeros(B, H, CR, d, device=dev)
    bt = torch.zeros(B, H, CR, d, device=dev)
    rf[:, :, :C], bt[:, :, :C] = heads(rf_k_bar), heads(beta)
    pad = (torch.zeros(B, N, dtype=torch.bool, device=dev) if key_padding_mask is None
           else key_padding_mask.to(torch.bool))
    out = torch.zeros(B, H, N, d, device=dev)
    for n0 in range(0, N, 16):
        last = min(n0 + 16, N) - 1
        P0 = n0 // ws * ws - ext
        nloc = (last // ws + 1) * ws + ext - P0
        cols = _align(nloc, 8)
        pos = P0 + torch.arange(cols, device=dev)
        inside = (pos >= 0) & (pos < N)
        real = inside & (pos < P0 + nloc)
        keys = torch.zeros(B, H, cols, d, device=dev)
        vals = torch.zeros(B, H, cols, d, device=dev)
        keys[:, :, real], vals[:, :, real] = k[:, :, pos[real]], v[:, :, pos[real]]
        n = n0 + torch.arange(16, device=dev)
        rows = n < N
        qs = torch.zeros(B, H, 16, d, device=dev)
        qs[:, :, rows] = q[:, :, n[rows]]
        u = pos[None] - (n // ws * ws - ext)[:, None]  # [16, cols]
        vis = (u >= 0) & (u < L) & rows[:, None]
        add = torch.where(~inside[None] | pad[:, pos.clamp(0, N - 1)], MASK_VAL, 0.0)
        local = qs @ keys.transpose(-1, -2) * scale  # [B, H, 16, cols]
        if bias is not None:
            local = local + bias.float()[:, (n % ws)[:, None], u.clamp(0, L - 1)][None]
        local = torch.where(vis, local + add[:, None, None], -torch.inf)
        chunk = qs @ rf.transpose(-1, -2) * scale
        chunk = torch.where(torch.arange(CR, device=dev) < C, chunk, -torch.inf)
        logits = torch.cat([local, chunk], dim=-1)
        values = torch.cat([vals, bt], dim=2)
        m = torch.full((B, H, 16, 1), -torch.inf, device=dev)
        den = torch.zeros(B, H, 16, 1, device=dev)
        acc = torch.zeros(B, H, 16, d, device=dev)
        for g0 in range(0, logits.shape[-1], 32):
            s = logits[..., g0:g0 + 32]
            mn = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            mref = torch.where(mn == -torch.inf, 0.0, mn)
            alpha, m = torch.exp(m - mref), mn
            pg = torch.exp(s - mref)
            den = den * alpha + pg.sum(dim=-1, keepdim=True)
            acc = acc * alpha + pg @ values[:, :, g0:g0 + 32]
        out[:, :, n[rows]] = (acc / den)[:, :, rows]
    return out.transpose(1, 2).reshape(B, N, H * d)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.eva_1d_launch.argtypes = [ptr] * 6 + [i32] * 9 + [ctypes.c_float, i32, ptr]
    lib.eva_1d_launch.restype = i32
    lib.eva_1d_smem_bytes.argtypes = [i32] * 5
    lib.eva_1d_smem_bytes.restype = i32
    lib.eva_1d_tf32_smem_bytes.argtypes = [i32] * 5
    lib.eva_1d_tf32_smem_bytes.restype = i32
    lib.eva_1d_error_string.argtypes = [i32]
    lib.eva_1d_error_string.restype = ctypes.c_char_p
    return lib


def route_config(B: int, N: int, ws: int, ext: int, C: int, num_heads: int, d: int,
                 itemsize: int, config=None) -> Optional[Tf32Config]:
    """The launch's f32-route item size, or None for the CUDA-core kernel:
    ``plan``'s where ``config`` is None; ``config`` 0 forces the CUDA-core
    kernel, a positive int f32-route items of that many query rows (to time
    the sizes ``plan`` chooses among), which must fit."""
    if config is None:
        return plan(B, N, ws, ext, C, num_heads, d, itemsize)
    if config == 0:
        return None
    cfg = _tf32_fits(B, N, ws, ext, C, num_heads, d, itemsize, int(config))
    if cfg is None:
        raise ValueError(f"eva_1d: f32-route items of {config} rows do not fit B={B}, "
                         f"N={N}, window {ws}, halo {ext}, {C} chunks, head dim {d}, "
                         f"{itemsize}-byte elements")
    return cfg


def _aligned(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if t.dtype is not dtype:
        t = t.to(dtype)
    if not t.is_contiguous():
        t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(qkv, rf_k_bar, beta, key_padding_mask, scale, num_heads, ws, ext,
            bias, config=None):
    # every call of an encoder layer comes here: the checks are kept, in
    # the cheapest form that raises on what the kernels cannot take
    dtype = qkv.dtype
    if qkv.dim() != 3 or (dtype is not torch.float32 and dtype is not torch.bfloat16):
        raise ValueError(f"qkv must be a float32 or bfloat16 [B, N, 3*H*D], got "
                         f"{dtype} {tuple(qkv.shape)}")
    B, N, three_hd = qkv.shape
    nh = num_heads
    if three_hd % (3 * nh):
        raise ValueError(f"qkv {tuple(qkv.shape)} does not split into {nh} heads")
    d = three_hd // (3 * nh)
    C = rf_k_bar.shape[1]
    device = qkv.device
    if (rf_k_bar.shape != (B, C, nh * d) or beta.shape != (B, C, nh * d)
            or rf_k_bar.device != device or beta.device != device):
        raise ValueError(f"rf_k_bar and beta must be {(B, C, nh * d)} on "
                         f"{device}, got {tuple(rf_k_bar.shape)} and "
                         f"{tuple(beta.shape)}")
    itemsize = qkv.element_size()
    tf32 = route_config(B, N, ws, ext, C, nh, d, itemsize, config)
    wpb = None if tf32 is not None else wpb_plan(B, N, ws, ext, C, nh, d, itemsize)
    if tf32 is None and wpb is None:
        raise ValueError(f"eva_1d cannot take B={B}, N={N}, window {ws}, halo "
                         f"{ext}, {C} chunks, head dim {d}, {dtype}; see "
                         "supports_1d")
    if bias is not None:
        if bias.shape != (nh, ws, ws + 2 * ext) or bias.device != device:
            raise ValueError(f"bias must be {(nh, ws, ws + 2 * ext)} on {device}, got "
                             f"{tuple(bias.shape)} on {bias.device}")
        if bias.dtype is not torch.float32 or not bias.is_contiguous():
            bias = bias.to(torch.float32).contiguous()
    mask = key_padding_mask
    if mask is not None:
        if mask.shape != (B, N) or mask.device != device:
            raise ValueError(f"key_padding_mask must be {(B, N)} on {device}, "
                             f"got {tuple(mask.shape)}")
        if mask.dtype is not torch.bool:  # a bool is one byte, 0 or 1
            mask = mask.to(torch.bool)
        if not mask.is_contiguous():
            mask = mask.contiguous()
    # the kernels read 16-byte pieces: contiguous, 16-byte aligned operands
    qkv, rf_k_bar, beta = (_aligned(qkv, dtype), _aligned(rf_k_bar, dtype),
                           _aligned(beta, dtype))
    out = torch.empty((B, N, nh * d), dtype=dtype, device=device)
    lib = _lib()
    args = (qkv.data_ptr(), rf_k_bar.data_ptr(), beta.data_ptr(),
            None if mask is None else mask.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, N, nh, d, ws, ext, C, wpb or 0, int(dtype is torch.bfloat16),
            float(scale), 0 if tf32 is None else tf32.rows)
    if device.index == torch.cuda.current_device():
        rc = lib.eva_1d_launch(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = lib.eva_1d_launch(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"eva_1d launch failed ({'f32' if tf32 else 'CUDA-core'} "
                           f"route): {lib.eva_1d_error_string(rc).decode()}")
    global LAUNCHES, LAUNCHES_TF32
    LAUNCHES += 1
    LAUNCHES_TF32 += tf32 is not None
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
    config=None,
) -> torch.Tensor:
    """Halo'd, padding-masked 1-D EVA joint softmax; returns ``[B, N, H*D]``
    in qkv's dtype.  Eval only: raises if a gradient is asked for.

    CPU tensors take the plain version; CUDA tensors launch a kernel or
    raise.  ``config`` forces a route (``route_config``: 0 the CUDA-core
    kernel, an int the f32 route's query rows an item), to time and check
    one beside the other."""
    if torch.is_grad_enabled() and (
            qkv.requires_grad or rf_k_bar.requires_grad or beta.requires_grad
            or (bias is not None and bias.requires_grad)):
        raise RuntimeError("eva_attention_1d has no backward (the kernel serves "
                           "eval); run it under torch.no_grad()")
    if qkv.is_cpu:
        return eva_1d_ref(qkv, rf_k_bar, beta, key_padding_mask, scale,
                          num_heads, ws, ext, bias)
    if not qkv.is_cuda:
        raise ValueError(f"eva_1d runs on CUDA or CPU tensors, got {qkv.device}")
    return _launch(qkv, rf_k_bar, beta, key_padding_mask, scale, int(num_heads),
                   int(ws), int(ext), bias, config)

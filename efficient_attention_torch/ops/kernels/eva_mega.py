"""K10 ``eva_mega``: the 2-D EVA eval kernels that read the tokens, not qkv.

Replaces ``efficient_attention_tpu/ops/pallas/eva_mega.py``, the kernels
behind EVA's ``use_megakernel``, two entry points:

* ``eva_summaries_from_x``: K8's chunk summaries (``eva_summaries.py``) with
  the qkv projection ``x Wqkv + bqkv`` computed inside the kernel;
* ``eva_attention_from_x``: K9's joint softmax and output projection
  (``eva_attention_packed_out`` in ``eva_packed.py``) with the qkv projection
  inside.

Both take the LN'd tokens ``x [B, N, XD]`` and ``Wqkv [XD, 3*H*D]`` (``[in,
out]``, cast to x's dtype) and ``bqkv`` (f32), so the ``[B, N, 3*H*D]`` qkv
tensor never reaches device memory.  qkv is rounded to x's dtype before
anything reads it, as the TPU kernels do, so the plain versions are the
projection, rounded, then K8's and K9's plain versions.  Neither has a
gradient: EVA takes them at eval only.

For CUDA tensors the wrappers launch the kernels of ``csrc/eva_mega.cu`` or
raise; for CPU tensors they compute the same functions with
``eva_summaries_from_x_ref`` and ``eva_attention_from_x_ref``, which are also
what the kernels are held against on the card.  ``LAUNCHES_SUMMARIES`` and
``LAUNCHES_ATTENTION`` count the kernels' launches, ``LAUNCHES_SUMMARIES_MMA``
those of the summaries on K8's persistent tensor-core route (``mma_plan`` in
``eva_summaries.py`` with ``xdim``), ``LAUNCHES_ATTENTION_MMA`` those of the
attention on K9's tensor-core route (``out_uses_mma``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from efficient_attention_torch.ops.kernels import _build
from efficient_attention_torch.ops.kernels import eva_packed as k9
from efficient_attention_torch.ops.kernels import eva_summaries as k8

LAUNCHES_SUMMARIES = 0
LAUNCHES_SUMMARIES_MMA = 0
LAUNCHES_ATTENTION = 0
LAUNCHES_ATTENTION_MMA = 0

NAME = "eva_mega"
NAME_SUMMARIES = "eva_summaries_from_x"
NAME_ATTENTION = "eva_attention_from_x"
SOURCE = "efficient_attention_torch/csrc/eva_mega.cu"
REPLACES_SUMMARIES = "efficient_attention_tpu/ops/pallas/eva_mega.py:163"
REPLACES_ATTENTION = "efficient_attention_tpu/ops/pallas/eva_mega.py:262"


def supports_mega(B: int, gh: int, gw: int, ws: int, j: int, num_landmarks: int,
                  adaptive_proj: str, dim: int, num_heads: int,
                  itemsize: int = 2) -> bool:
    """Geometry gate of both kernels: the summaries' (K8's, on a strip of x
    rows) and the attention's (K9's, with the window's x rows)."""
    if adaptive_proj not in ("default", "no-ln") or dim % num_heads:
        return False
    d = dim // num_heads
    return (k8.plan(B, num_heads, gh, gw, j, d, itemsize, xdim=dim) is not None
            and k9.plan_out(B, gh * gw, gw, ws, num_landmarks, num_heads, d,
                            itemsize, xdim=dim) is not None)


def project_qkv(x: torch.Tensor, w_qkv: torch.Tensor,
                b_qkv: torch.Tensor) -> torch.Tensor:
    """``x Wqkv + bqkv`` summed in f32 from the operands in x's dtype (the
    bias in f32), rounded to x's dtype: the qkv both kernels compute."""
    T = x.dtype
    return (x.float() @ w_qkv.to(T).float() + b_qkv.float()).to(T)


def eva_summaries_from_x_ref(
    x: torch.Tensor,                            # [B, N, XD] LN'd tokens
    w_qkv: torch.Tensor, b_qkv: torch.Tensor,   # [XD, 3*H*D] (in, out), [3*H*D]
    wq: torch.Tensor, bq: torch.Tensor,
    wk: torch.Tensor, bk: torch.Tensor,
    lnq_scale: Optional[torch.Tensor], lnq_bias: Optional[torch.Tensor],
    lnk_scale: Optional[torch.Tensor], lnk_bias: Optional[torch.Tensor],
    num_heads: int, gw: int, j: int, use_ln: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``eva_summaries_from_x``: ``(rf_k_bar, beta)``, each
    ``[B, C, H*D]`` in x's dtype."""
    return k8.eva_summaries_packed_ref(
        project_qkv(x, w_qkv, b_qkv), wq, bq, wk, bk, lnq_scale, lnq_bias,
        lnk_scale, lnk_bias, num_heads, gw, j, use_ln)


def eva_attention_from_x_ref(
    x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
    rf_k_bar: torch.Tensor, beta: torch.Tensor,
    wo: torch.Tensor, bo: torch.Tensor,
    scale: float, num_heads: int, W: int, ws: int,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of ``eva_attention_from_x``: ``[B, N, H*D]`` in x's
    dtype."""
    return k9.eva_packed_out_ref(project_qkv(x, w_qkv, b_qkv), rf_k_bar, beta,
                                 wo, bo, scale, num_heads, W, ws, bias)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.eva_mega_summaries_launch.argtypes = [ptr] * 13 + [i32] * 13 + [ptr]
    lib.eva_mega_summaries_launch.restype = i32
    lib.eva_mega_attention_launch.argtypes = ([ptr] * 9 + [i32] * 9
                                              + [ctypes.c_float, ptr])
    lib.eva_mega_attention_launch.restype = i32
    lib.eva_mega_summaries_smem_bytes.argtypes = [i32] * 4
    lib.eva_mega_summaries_smem_bytes.restype = i32
    lib.eva_mega_summaries_mma_smem_bytes.argtypes = [i32] * 7
    lib.eva_mega_summaries_mma_smem_bytes.restype = i32
    lib.eva_mega_summaries_mma_blocks_per_sm.argtypes = [i32] * 4
    lib.eva_mega_summaries_mma_blocks_per_sm.restype = i32
    lib.eva_mega_attention_smem_bytes.argtypes = [i32] * 6
    lib.eva_mega_attention_smem_bytes.restype = i32
    lib.eva_mega_attention_mma_blocks_per_sm.argtypes = [i32] * 5
    lib.eva_mega_attention_mma_blocks_per_sm.restype = i32
    lib.eva_mega_error_string.argtypes = [i32]
    lib.eva_mega_error_string.restype = ctypes.c_char_p
    return lib


def _tokens(x: torch.Tensor, w_qkv, b_qkv, num_heads: int, what: str):
    """Checked x, Wqkv (x's dtype) and bqkv (f32), and (B, N, XD, d)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, XD], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    B, N, xd = x.shape
    if w_qkv.dim() != 2 or w_qkv.shape[0] != xd or w_qkv.shape[1] % (3 * num_heads):
        raise ValueError(f"w_qkv must be [{xd}, 3*H*D], got {tuple(w_qkv.shape)}")
    three_hd = w_qkv.shape[1]
    w_qkv = k9.kernel_weight(w_qkv, (xd, three_hd), x.dtype, x, "w_qkv")
    b_qkv = k9.kernel_weight(b_qkv, (three_hd,), torch.float32, x, "b_qkv")
    return w_qkv, b_qkv, (B, N, xd, three_hd // (3 * num_heads))


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_lib().eva_mega_error_string(rc).decode()}")


def eva_summaries_from_x(
    x: torch.Tensor,                            # [B, N, XD] LN'd tokens
    w_qkv: torch.Tensor, b_qkv: torch.Tensor,   # [XD, 3*H*D] (in, out), [3*H*D]
    wq: torch.Tensor, bq: torch.Tensor,         # adaptive_mu_q Dense [d, d], [d]
    wk: torch.Tensor, bk: torch.Tensor,         # adaptive_mu_k Dense
    lnq_scale: Optional[torch.Tensor], lnq_bias: Optional[torch.Tensor],
    lnk_scale: Optional[torch.Tensor], lnk_bias: Optional[torch.Tensor],
    num_heads: int, gw: int, j: int, use_ln: bool,
    *,
    config=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval chunk summaries ``(rf_k_bar, beta)`` from the tokens, each
    ``[B, C, H*D]`` in x's dtype.  A CPU tensor goes to the plain version; a
    CUDA tensor launches the kernel or raises.  ``config`` as in
    ``eva_summaries_packed``: by default ``mma_plan`` chooses the route."""
    args = (x, w_qkv, b_qkv, wq, bq, wk, bk, lnq_scale, lnq_bias, lnk_scale,
            lnk_bias, num_heads, gw, j, use_ln)
    if x.device.type == "cpu":
        return eva_summaries_from_x_ref(*args)
    w_qkv, b_qkv, (B, N, xd, d) = _tokens(x, w_qkv, b_qkv, num_heads,
                                          "eva_summaries_from_x")
    nh = num_heads
    if gw <= 0 or N % gw or k8.plan(B, nh, N // gw, gw, j, d, x.element_size(),
                                    xdim=xd) is None:
        raise ValueError(
            f"eva_summaries_from_x cannot take B={B}, {N} tokens of width {xd} on "
            f"a grid of width {gw}, chunk {j}, head dim {d}, {x.dtype}; see "
            "supports_mega")
    cfg = k8.route_config(B, nh, N // gw, gw, j, d, x.element_size(), xd, config,
                          "eva_summaries_from_x")
    weights = k8.adaptive_operands(x, d, wq, bq, wk, bk, lnq_scale, lnq_bias,
                                   lnk_scale, lnk_bias, use_ln,
                                   "eva_summaries_from_x")
    C = (N // gw // j) * (gw // j)
    rf = torch.empty((B, C, nh * d), dtype=x.dtype, device=x.device)
    beta = torch.empty_like(rf)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.eva_mega_summaries_launch(
            x.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(),
            *[None if t is None else t.data_ptr() for t in weights],
            rf.data_ptr(), beta.data_ptr(), B, N, xd, gw, j, nh, d, int(use_ln),
            int(x.dtype == torch.bfloat16), *cfg, stream)
    _check(rc, "eva_summaries_from_x")
    global LAUNCHES_SUMMARIES, LAUNCHES_SUMMARIES_MMA
    LAUNCHES_SUMMARIES += 1
    LAUNCHES_SUMMARIES_MMA += int(cfg[0] > 0)
    return rf, beta


def eva_attention_from_x(
    x: torch.Tensor,                            # [B, N, XD] LN'd tokens
    w_qkv: torch.Tensor, b_qkv: torch.Tensor,   # [XD, 3*H*D] (in, out), [3*H*D]
    rf_k_bar: torch.Tensor,                     # [B, C, H*D]
    beta: torch.Tensor,                         # [B, C, H*D]
    wo: torch.Tensor, bo: torch.Tensor,         # [H*D, H*D] (in, out), [H*D]
    scale: float,
    num_heads: int,
    W: int,                                     # token-grid width
    ws: int,                                    # window side
    bias: Optional[torch.Tensor] = None,        # [H, S, S] window RPE bias
) -> torch.Tensor:
    """Eval forward from the tokens: qkv projection, joint softmax and output
    projection; returns ``[B, N, H*D]`` in x's dtype.  A CPU tensor goes to
    the plain version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return eva_attention_from_x_ref(x, w_qkv, b_qkv, rf_k_bar, beta, wo, bo,
                                        scale, num_heads, W, ws, bias)
    w_qkv, b_qkv, (B, N, xd, d) = _tokens(x, w_qkv, b_qkv, num_heads,
                                          "eva_attention_from_x")
    nh = num_heads
    hd = nh * d
    rf, beta, bias, C = k9.summaries_operands(rf_k_bar, beta, bias, x, B, nh, d, ws)
    if k9.plan_out(B, N, W, ws, C, nh, d, x.element_size(), xdim=xd) is None:
        raise ValueError(
            f"eva_attention_from_x cannot take B={B}, {N} tokens of width {xd} "
            f"on a grid of width {W}, window {ws}, {C} chunks, head dim {d}, "
            f"{x.dtype}; see supports_mega")
    wo = k9.kernel_weight(wo, (hd, hd), x.dtype, x, "wo")
    bo = k9.kernel_weight(bo, (hd,), torch.float32, x, "bo")
    out = torch.empty((B, N, hd), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.eva_mega_attention_launch(
            x.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), rf.data_ptr(),
            beta.data_ptr(), None if bias is None else bias.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), out.data_ptr(), B, N, xd, W, ws, nh, d,
            C, int(x.dtype == torch.bfloat16), float(scale), stream)
    _check(rc, "eva_attention_from_x")
    global LAUNCHES_ATTENTION, LAUNCHES_ATTENTION_MMA
    LAUNCHES_ATTENTION += 1
    LAUNCHES_ATTENTION_MMA += int(k9.out_uses_mma(d, x.element_size(), xd))
    return out

"""Random-feature maps for linearised softmax attention.

PyTorch counterpart of ``efficient_attention_tpu/ops/random_features.py``
(reference ``kernelized_attention.py:13-221`` and ``attn_utils.py:237-348``).
Every map takes its projection matrix explicitly; the matrices are drawn
from an explicit ``torch.Generator`` (``create_proj_matrix``).  Stabilisers
that the JAX package wraps in ``stop_gradient`` are detached here.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F


def prm_projection(data: torch.Tensor, projection: torch.Tensor,
                   normalize: bool = True, diagonal: bool = False,
                   return_exp: bool = False, is_query: bool = False,
                   eps: float = 1e-8) -> torch.Tensor:
    """``log phi(x)[m, n] = <w_m, x_n> / sqrt(d) - |x_n|^2 / (2 sqrt(d))``
    (``attn_utils.py:292-348``).

    data ``[..., n, d]``, projection ``[..., m, d]`` -> ``[..., m, n]`` (or
    ``[..., n]`` when ``diagonal``), softmax-normalised over ``n`` when
    ``normalize``, or stabilised features ``exp(.) + eps`` with
    ``return_exp``."""
    d = data.shape[-1]
    dn = d ** -0.5
    if diagonal:
        dash = (projection * (dn * data)).sum(-1)
        norm = dn * data.square().sum(-1) / 2.0
    else:
        dash = torch.einsum("...md,...nd->...mn", projection, dn * data)
        norm = dn * data.square().sum(-1)[..., None, :] / 2.0
    if normalize:
        return torch.softmax(dash - norm, dim=-1)
    if return_exp:
        if is_query:
            stab = dash.amax(dim=-2, keepdim=True).detach()
        else:
            stab = dash.amax(dim=(-1, -2, -3), keepdim=True).detach()
        return torch.exp(dash - norm - stab) + eps
    return dash - norm


def hyperm_projection(data: torch.Tensor, projection: torch.Tensor,
                      diagonal: bool = False, eps: float = 1e-4) -> torch.Tensor:
    """Hyperbolic (+/-) variant of the prm features
    (``attn_utils.py:237-288``); ``[..., 2m, n]``."""
    d = data.shape[-1]
    dn = d ** -0.5
    if diagonal:
        dash = (projection * (dn * data)).sum(-1)
        norm = dn * data.square().sum(-1) / 2.0
    else:
        dash = torch.einsum("...md,...nd->...mn", projection, dn * data)
        norm = dn * data.square().sum(-1)[..., None, :] / 2.0
    stab_pos = dash.amax(dim=(-1, -2), keepdim=True).detach()
    stab_neg = (-dash).amax(dim=(-1, -2), keepdim=True).detach()
    return math.sqrt(0.5) * (torch.cat(
        [torch.exp(dash - norm - stab_pos), torch.exp(-dash - norm - stab_neg)],
        dim=-2) + eps)


def favorp_projection(data: torch.Tensor, projection: torch.Tensor,
                      is_query: bool, eps: float = 1e-4) -> torch.Tensor:
    """Performer FAVOR+ non-negative features (``kernelized_attention.py:
    20-56``): data ``[b, h, n, d]``, projection ``[h, m, d]`` ->
    ``[b, h, n, m]``.  The query stabiliser is a max over the features of
    each token, the key stabiliser one max over ``(n, m)`` of each
    ``(b, h)``."""
    dn4 = data.shape[-1] ** -0.25
    ratio = projection.shape[-2] ** -0.5
    dash = torch.einsum("bh...d,hjd->bh...j", dn4 * data, projection)
    diag = (data.square().sum(-1) / 2.0) * dn4 ** 2
    if is_query:
        stab = dash.amax(dim=-1, keepdim=True).detach()
    else:
        stab = dash.amax(dim=(-1, -2), keepdim=True).detach()
    return ratio * torch.exp(dash - diag[..., None] - stab) + eps


def log_favorp_projection(data: torch.Tensor, projection: torch.Tensor,
                          is_query: bool) -> torch.Tensor:
    """Log-space FAVOR+ features (``scatterbrain_attention.py:10-45``)."""
    dn4 = data.shape[-1] ** -0.25
    ratio = projection.shape[-2]
    dash = torch.einsum("bh...d,hjd->bh...j", dn4 * data, projection)
    diag = (data.square().sum(-1) / 2.0) * dn4 ** 2
    return dash - diag[..., None] - math.log(ratio) / 2


def fourier_projection(data: torch.Tensor, projection: torch.Tensor,
                       is_query: Optional[bool] = None,
                       eps: float = 1e-4) -> torch.Tensor:
    """Random Fourier features (``kernelized_attention.py:58-85``):
    ``[b, h, n, 2m]``."""
    del is_query, eps
    dn4 = data.shape[-1] ** -0.25
    dash = torch.einsum("bn...d,njd->bn...j", dn4 * data, projection)
    ratio = projection.shape[-2] ** -0.5
    phi = ratio * torch.cat([torch.sin(dash), torch.cos(dash)], dim=-1)
    h = (data.square().sum(-1) / 2.0) * dn4 ** 2
    h = torch.exp(h - h.amax(dim=-1, keepdim=True).detach())[..., None]
    return h * phi


def dpfp_projection(x: torch.Tensor, is_query: bool = True,
                    nu: int = 1) -> torch.Tensor:
    """Deterministic parameter-free projection (``kernelized_attention.py:
    13-18``): ``[..., 2 d nu]``."""
    del is_query
    x = torch.cat([F.relu(x), F.relu(-x)], dim=-1)
    rolled = torch.cat([torch.roll(x, shifts=j, dims=-1)
                        for j in range(1, nu + 1)], dim=-1)
    return torch.cat([x] * nu, dim=-1) * rolled


def generalized_projection(data: torch.Tensor, projection: torch.Tensor,
                           is_query: bool,
                           projection_fn: Callable[[torch.Tensor], torch.Tensor],
                           eps: float = 1e-3) -> torch.Tensor:
    """``f(W x) + eps`` features, e.g. relu (``kernelized_attention.py:
    90-114``)."""
    del is_query
    ratio = projection.shape[-2] ** -0.5
    dn4 = data.shape[-1] ** -0.25
    dash = ratio * torch.einsum("bn...d,njd->bn...j", dn4 * data, projection)
    return projection_fn(dash) + eps


def nonlinear_map(data: torch.Tensor,
                  mapping_fn: Callable[[torch.Tensor], torch.Tensor],
                  is_query: bool = False, eps: float = 1e-1) -> torch.Tensor:
    """Projection-free elementwise features (``kernelized_attention.py:87``)."""
    del is_query
    return mapping_fn(data) + eps


def linear_attention(q_prime: torch.Tensor, k_prime: torch.Tensor,
                     v: torch.Tensor, eps: float = 1e-2) -> torch.Tensor:
    """``q' (k'^T v) / clip(q' sum_n k', eps)`` (``kernelized_attention.py:
    116-121``); the module runs it in f32 (``:345``)."""
    kv = torch.einsum("...nm,...nd->...md", k_prime, v)
    qkv = torch.einsum("...nm,...md->...nd", q_prime, kv)
    normalizer = torch.einsum("...nm,...m->...n", q_prime, k_prime.sum(-2))
    return qkv / normalizer[..., None].clamp(min=eps)


def cos_reweighted_linear_attention(q_prime: torch.Tensor,
                                    k_prime: torch.Tensor, v: torch.Tensor,
                                    eps: float = 1e-2) -> torch.Tensor:
    """cosFormer re-weighted linear attention (``kernelized_attention.py:
    123-156``)."""
    max_len = v.shape[-2]
    idxs = (math.pi / 2) * torch.arange(max_len, dtype=v.dtype,
                                        device=v.device) / max_len
    cos, sin = torch.cos(idxs)[None, None, :, None], torch.sin(idxs)[None, None, :, None]
    q_cos, q_sin = q_prime * cos, q_prime * sin
    k_cos, k_sin = k_prime * cos, k_prime * sin
    kv_cos = torch.einsum("...nm,...nd->...md", k_cos, v)
    kv_sin = torch.einsum("...nm,...nd->...md", k_sin, v)
    qkv = (torch.einsum("...nm,...md->...nd", q_cos, kv_cos)
           + torch.einsum("...nm,...md->...nd", q_sin, kv_sin))
    normalizer = (torch.einsum("...nm,...m->...n", q_cos, k_cos.sum(-2))
                  + torch.einsum("...nm,...m->...n", q_sin, k_sin.sum(-2)))
    return qkv / normalizer[..., None].clamp(min=eps)


def orthogonal_gaussian_matrix(nb_rows: int, nb_cols: int,
                               generator: Optional[torch.Generator] = None,
                               dtype=torch.float32) -> torch.Tensor:
    """Gaussian matrix with orthogonal row blocks, each row rescaled to the
    norm of a Gaussian row (``kernelized_attention.py:201-221``).  Drawn on
    the CPU from ``generator``."""
    n_blocks = -(-nb_rows // nb_cols)
    blocks = []
    for _ in range(n_blocks):
        unstructured = torch.randn(nb_cols, nb_cols, generator=generator)
        q, _ = torch.linalg.qr(unstructured)
        blocks.append(q.t())
    final = torch.cat(blocks, dim=0)[:nb_rows]
    multiplier = torch.randn(nb_rows, nb_cols, generator=generator).norm(dim=1)
    return (multiplier[:, None] * final).to(dtype)


def create_proj_matrix(num_heads: int, proj_dim: int, input_dim: int,
                       ortho: bool = False,
                       generator: Optional[torch.Generator] = None,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-head projection matrices ``[h, m, d]``
    (``kernelized_attention.py:191-199``): orthogonal Gaussian blocks with
    ``ortho`` (drawn on the CPU), else i.i.d. Gaussian drawn on ``device``;
    both from ``generator``."""
    if ortho:
        return torch.stack([orthogonal_gaussian_matrix(proj_dim, input_dim,
                                                       generator, dtype)
                            for _ in range(num_heads)]).to(device)
    return torch.randn(num_heads, proj_dim, input_dim, generator=generator,
                       device=device).to(dtype)

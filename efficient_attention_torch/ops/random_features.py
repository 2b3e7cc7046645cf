"""Random-feature maps for linearised softmax attention.

Only ``prm_projection``, the positive-random-feature log density that causal
EVA's chunk summaries take, is ported (JAX
``efficient_attention_tpu/ops/random_features.py:23-60``, reference
``attn_utils.py:292-348``); the other feature maps come with
``attention/kernelized.py`` (ROADMAP.md Queue 1, item 4).
"""
from __future__ import annotations

import torch


def prm_projection(data: torch.Tensor, projection: torch.Tensor,
                   normalize: bool = True) -> torch.Tensor:
    """``log phi(x)[m, n] = <w_m, x_n> / sqrt(d) - |x_n|^2 / (2 sqrt(d))``.

    data ``[..., n, d]``, projection ``[..., m, d]`` -> ``[..., m, n]``,
    softmax-normalised over ``n`` when ``normalize``."""
    d = data.shape[-1]
    dn = d ** -0.5
    dash = torch.einsum("...md,...nd->...mn", projection, dn * data)
    norm = dn * data.square().sum(-1)[..., None, :] / 2.0
    if normalize:
        return torch.softmax(dash - norm, dim=-1)
    return dash - norm

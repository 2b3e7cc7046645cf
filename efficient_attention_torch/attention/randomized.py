"""Randomized attention (RA), the quadratic-cost ancestor of LARA.

PyTorch counterpart of ``efficient_attention_tpu/attention/randomized.py``
(reference ``randomized_attention.py``, ICML 2022, "Linear Complexity
Randomized Self-attention Mechanism").  Each query takes a random-feature
weight ``w = q + k'`` with ``k'`` a key drawn from the softmax attention
distribution ``pi`` of that query, plus Gaussian noise in training, and
attends by the self-normalised importance-sampling (SNIS) estimate of
softmax attention.

Both draws come from ``self.generator`` (``models.layers.set_generator``
hands it the train step's), as ``LinearRA`` and ``KernelizedAttention``
draw theirs; with none set, the key draw takes a generator seeded 0, as
the JAX package falls back to ``PRNGKey(0)`` where no ``sample`` stream is
given (it draws at eval too, ``randomized.py:48-51``).  The two packages'
generators give different numbers: to compute what the JAX module
computes, hand both the same key indices (``_sample_key_indices``) and
noise (``_proposal_noise``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from efficient_attention_torch.attention.base import MultiheadAttention


class RandomizedAttention(MultiheadAttention):
    """RA with ``num_samples`` of 0 (``mu = q + mean k``), -1 (``mu = q +
    E_pi[k]``) or k (one key drawn from ``pi`` per query, held constant in
    the backward) (``randomized_attention.py:11-53``)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 fp32: bool = False, num_samples: int = 1):
        super().__init__(dim, num_heads, qkv_bias=qkv_bias,
                         attn_drop=attn_drop, proj_drop=proj_drop, fp32=fp32)
        self.num_samples = num_samples
        self.generator: Optional[torch.Generator] = None

    def _generator(self, device: torch.device) -> torch.Generator:
        if self.generator is not None:
            return self.generator
        return torch.Generator(device=device).manual_seed(0)

    def _sample_key_indices(self, pi: torch.Tensor) -> torch.Tensor:
        """One categorical draw of a key index per query from ``pi [..., n,
        m]`` (rows summing to 1): ``[..., n]``, by the inverse of each
        row's cumulative sum at a uniform draw."""
        cdf = pi.float().cumsum(dim=-1)
        u = torch.rand(cdf.shape[:-1] + (1,), generator=self._generator(pi.device),
                       device=pi.device) * cdf[..., -1:]
        return (cdf <= u).sum(dim=-1).clamp_max(pi.shape[-1] - 1)

    def _proposal_noise(self, shape: Tuple[int, ...],
                        like: torch.Tensor) -> torch.Tensor:
        """Standard normal noise of ``shape`` for the training proposal
        (``randomized_attention.py:40-41``), from ``self.generator``."""
        return torch.randn(shape, generator=self.generator, dtype=like.dtype,
                           device=like.device)

    def _apply_attention(self, q, k, v, key_padding_mask):
        if self.num_samples == 0:
            mu = q + k.mean(dim=-2, keepdim=True)
        else:
            pi = F.softmax(torch.einsum("...nd,...md->...nm", self.scale * q, k),
                           dim=-1)
            if self.num_samples == -1:
                mu = q + torch.einsum("...nm,...md->...nd", pi, k)
            else:
                k_ind = self._sample_key_indices(pi.detach())  # [b, h, n]
                k_prime = torch.gather(
                    k, -2, k_ind[..., None].expand(*k_ind.shape, k.shape[-1]))
                mu = q + k_prime.detach()
        if self.training:
            mu = mu + self._proposal_noise(tuple(mu.shape), mu)
        # the SNIS estimate of softmax attention
        # (``randomized_attention.py:44-51``)
        data_dash = torch.einsum("...nd,...md->...nm", mu, self.scale * k)
        norm = self.scale * k.square().sum(dim=-1)[..., None, :] / 2.0
        data_dash = data_dash - norm
        if key_padding_mask is not None:
            data_dash = data_dash.masked_fill(
                key_padding_mask[:, None, None, :].bool(), float("-inf"))
        snis = F.softmax(data_dash, dim=-1)
        return torch.einsum("...nm,...md->...nd", snis, v)

    @staticmethod
    def add_attn_specific_args(parent_parser, struct_name="attn_args", prefix=""):
        from efficient_attention_torch.config import add_nested_argument

        parent_parser = MultiheadAttention.add_attn_specific_args(
            parent_parser, struct_name=struct_name, prefix=prefix
        )
        parser = parent_parser.add_argument_group("Attention")
        p = prefix + "-" if len(prefix) > 1 else ""
        add_nested_argument(parser, f"--{p}num-samples", struct_name=struct_name,
                            prefix=prefix, default=1, type=int,
                            help="number of posterior samples")
        return parent_parser

"""Tests of the PyTorch port that need an NVIDIA GPU (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is false.  This file imports
neither JAX nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from efficient_attention_torch.ops.kernels import eva_single as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _k2_args(device, dtype, B, g, ws, j, nh, d, use_ln, seed=13):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    qkv = t(B, g * g, 3 * nh * d).to(dtype)
    dense = [0.2 * t(d, d), 0.1 * t(d), 0.2 * t(d, d), 0.1 * t(d)]
    ln = ([1 + 0.1 * t(d), 0.1 * t(d), 1 + 0.1 * t(d), 0.1 * t(d)]
          if use_ln else [None] * 4)
    return (qkv, *dense, *ln, d ** -0.5, nh, g, ws, j, use_ln), t(nh, ws * ws, ws * ws)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -6)])
@pytest.mark.parametrize("geometry", [(2, 28, 7, 4, 3, 64, True),
                                      (2, 14, 7, 2, 4, 12, True),
                                      (2, 8, 4, 4, 3, 16, False)])
def test_eva_single_kernel_matches_plain(cuda_device, geometry, dtype, tol):
    """Kernel vs plain version on the same card inputs: in f32 they differ
    only in summation order; in bf16 also by one rounding of outputs below
    4 (bf16 spacing 2**-6 there)."""
    args, bias = _k2_args(cuda_device, dtype, *geometry)
    before = K.LAUNCHES
    out = K.eva_attention_single(*args, bias=bias)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    ref = K.eva_attention_single_ref(*args, bias=bias)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_eva_single_kernel_raises_outside_its_gate(cuda_device):
    args, bias = _k2_args(cuda_device, torch.float32, 1, 8, 4, 4, 2, 24, True)
    with pytest.raises(ValueError, match="cannot take"):  # head dim 24
        K.eva_attention_single(*args, bias=bias)
    args, bias = _k2_args(cuda_device, torch.float16, 1, 8, 4, 4, 3, 16, True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K.eva_attention_single(*args, bias=bias)

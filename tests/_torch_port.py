"""Helpers shared by the parity tests of the PyTorch port (test_torch_*.py).

Inputs and weights are made with numpy from a seed and handed to both
packages.  JAX runs on the CPU at ``highest`` matmul precision
(``conftest.py``); the torch side is pinned to full float32 by
``exact_float32``.

Importing this module caps torch's intra-op threads at a sixth of the CPU's
cores (at least one): the suite runs in six processes at once, and torch's
default of one thread a core in each made them contend (a 60-step training
replay took minutes instead of seconds).
"""
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))


@contextlib.contextmanager
def exact_float32():
    """No TF32 in torch matmuls or cuDNN convolutions, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def randomize(params, seed: int):
    """A flax param tree with every leaf redrawn from numpy: Dense/conv
    kernels ~ N(0, 1/fan_in), biases ~ 0.1 N, LayerNorm scales ~ 1 + 0.1 N,
    learned tables and embeddings ~ 0.5 N.  Returns numpy leaves."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = np.shape(leaf)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            val = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "bias":
            val = 0.1 * rng.standard_normal(shape)
        elif name == "scale":
            val = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            val = 0.5 * rng.standard_normal(shape)
        return val.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(params))


def to_jax(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def jax_apply(module, params, x: np.ndarray) -> np.ndarray:
    return np.asarray(module.apply(to_jax(params), jnp.asarray(x),
                                   deterministic=True))


def torch_apply(module: torch.nn.Module, x: np.ndarray) -> np.ndarray:
    with exact_float32(), torch.no_grad():
        return module.eval()(torch.from_numpy(x)).numpy()

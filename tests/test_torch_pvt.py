"""PVTv2 of the PyTorch port against the JAX package, on the CPU.

The reference golden ``pvt_full_model.npz`` (``pvt_nano`` + 2-D EVA at
64 px) loads with ``load_state_dict(strict=True)`` and must give its logits
to 5e-5 abs / 1e-4 rel (``tests/test_interop.py::TestConvertPvt``'s
tolerance); ``pvt_nano`` at 64 px with the JAX model's numpy-drawn weights
(carried by ``interop.load_jax_params``) must give the JAX logits to the
same tolerance with EVA on each route (``auto``, ``pallas`` through K11,
``rowmajor`` through K12: the kernels' plain versions on the CPU), with
exact softmax, and with the ``use_conv_patchify`` stem; the CLI serves
``pvt_nano`` with ``--eval``.  Float32, TF32 off.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32, randomize, to_jax
from efficient_attention_tpu.models import create_model as jax_create_model
from efficient_attention_torch.interop import load_jax_params
from efficient_attention_torch.models import create_model
from efficient_attention_torch.models.layers import (
    MlpWithDepthwiseConv,
    OverlapPatchEmbed,
)

TOL = dict(atol=5e-5, rtol=1e-4)
EVA_ARGS = {"window_size": 4, "num_landmarks": 4, "attn_2d": True,
            "use_rpe": True, "adaptive_proj": "default"}


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def test_golden_loads_strictly_and_matches():
    data = np.load("tests/goldens/pvt_full_model.npz")
    sd = {k[len("sd:"):]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd:")}
    m = create_model("pvt_nano", attn_name="eva", attn_args={
        "window_size": 2, "num_landmarks": 4, "attn_2d": True,
        "use_rpe": True, "adaptive_proj": "default"}, img_size=64,
        num_classes=10)
    m.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(data["x"])).numpy()
    np.testing.assert_allclose(out, data["out"], **TOL)


@functools.lru_cache(maxsize=None)
def _jax_pvt(attn_name, use_conv_patchify=False):
    """(x, flax params, JAX logits) of ``pvt_nano`` at 64 px, 10 classes."""
    kw = dict(attn_name=attn_name,
              attn_args=dict(EVA_ARGS, impl="xla") if attn_name == "eva" else {},
              img_size=64, num_classes=10, use_conv_patchify=use_conv_patchify)
    jm = jax_create_model("pvt_nano", **kw)
    x = np.random.default_rng(41).standard_normal((2, 64, 64, 3)).astype(np.float32)
    params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 42)
    out = jax.jit(lambda p, xx: jm.apply(p, xx, deterministic=True))(
        to_jax(params), jnp.asarray(x))
    return x, params, np.asarray(out)


@pytest.mark.parametrize("attn_name,impl,stem,wrapper", [
    ("eva", "auto", False, "eva_attention_single"),
    ("eva", "pallas", False, "eva_attention_fused"),
    ("eva", "rowmajor", False, "eva_attention_rowmajor"),
    ("softmax", None, False, None),
    ("eva", "auto", True, "eva_attention_single"),
])
def test_pvt_nano_matches_jax(monkeypatch, attn_name, impl, stem, wrapper):
    """Eval logits against the JAX model on the same weights; each EVA
    block (6 in the three EVA stages) takes the route's kernel wrapper."""
    import efficient_attention_torch.attention.eva as eva_module

    x, params, ref = _jax_pvt(attn_name, stem)
    attn_args = dict(EVA_ARGS, impl=impl) if attn_name == "eva" else {}
    m = load_jax_params(create_model(
        "pvt_nano", attn_name=attn_name, attn_args=attn_args, img_size=64,
        num_classes=10, use_conv_patchify=stem), params).eval()
    calls = []
    if wrapper is not None:
        real = getattr(eva_module, wrapper)
        monkeypatch.setattr(eva_module, wrapper,
                            lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        out = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert len(calls) == (6 if wrapper else 0)


def test_layers_match_flax_defaults():
    """LayerNorm and GroupNorm at flax's epsilon 1e-6; the MLP's GELU is the
    tanh form, its ReLU only with ``linear``; the stem's GroupNorms."""
    pe = OverlapPatchEmbed(7, 4, 3, 32)
    assert pe.norm.eps == 1e-6 and pe.proj.padding == (3, 3)
    stem = OverlapPatchEmbed(7, 4, 3, 32, use_conv_patchify=True)
    assert [type(mod).__name__ for mod in stem.proj] == [
        "Conv2d", "GroupNorm", "GELU", "Conv2d", "GroupNorm", "GELU", "Conv2d",
        "GroupNorm"]
    assert all(mod.eps == 1e-6 for mod in stem.proj if hasattr(mod, "eps"))
    x = torch.randn(1, 4, 4, 8)
    mlp = MlpWithDepthwiseConv(8, 16, linear=True)
    h = torch.relu(mlp.fc1(x))
    want = mlp.fc2(torch.nn.functional.gelu(mlp.dwconv(h), approximate="tanh"))
    torch.testing.assert_close(mlp(x), want)


def test_cli_serves_pvt_nano_on_the_cpu(monkeypatch):
    """``cli.train_vit --model pvt_nano --eval --device cpu`` at 64 px: 4
    finite batches; ``impl`` set on the attention args reaches every EVA
    block (K11 six times a batch), and ``--use-conv-patchify`` reaches the
    model."""
    import efficient_attention_torch.attention.eva as eva_module
    from efficient_attention_torch.cli import train_vit

    argv = ["--model", "pvt_nano", "--attn-name", "eva", "--attn-window-size",
            "4", "--attn-num-landmarks", "4", "--attn-attn-2d", "--attn-use-rpe",
            "--input-size", "64", "--batch-size", "2", "--num-classes", "10",
            "--num-workers", "1", "--eval", "--device", "cpu"]
    args = train_vit.parse_args(argv)
    args.attn_specific_args.impl = "pallas"
    calls = []
    real = eva_module.eva_attention_fused
    monkeypatch.setattr(eva_module, "eva_attention_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    stats = train_vit.main(args)
    assert stats["batches"] == 4 and len(calls) == 6 * 4
    assert all(np.isfinite(stats[k]) for k in ("acc1", "acc5", "loss"))
    model = train_vit.build_model(train_vit.parse_args(argv + ["--use-conv-patchify"]))
    assert isinstance(model.patch_embed1.proj, torch.nn.Sequential)
    with pytest.raises(NotImplementedError, match="checkpoint-activations"):
        train_vit.build_model(train_vit.parse_args(
            argv + ["--checkpoint-activations"]))

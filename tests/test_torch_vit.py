"""The ViT of the PyTorch port against the JAX package, and its CLI.

Full-model logits of the port's ``EfficientTransformer`` (weights carried
from the JAX model by ``state_dict_from_jax``) must match the JAX model's in
float32 to 1e-4 abs / 1e-4 rel; the recorded reference full-model goldens
load with ``load_state_dict`` and match to 3e-5 abs / 1e-4 rel (as
``test_interop.py`` holds the JAX model).
"""
import argparse
import ast
import functools
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32, jax_apply, randomize, to_jax, torch_apply
from efficient_attention_tpu.models.efficient_vit import (
    EfficientTransformer as JaxViT,
)
from efficient_attention_torch.interop import load_jax_params, state_dict_from_jax
from efficient_attention_torch.models import EfficientTransformer, create_model

ATOL, RTOL = 1e-4, 1e-4
GOLDEN_ATOL = 3e-5
REPO = pathlib.Path(__file__).resolve().parents[1]
EVA_ARGS = {"window_size": 7, "num_landmarks": 49, "attn_2d": True,
            "use_rpe": True, "adaptive_proj": "default"}
# the serving cells' attentions (the recipes' flags at the golden widths)
ATTN_ARGS = {
    "eva": EVA_ARGS,
    "lara": {"num_landmarks": 49, "proposal_gen": "pool-mixed",
             "mis_type": "mis-opt", "alpha_coeff": 2.0},
    "performer": {"approx_attn_dim": 16, "proj_method": "favorp"},
    "local": {"window_size": 7, "attn_2d": True, "use_rpe": True},
    "softmax": {},
}
# the golden geometry: 112 px, patch 8 (14x14 tokens), dim 48, 4 heads
GOLDEN_VIT = dict(img_size=112, patch_size=8, embed_dim=48, depth=2,
                  num_heads=4, num_classes=10)
# the main path's geometry at depth 1: 224 px, patch 8 (28x28 tokens), dim
# 192, 3 heads; 4x4-token chunks straddle the 7x7 windows
REAL_VIT = dict(img_size=224, patch_size=8, embed_dim=192, depth=1,
                num_heads=3, num_classes=100)


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


@functools.lru_cache(maxsize=None)
def _jax_vit(attn_name, geometry):
    cfg = dict(GOLDEN_VIT if geometry == "golden" else REAL_VIT)
    attn_args = dict(ATTN_ARGS[attn_name])
    if attn_name != "softmax":
        attn_args["impl"] = "xla"
    batch = 2 if geometry == "golden" else 1
    x = np.random.default_rng(11).standard_normal(
        (batch, cfg["img_size"], cfg["img_size"], 3)).astype(np.float32)
    m = JaxViT(attn_name=attn_name, attn_args=attn_args, **cfg)
    params = randomize(jax.jit(m.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1])),
                       seed=12)
    return x, params, np.asarray(jax.jit(
        lambda p, xx: m.apply(p, xx, deterministic=True))(to_jax(params),
                                                          jnp.asarray(x)))


def _port_vit(attn_name, geometry, impl="auto", extra=None):
    """The port's ViT; ``extra`` adds attention args (EVA's eval toggles)."""
    cfg = dict(GOLDEN_VIT if geometry == "golden" else REAL_VIT)
    attn_args = dict(ATTN_ARGS[attn_name], **(extra or {}))
    if impl is not None:
        attn_args["impl"] = impl
    return EfficientTransformer(attn_name=attn_name, attn_args=attn_args, **cfg)


# EVA's eval routes off the default K2 one, by the toggles that select them
EVA_ROUTES = {
    "megakernel": dict(use_single_kernel=False, use_megakernel=True),
    "summaries+fused-out": dict(use_single_kernel=False,
                                use_pallas_summaries=True,
                                fuse_output_proj=True),
}


def _jax_eval_projection(cfg):
    """The JAX Performer's eval matrix at ``cfg``'s heads, for the port's
    ``random_proj`` buffers."""
    from efficient_attention_tpu.ops.random_features import create_proj_matrix

    nh = cfg["num_heads"]
    return np.asarray(create_proj_matrix(
        jax.random.PRNGKey(0), nh, ATTN_ARGS["performer"]["approx_attn_dim"],
        cfg["embed_dim"] // nh, ortho=True))


@pytest.mark.parametrize("attn_name,geometry,impl", [
    ("eva", "golden", "auto"),
    ("eva", "golden", "xla"),
    ("softmax", "golden", None),
    ("eva", "real", "auto"),
    ("eva", "real", "xla"),
    ("lara", "golden", "fused"),
    ("lara", "golden", "xla"),
    ("performer", "golden", "fused"),
    ("performer", "golden", "xla"),
    ("local", "golden", "auto"),
    ("local", "golden", "xla"),
    ("eva", "golden", "megakernel"),
    ("eva", "golden", "summaries+fused-out"),
])
def test_vit_matches_jax(monkeypatch, attn_name, geometry, impl):
    """Full-model logits, weights carried from JAX with strict=True; for
    lara and performer 'fused' runs K5/K6's plain versions in every block,
    for local 'auto' runs K7's; EVA's 'megakernel' runs K10's and
    'summaries+fused-out' K8's and K9's (``EVA_ROUTES``)."""
    import efficient_attention_torch.attention.eva as eva_module

    x, params, ref = _jax_vit(attn_name, geometry)
    proj = _jax_eval_projection(GOLDEN_VIT) if attn_name == "performer" else None
    extra = EVA_ROUTES.get(impl)
    calls = []
    for name in ("eva_attention_from_x", "eva_attention_packed_out"):
        monkeypatch.setattr(eva_module, name,
                            lambda *a, _f=getattr(eva_module, name), **k:
                            calls.append(1) or _f(*a, **k))
    m = load_jax_params(_port_vit(attn_name, geometry,
                                  "auto" if extra else impl, extra),
                        params, random_proj=proj)
    np.testing.assert_allclose(torch_apply(m, x), ref, atol=ATOL, rtol=RTOL)
    assert len(calls) == (GOLDEN_VIT["depth"] if extra else 0)


def _golden_sd(name):
    data = np.load(os.path.join(os.path.dirname(__file__), "goldens", name))
    sd = {k[len("sd:"):]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd:")}
    return data["x"], data["out"], sd


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_golden_evit_full_model_loads_strictly(impl):
    x, ref, sd = _golden_sd("evit_full_model.npz")
    m = EfficientTransformer(attn_name="eva", attn_args=dict(EVA_ARGS, impl=impl),
                             **GOLDEN_VIT)
    m.load_state_dict(sd, strict=True)
    np.testing.assert_allclose(torch_apply(m, x), ref, atol=GOLDEN_ATOL, rtol=RTOL)


def test_golden_softmax_full_model_loads_strictly():
    x, ref, sd = _golden_sd("softmax_full_model.npz")
    m = EfficientTransformer(attn_name="softmax", attn_args={}, **GOLDEN_VIT)
    m.load_state_dict(sd, strict=True)
    np.testing.assert_allclose(torch_apply(m, x), ref, atol=GOLDEN_ATOL, rtol=RTOL)


def test_state_dict_from_jax_names_match_the_reference():
    """Carried JAX params bear exactly the reference checkpoint's names and
    shapes (the golden's ``relative_position_index`` buffers aside)."""
    _, params, _ = _jax_vit("eva", "golden")
    _, _, sd = _golden_sd("evit_full_model.npz")
    carried = state_dict_from_jax(params)
    expected = {k: tuple(v.shape) for k, v in sd.items()
                if not k.endswith("relative_position_index")}
    assert {k: tuple(v.shape) for k, v in carried.items()} == expected


def test_gated_mlp_glu_matches_jax():
    from efficient_attention_tpu.models.layers import GatedMlp as JaxMlp
    from efficient_attention_torch.models.layers import GatedMlp

    x = np.random.default_rng(13).standard_normal((2, 5, 24)).astype(np.float32)
    jm = JaxMlp(hidden_features=96, use_glu=True)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=14)
    ref = jax_apply(jm, params, x)
    m = GatedMlp(24, 96, use_glu=True)
    p = params["params"]
    with torch.no_grad():
        for name, dense in (("fc1", "Dense_0"), ("fc2", "Dense_1")):
            getattr(m, name).weight.copy_(torch.from_numpy(p[dense]["kernel"].T))
            getattr(m, name).bias.copy_(torch.from_numpy(p[dense]["bias"]))
    np.testing.assert_allclose(torch_apply(m, x), ref, atol=3e-5, rtol=RTOL)


def test_eval_step_matches_jax():
    from efficient_attention_tpu.training.train_state import make_vit_eval_step
    from efficient_attention_torch.training.train_state import vit_eval_step

    rng = np.random.default_rng(15)
    logits = rng.standard_normal((16, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 16)
    ref = make_vit_eval_step()(None, lambda p, x, deterministic: x,
                               jnp.asarray(logits), jnp.asarray(labels))
    out = vit_eval_step(lambda x: x, torch.from_numpy(logits),
                        torch.from_numpy(labels))
    for k in ("acc1", "acc5", "loss"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-6)


def test_synthetic_dataset_matches_jax():
    from efficient_attention_tpu.data.imagenet import (
        SyntheticImageDataset as JaxDataset,
    )
    from efficient_attention_torch.data.imagenet import (
        PrefetchLoader,
        SyntheticImageDataset,
    )

    ds, jds = SyntheticImageDataset(6, 16, 4, train=False), JaxDataset(6, 16, 4)
    for i in range(6):
        img, label = ds.load(i, np.random.default_rng(0))
        jimg, jlabel = jds.load(i, np.random.default_rng(0))
        np.testing.assert_array_equal(img, jimg)
        assert label == jlabel
    batches = list(PrefetchLoader(ds, 4, np.arange(6), num_threads=2))
    assert len(batches) == 1 and batches[0][0].shape == (4, 16, 16, 3)


# each cell's attention flags (the serving cells of PERF.md)
CELL_FLAGS = {
    "eva": ["--attn-name", "eva", "--attn-window-size", "7",
            "--attn-num-landmarks", "49", "--attn-attn-2d", "--attn-use-rpe"],
    "lara": ["--attn-name", "lara", "--attn-num-landmarks", "49",
             "--attn-proposal-gen", "pool-mixed", "--attn-mis-type", "mis-opt",
             "--attn-alpha-coeff", "2.0"],
    "performer": ["--attn-name", "performer", "--attn-approx-attn-dim", "64",
                  "--attn-proj-method", "favorp"],
    "local": ["--attn-name", "local", "--attn-window-size", "7",
              "--attn-attn-2d", "--attn-use-rpe"],
}


def _eval_argv(*extra, cell="eva"):
    return ["--model", "evit_tiny_p8", *CELL_FLAGS[cell], "--depth", "1",
            "--input-size", "112", "--num-classes", "10", "--batch-size", "2",
            "--device", "cpu", *extra]


def test_cli_eval_on_cpu(capsys):
    from efficient_attention_torch.cli import train_vit
    from efficient_attention_torch.ops.kernels import eva_single

    before = eva_single.LAUNCHES
    stats = train_vit.cli_main(_eval_argv("--eval"))
    assert eva_single.LAUNCHES == before  # the CPU takes the plain version
    assert stats["batches"] == 4
    assert all(np.isfinite(stats[k]) for k in ("acc1", "acc5", "loss"))
    assert 0.0 <= stats["acc1"] <= stats["acc5"] <= 1.0
    assert '"acc1"' in capsys.readouterr().out


@pytest.mark.parametrize("cell", ["lara", "performer", "local"])
def test_cli_eval_serving_cells_on_cpu(cell):
    """The three serving cells through ``cli.train_vit --eval --device cpu``:
    finite scores, and no kernel launch (the CPU takes the eager path for
    lara and performer, K7's plain version for local)."""
    from efficient_attention_torch.cli import train_vit
    from efficient_attention_torch.ops.kernels import (
        lara_fused,
        local_packed,
        performer_fused,
    )

    kernels = (lara_fused, performer_fused, local_packed)
    before = [k.LAUNCHES for k in kernels]
    args = train_vit.parse_args(_eval_argv("--eval", cell=cell))
    attn = train_vit.build_model(args).blocks[0].attn
    assert type(attn).__name__ == {"lara": "LinearRA",
                                   "performer": "KernelizedAttention",
                                   "local": "LocalAttention"}[cell]
    stats = train_vit.cli_main(_eval_argv("--eval", cell=cell))
    assert [k.LAUNCHES for k in kernels] == before
    assert stats["batches"] == 4
    assert all(np.isfinite(stats[k]) for k in ("acc1", "acc5", "loss"))


def test_cli_throughput_with_profile_on_cpu(capsys):
    from efficient_attention_torch.cli import train_vit

    stats = train_vit.cli_main(_eval_argv("--throughput", "--profile"))
    assert stats["images_per_sec"] > 0
    out = capsys.readouterr().out
    assert "throughput:" in out and "aten::" in out


def test_cli_without_eval_raises():
    """Without --eval the CLI trains; a training option whose module is
    not ported raises before any work, naming its ROADMAP.md item."""
    from efficient_attention_torch.cli import train_vit

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_vit.cli_main(_eval_argv("--mesh-fsdp", "2"))


def test_cli_nested_flags():
    from efficient_attention_torch.cli.train_vit import build_model, parse_args

    args = parse_args(_eval_argv("--eval", "--attn-adaptive-proj", "no-ln"))
    assert isinstance(args.attn_specific_args, argparse.Namespace)
    assert vars(args.attn_specific_args) == {
        "fp32": False, "use_rpe": True, "window_size": 7, "attn_2d": True,
        "overlap_window": False, "adaptive_proj": "no-ln",
        "num_landmarks": 49, "use_t5_rpe": False}
    model = build_model(args)
    attn = model.blocks[0].attn
    assert (attn.window_size, attn.num_landmarks, attn.adaptive_proj) == (7, 49, "no-ln")
    assert not model.training
    # one seed, one set of weights
    again = build_model(parse_args(_eval_argv("--eval", "--attn-adaptive-proj", "no-ln")))
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def test_config_surface():
    from efficient_attention_torch.config import (
        NestedNamespace,
        add_nested_argument,
        namespace_to_dict,
        remove_argument,
    )

    parser = argparse.ArgumentParser()
    add_nested_argument(parser, "--enc-attn-window-size", struct_name="attn_enc",
                        prefix="enc-attn", default=4, type=int)
    add_nested_argument(parser, "--drop-me", default=0, type=int)
    remove_argument(parser, "attn_args.drop_me")
    ns = parser.parse_args(["--enc-attn-window-size", "7"],
                           namespace=NestedNamespace())
    assert namespace_to_dict(ns) == {"attn_enc": {"window_size": 7}}


def test_registry():
    m = create_model("evit_tiny_p8", depth=1, num_classes=0)
    assert m.patch_embed.proj.kernel_size == (8, 8)
    assert m.blocks[0].attn.num_heads == 3
    with pytest.raises(KeyError, match="unknown model"):
        create_model("pvt_v2_b0")


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither jax/flax nor the JAX
    package, at any depth."""
    banned = ("jax", "flax", "efficient_attention_tpu")
    files = sorted((REPO / "efficient_attention_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"

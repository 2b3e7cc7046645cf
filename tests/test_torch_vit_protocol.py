"""The ImageNet recipe through the port's ``cli.train_vit`` on the CPU, from
an image folder to a top-1, against the JAX CLI.

``main.sh -d imagenet``'s flags (``--repeated-aug --model-ema --clip-grad
5.0 --data-set IMAGENET --data-path``) at the tier-1 geometry (112 px,
depth 2, 10 classes, one loader worker): the batches that reach the train
step equal the JAX CLI's, in order, over 4 epochs (JAX's step replaced by
one that only counts, since only its input is compared), the kept
checkpoints are orbax's, and ``--sched step`` builds JAX's schedule.  Two
epochs straight equal one epoch and a ``--resume``d one bit for bit
(parameters, EMA, optimizer, generator, ``log.txt`` but its wall times);
``--eval --resume`` matches JAX's ``evaluate`` on the same weights to 1e-5;
``--init-params`` from a reference checkpoint and from a step give equal
logits.  Each of the JAX CLI's faults that the port does not copy has its
test (ROADMAP.md Queue 3).  PVTv2 trains under ``--checkpoint-activations``
as without it, bit for bit.
"""
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32, randomize
from efficient_attention_torch.cli import train_vit
from test_torch_vit_data import write_image_folder

GEOMETRY = ["--model", "evit_tiny_p8", "--attn-name", "eva",
            "--attn-window-size", "7", "--attn-num-landmarks", "49",
            "--attn-attn-2d", "--attn-use-rpe", "--input-size", "112",
            "--depth", "2", "--num-classes", "10", "--num-workers", "1"]


def recipe_argv(data, out, *extra):
    """``main.sh -d imagenet -p data``'s flags, cut to the tier-1 size."""
    return [*GEOMETRY, "--batch-size", "128", "--epochs", "300", "--lr",
            "5e-4", "--warmup-epochs", "10", "--clip-grad", "5.0",
            "--repeated-aug", "--model-ema", "--output-dir", str(out),
            "--data-set", "IMAGENET", "--data-path", str(data),
            "--batch-size", "4", *extra]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """10 classes of 2 train images and 1 val image."""
    return write_image_folder(str(tmp_path_factory.mktemp("imagenet")),
                              classes=10)


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def _port_run(argv, batches=None):
    """``cli.train_vit --device cpu`` in-process; ``batches`` collects what
    reaches each train step."""
    from efficient_attention_torch.training import train_state

    real = train_state.make_vit_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def run(state, images, labels, generator):
            if batches is not None:
                batches.append((images.numpy().copy(), labels.numpy().copy()))
            return step(state, images, labels, generator)

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_state, "make_vit_train_step", make)
        return train_vit.cli_main(argv + ["--device", "cpu"])


SCHED = ["--sched", "step", "--decay-epochs", "1", "--decay-rate", "0.5",
         "--warmup-epochs", "1", "--epochs", "4", "--max-steps-per-epoch",
         "2"]


@pytest.fixture(scope="module")
def recipe_runs(data, tmp_path_factory):
    """The recipe for 4 epochs of 2 steps through both CLIs on one device:
    (port out dir, port batches, port schedule, JAX out dir, JAX batches,
    JAX schedule)."""
    import efficient_attention_tpu.parallel as jax_parallel
    import efficient_attention_tpu.training as jax_training
    from efficient_attention_tpu.cli import train_vit as jax_cli
    from efficient_attention_torch.training import optim

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        real_make = optim.make_optimizer
        mp.setattr(optim, "make_optimizer", lambda name, params, schedule, **kw:
                   out.setdefault("port_schedule", schedule) and
                   real_make(name, params, schedule, **kw))
        out["port_dir"] = tmp_path_factory.mktemp("port")
        out["port_batches"] = []
        _port_run(recipe_argv(data, out["port_dir"], *SCHED),
                  out["port_batches"])

    out["jax_dir"] = tmp_path_factory.mktemp("jax")
    out["jax_batches"] = []
    real_devices, real_put = jax.devices, jax_parallel.put_batch
    real_jax_make = jax_training.make_optimizer

    def put_batch(arr, sharding):
        out["jax_batches"].append(np.array(arr))
        return real_put(arr, sharding)

    def counting_step(*a, **kw):
        def step(state, images, labels, rng):
            zero = jnp.zeros((), jnp.float32)
            return (state.replace(step=state.step + 1),
                    jax_training.StepMetrics(zero, zero))
        return step

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: real_devices(*a, **k)[:1])
        mp.setattr(jax_parallel, "put_batch", put_batch)
        mp.setattr(jax_training, "make_vit_train_step", counting_step)
        mp.setattr(jax_training, "make_optimizer", lambda name, schedule, **kw:
                   out.setdefault("jax_schedule", schedule) and
                   real_jax_make(name, schedule, **kw))
        jax_cli.main(jax_cli.parse_args(recipe_argv(data, out["jax_dir"],
                                                    *SCHED)))
    return out


def test_cli_batches_match_jax(recipe_runs):
    """Every batch of 4 epochs (RASampler order, RandAugment, one worker
    seeded by the epoch) reaches the port's step as it reaches JAX's."""
    got, want = recipe_runs["port_batches"], recipe_runs["jax_batches"]
    assert len(got) == 8 and len(want) == 16  # JAX's: images, then labels
    for i, (images, labels) in enumerate(got):
        np.testing.assert_array_equal(images, want[2 * i])
        np.testing.assert_array_equal(labels, want[2 * i + 1])


def test_cli_keeps_the_steps_orbax_keeps(recipe_runs):
    from efficient_attention_torch.training.checkpoint import CheckpointManager

    jax_steps = sorted(int(d) for d in os.listdir(recipe_runs["jax_dir"] / "ckpt")
                       if d.isdigit())  # orbax's step directories
    port = CheckpointManager(os.path.join(recipe_runs["port_dir"], "ckpt"))
    assert port.all_steps() == jax_steps == [4, 6, 8]
    saved = port.load()
    assert saved["step"] == 8 and saved["ema_params"] is not None
    assert set(json.loads((recipe_runs["port_dir"] / "ckpt" / "8" /
                           "metrics.json").read_text())) == {"acc1"}


def test_cli_step_schedule_matches_jax(recipe_runs):
    ours, ref = recipe_runs["port_schedule"], recipe_runs["jax_schedule"]
    np.testing.assert_allclose([ours(i) for i in range(12)],
                               [float(ref(i)) for i in range(12)], rtol=2e-7)
    # warmup over the first epoch's 2 steps, then halved every epoch (of
    # 2 steps), from the scaled lr
    lr = 5e-4 * 4 / 512
    assert ours(1) < lr and ours(2) == lr / 2 and ours(4) == lr / 4


def test_cli_logs_every_val_image(recipe_runs):
    lines = (recipe_runs["port_dir"] / "log.txt").read_text().splitlines()
    records = [json.loads(line) for line in lines]
    assert [r["epoch"] for r in records] == [0, 1, 2, 3]
    assert all(r["val_images"] == 10 and r["val_batches"] == 3
               and np.isfinite(r["loss"]) for r in records)


def _state_files_equal(a, b):
    sa = torch.load(a, weights_only=True)
    sb = torch.load(b, weights_only=True)

    def same(x, y):
        if torch.is_tensor(x):
            return torch.equal(x, y)
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(map(same, x, y))
        return x == y

    return same(sa, sb)


def _records(out):
    return [{k: v for k, v in json.loads(line).items() if k != "epoch_time"}
            for line in (out / "log.txt").read_text().splitlines()]


def test_resume_is_bit_for_bit(data, tmp_path):
    """Two epochs straight against one epoch and a resumed second: the
    step file (parameters, EMA, AdamW's moments, the step's generator) and
    the epochs' records are equal."""
    flags = ["--max-steps-per-epoch", "2"]
    straight, broken = tmp_path / "straight", tmp_path / "broken"
    _port_run(recipe_argv(data, straight, "--epochs", "2", *flags))
    _port_run(recipe_argv(data, broken, "--epochs", "1", *flags))
    _port_run(recipe_argv(data, broken, "--epochs", "2", *flags,
                          "--resume", str(broken / "ckpt")))
    assert _state_files_equal(straight / "ckpt" / "4" / "state.pt",
                              broken / "ckpt" / "4" / "state.pt")
    assert _records(straight) == _records(broken)


def _jax_params(seed=31):
    from efficient_attention_tpu.models.efficient_vit import EfficientTransformer

    jm = EfficientTransformer(
        attn_name="eva", attn_args={"window_size": 7, "num_landmarks": 49,
                                    "attn_2d": True, "use_rpe": True,
                                    "impl": "xla"},
        img_size=112, patch_size=8, depth=2, num_classes=10)
    x = jnp.zeros((1, 112, 112, 3), jnp.float32)
    return jm, randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), x), seed)


def _save_step(out, params, step=5):
    """``params`` (flax) as step ``step`` of the port's checkpoints under
    ``out``: parameters and, as the EMA, the same."""
    from efficient_attention_torch.interop import load_jax_params
    from efficient_attention_torch.training.checkpoint import CheckpointManager

    args = train_vit.parse_args(GEOMETRY + ["--device", "cpu"])
    model = load_jax_params(train_vit.build_model(args), params)
    sd = model.state_dict()
    ema = {n: p.detach() for n, p in model.named_parameters()}
    CheckpointManager(os.path.join(out, "ckpt")).save(step, {
        "step": step, "params": sd, "opt_state": {}, "ema_params": ema,
        "rng": {}})
    return model


def test_eval_resume_matches_jax_evaluate(data, tmp_path):
    """``--eval --resume`` of a step against JAX's ``evaluate`` on the same
    weights, at a batch (5) that divides the 10 val images."""
    from efficient_attention_tpu.cli import train_vit as jax_cli
    from efficient_attention_tpu.training import make_vit_eval_step

    jm, params = _jax_params()
    _save_step(str(tmp_path), params)
    argv = [*GEOMETRY, "--data-set", "IMAGENET", "--data-path", data,
            "--batch-size", "5", "--output-dir", str(tmp_path)]
    ours = train_vit.cli_main(argv + ["--eval", "--device", "cpu", "--resume",
                                      str(tmp_path / "ckpt")])
    jargs = jax_cli.parse_args(argv)
    state = types.SimpleNamespace(params=jax.tree_util.tree_map(
        jnp.asarray, params), ema_params=None, apply_fn=jm.apply)
    ref = jax_cli.evaluate(jax_cli.build_dataset(jargs, train=False), state,
                           jax.jit(make_vit_eval_step(), static_argnums=(1,)),
                           jargs, 1)
    assert ours["images"] == 10 and ours["batches"] == 2
    for k in ("acc1", "acc5", "loss"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5, atol=1e-6)


def test_eval_scores_every_image(data, tmp_path):
    """At a batch (4) that leaves a partial last batch, the port scores all
    10 val images, each batch weighted by its images: its top-1 is the
    share of the 10 logits' argmaxes that hit; JAX's loader drops the last
    2 images."""
    from efficient_attention_tpu.data.imagenet import PrefetchLoader
    from efficient_attention_torch.data.imagenet import ImageFolderDataset

    _, params = _jax_params(seed=32)
    model = _save_step(str(tmp_path), params).eval()
    argv = [*GEOMETRY, "--data-set", "IMAGENET", "--data-path", data,
            "--batch-size", "4", "--output-dir", str(tmp_path), "--eval",
            "--device", "cpu", "--resume", str(tmp_path / "ckpt")]
    stats = train_vit.cli_main(argv)
    val = ImageFolderDataset(os.path.join(data, "val"), 112, train=False)
    x = np.stack([val.load(i, None)[0] for i in range(len(val))])
    labels = np.array([label for _, label in val.samples])
    with torch.no_grad():
        hits = (model(torch.from_numpy(x)).argmax(-1).numpy() == labels)
    assert stats["images"] == 10 and stats["batches"] == 3
    np.testing.assert_allclose(stats["acc1"], hits.mean(), rtol=1e-6)
    assert len(PrefetchLoader(val, 4, np.arange(10), drop_last=True)) * 4 == 8


class _ReferenceArgs:
    """Stands in for the reference's ``efficient_attention.NestedNamespace``
    when its checkpoint is pickled."""


def test_init_params_reference_and_step_files_give_equal_logits(tmp_path,
                                                               monkeypatch):
    """``--init-params`` of the reference's ``{'model': sd, ..., 'args':
    NestedNamespace}`` file and of a step of the port load strictly and give
    the logits of the model they were saved from."""
    from efficient_attention_torch.config import NestedNamespace

    _, params = _jax_params(seed=33)
    model = _save_step(str(tmp_path), params).eval()
    # the reference's file: its flags pickled as efficient_attention's class
    fake = types.ModuleType("efficient_attention")
    monkeypatch.setitem(sys.modules, "efficient_attention", fake)
    fake.NestedNamespace = type("NestedNamespace", (NestedNamespace,),
                                {"__module__": "efficient_attention"})
    ref_args = fake.NestedNamespace(model="evit_tiny_p8", lr=5e-4)
    torch.save({"model": model.state_dict(), "epoch": 3, "args": ref_args,
                "optimizer": {"state": {}}}, tmp_path / "checkpoint.pth")
    monkeypatch.delitem(sys.modules, "efficient_attention")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 112, 112, 3)).astype(np.float32))
    with torch.no_grad():
        want = model(x)
    args = train_vit.parse_args(GEOMETRY + ["--device", "cpu"])
    for path in (tmp_path / "checkpoint.pth", tmp_path / "ckpt" / "5",
                 tmp_path / "ckpt" / "5" / "state.pt"):
        m = train_vit.build_model(args)
        train_vit.load_init_params(m, str(path))
        with torch.no_grad():
            assert torch.equal(m.eval()(x), want), path
    torch.save({"state_dict": model.state_dict()}, tmp_path / "other.pth")
    with pytest.raises(ValueError, match="neither"):
        train_vit.load_init_params(train_vit.build_model(args),
                                   str(tmp_path / "other.pth"))


def test_cli_eval_takes_init_params(data, tmp_path):
    _, params = _jax_params(seed=34)
    model = _save_step(str(tmp_path), params)
    torch.save({"model": model.state_dict()}, tmp_path / "ref.pth")
    argv = [*GEOMETRY, "--data-set", "IMAGENET", "--data-path", data,
            "--batch-size", "5", "--output-dir", str(tmp_path), "--eval",
            "--device", "cpu"]
    by_file = train_vit.cli_main(argv + ["--init-params",
                                         str(tmp_path / "ref.pth")])
    by_step = train_vit.cli_main(argv + ["--resume", str(tmp_path / "ckpt")])
    assert by_file == by_step


@pytest.mark.parametrize("n,batch,jax_steps,loader", [
    (1281167, 1024, 3753, 1251),  # ImageNet's train split at B = 8 x 128
    (2000, 128, 46, 14),
    (512, 32, 48, 16),
])
def test_epoch_length_is_the_samplers(n, batch, jax_steps, loader):
    """Fault 1: under ``--repeated-aug`` the JAX CLI's schedule counts
    ``3 n // B`` steps an epoch, while DeiT's RASampler yields ``floor(n /
    256) * 256`` samples; the port's epoch is the sampler's."""
    from efficient_attention_torch.data.imagenet import ra_sampler_indices

    args = train_vit.parse_args(["--repeated-aug", "--batch-size", str(batch)])
    assert n * 3 // batch == jax_steps
    assert len(ra_sampler_indices(n, 0)) // batch == loader
    assert train_vit.epoch_steps(args, n) == loader
    # without --repeated-aug an epoch is a shuffle of the n samples
    args = train_vit.parse_args(["--batch-size", str(batch)])
    assert train_vit.epoch_steps(args, n) == n // batch


def test_resume_path_must_name_the_checkpoints(data, tmp_path):
    """Fault 3: the JAX CLI ignores ``--resume PATH`` and restores from
    ``--output-dir/ckpt``; the port raises where PATH names another
    directory, before it trains."""
    argv = recipe_argv(data, tmp_path, "--epochs", "1", "--device", "cpu",
                       "--resume", str(tmp_path / "elsewhere"))
    with pytest.raises(ValueError, match="output-dir/ckpt"):
        train_vit.cli_main(argv)
    assert not (tmp_path / "log.txt").exists()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        train_vit.cli_main(argv[:-1] + [str(tmp_path / "ckpt"), "--eval"])


@pytest.mark.parametrize("data_set", ["IMAGENET", "CIFAR10", "CIFAR100"])
def test_real_dataset_needs_data_path(data_set):
    """Fault 4: without ``--data-path`` the JAX CLI trains on synthetic
    images; the port raises."""
    from efficient_attention_tpu.cli import train_vit as jax_cli
    from efficient_attention_tpu.data.imagenet import SyntheticImageDataset

    argv = ["--data-set", data_set, "--batch-size", "4"]
    assert isinstance(jax_cli.build_dataset(jax_cli.parse_args(argv), True),
                      SyntheticImageDataset)
    with pytest.raises(ValueError, match="needs --data-path"):
        train_vit.build_dataset(train_vit.parse_args(argv), True)


def test_build_dataset_cifar_and_uint8_cache(data, tmp_path):
    """CIFAR from its archive; ``--uint8-cache`` builds ``{cache}.{split}``
    on first use and maps it after, with JAX's dataset's samples."""
    from efficient_attention_tpu.cli import train_vit as jax_cli
    from test_torch_vit_data import write_cifar

    root = write_cifar(str(tmp_path / "cifar"), 100)
    ds = train_vit.build_dataset(train_vit.parse_args(
        ["--data-set", "CIFAR100", "--data-path", root, "--input-size", "32"]),
        True)
    assert len(ds) == 3 and ds.augment is not None
    argv = ["--data-set", "IMAGENET", "--data-path", data, "--input-size",
            "48", "--uint8-cache", str(tmp_path / "cache")]
    for split in (True, False):
        ours = train_vit.build_dataset(train_vit.parse_args(argv), split)
        again = train_vit.build_dataset(train_vit.parse_args(argv), split)
        ref = jax_cli.build_dataset(jax_cli.parse_args(argv), split)
        name = "train" if split else "val"
        assert os.path.exists(tmp_path / f"cache.{name}.imgs.npy")
        np.testing.assert_array_equal(ours.images, ref.images)
        np.testing.assert_array_equal(again.labels, ref.labels)
        for i in range(len(ref)):
            a = ours.load(i, np.random.default_rng(i))
            b = ref.load(i, np.random.default_rng(i))
            np.testing.assert_array_equal(a[0], b[0])


def test_pvt_trains_the_same_with_checkpoint_activations(tmp_path):
    """PVTv2 (pvt_nano at 64 px) under the recipe's ``--repeated-aug
    --model-ema`` on synthetic images: two steps with rematerialised blocks
    give the records and the step file of two without, bit for bit."""
    base = ["--model", "pvt_nano", "--attn-name", "eva",
            "--attn-window-size", "2", "--attn-num-landmarks", "4",
            "--attn-attn-2d", "--attn-use-rpe", "--input-size", "64",
            "--num-classes", "10", "--batch-size", "4", "--epochs", "1",
            "--max-steps-per-epoch", "2", "--repeated-aug", "--model-ema",
            "--clip-grad", "5.0", "--device", "cpu", "--num-workers", "1"]
    for name, extra in (("plain", []), ("remat", ["--checkpoint-activations"])):
        _port_run(base + ["--output-dir", str(tmp_path / name), *extra])
    assert _records(tmp_path / "plain") == _records(tmp_path / "remat")
    assert _state_files_equal(tmp_path / "plain" / "ckpt" / "2" / "state.pt",
                              tmp_path / "remat" / "ckpt" / "2" / "state.pt")

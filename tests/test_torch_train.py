"""The training path of the PyTorch port against the JAX package, on the CPU.

Label smoothing and the soft-target loss must equal JAX's to float32
rounding; mixup and random erasing cannot share JAX's random stream, so
they are held to their structure (the mixing formula, the target sums, the
cutmix box area against lambda, the erased area).  The schedule and the
weight-decay grouping must equal JAX's; ``ClippedAdamW`` must follow the
optax chain to 1e-6.  The port replays the ViT trajectory golden as
``test_trajectory_parity.py::TestViTTrajectory`` does (60 AdamW steps at
zero RF noise: losses within 1e-4 for the first 10 and 2e-2 over all 60,
final parameters within 2e-3 abs / 2e-2 rel), and the CLI trains on the CPU.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import exact_float32
from efficient_attention_torch.data import erasing, mixup
from efficient_attention_torch.training import optim

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def test_one_hot_smooth_and_soft_target_loss_match_jax():
    from efficient_attention_tpu.data import mixup as jax_mixup

    rng = np.random.default_rng(0)
    labels = rng.integers(0, 10, 16)
    logits = rng.standard_normal((16, 10)).astype(np.float32)
    targets = mixup.one_hot_smooth(torch.from_numpy(labels), 10, 0.1)
    want = np.asarray(jax_mixup.one_hot_smooth(jnp.asarray(labels), 10, 0.1))
    np.testing.assert_array_equal(targets.numpy(), want)
    loss = mixup.soft_target_cross_entropy(torch.from_numpy(logits), targets)
    ref = jax_mixup.soft_target_cross_entropy(jnp.asarray(logits),
                                              jnp.asarray(want))
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-6)


def test_beta_and_gamma_samplers():
    """Moments of the generator-driven samplers: Beta(0.8, 0.8) has mean
    0.5 and variance 0.0962; Gamma(a) has mean a (5 standard errors)."""
    gen = torch.Generator().manual_seed(0)
    n = 40000
    b = mixup.sample_beta(0.8, (n,), gen, "cpu")
    assert ((b >= 0) & (b <= 1)).all()
    assert abs(b.mean().item() - 0.5) < 5 * (0.0962 / n) ** 0.5
    assert abs(b.var().item() - 0.0962) < 0.004
    for alpha in (0.3, 1.0, 2.5):
        g = mixup.sample_gamma(alpha, (n,), gen, "cpu")
        assert (g > 0).all()
        assert abs(g.mean().item() - alpha) < 5 * (alpha / n) ** 0.5


def _plane_batch(B, h, w):
    """Image i is the constant plane i + 1, label i (all distinct)."""
    images = (torch.arange(B, dtype=torch.float32) + 1).reshape(B, 1, 1, 1)
    return images.expand(B, h, w, 3).contiguous(), torch.arange(B)


@pytest.mark.parametrize("minmax", [None, (0.2, 0.8)])
@pytest.mark.parametrize("mode", ["batch", "pair", "elem"])
def test_mixup_structure(mode, minmax):
    B, h, w, K = 6, 16, 12, 10
    images, labels = _plane_batch(B, h, w)
    cfg = mixup.MixupConfig(num_classes=K, mode=mode, cutmix_minmax=minmax)
    off = 0.1 / K
    on = 1.0 - 0.1 + off
    for seed in range(12):
        out, targets = mixup.apply_mixup(
            images, labels, cfg, torch.Generator().manual_seed(seed))
        np.testing.assert_allclose(targets.sum(-1).numpy(), 1.0, rtol=1e-6)
        lams = []
        for i in range(B):
            f = B - 1 - i
            lam = (targets[i, i].item() - off) / (on - off)
            if f == i:  # the middle of an odd batch mixes with itself
                continue
            np.testing.assert_allclose(targets[i, f].item(),
                                       (1 - lam) * (on - off) + off, atol=1e-6)
            vals = out[i].flatten()
            own = (vals == i + 1).float().mean().item()
            if own not in (0.0, 1.0) or torch.unique(vals).numel() == 2:
                # cutmix: a box of the partner's image, area 1 - lambda
                assert set(torch.unique(vals).tolist()) <= {i + 1.0, f + 1.0}
                np.testing.assert_allclose(own, lam, atol=1e-6)
            else:
                # mixup: lam * own + (1 - lam) * partner everywhere
                np.testing.assert_allclose(
                    vals.numpy(), lam * (i + 1) + (1 - lam) * (f + 1),
                    rtol=1e-5)
            lams.append(lam)
        if mode == "batch":
            np.testing.assert_allclose(lams, lams[0], atol=1e-6)
        if mode == "pair":
            for i in range(B // 2):
                np.testing.assert_allclose(
                    (targets[i, i] - targets[B - 1 - i, B - 1 - i]).item(), 0,
                    atol=1e-6)


def test_mixup_prob_zero_is_label_smoothing_only():
    images, labels = _plane_batch(4, 8, 8)
    cfg = mixup.MixupConfig(num_classes=10, prob=0.0)
    out, targets = mixup.apply_mixup(images, labels, cfg,
                                     torch.Generator().manual_seed(0))
    assert torch.equal(out, images)
    assert torch.equal(targets, mixup.one_hot_smooth(labels, 10, 0.1))


@pytest.mark.parametrize("mode", ["pixel", "const"])
def test_random_erasing_structure(mode):
    B, h, w = 32, 64, 48
    images = torch.full((B, h, w, 3), 7.0)
    cfg = erasing.ErasingConfig(prob=1.0, mode=mode)
    out = erasing.apply_random_erasing(images, cfg,
                                       torch.Generator().manual_seed(0))
    for i in range(B):
        erased = (out[i] != 7.0).any(-1)
        rows, cols = erased.any(1).nonzero(), erased.any(0).nonzero()
        eh = rows.max().item() - rows.min().item() + 1
        ew = cols.max().item() - cols.min().item() + 1
        assert erased.sum().item() == eh * ew  # one rectangle
        # area in [0.02, 1/3] of the image up to rounding each side to an
        # integer (and clamping it to the image)
        area = eh * ew / (h * w)
        assert 0.02 * 0.75 <= area <= (1 / 3) * 1.25
        if mode == "const":
            assert (out[i][erased] == 0).all()
    keep = erasing.apply_random_erasing(images, cfg._replace(prob=0.0))
    assert torch.equal(keep, images)


def test_cosine_schedule_matches_jax():
    from efficient_attention_tpu.training.optim import cosine_schedule

    for kw in (dict(base_lr=5e-4, warmup_steps=10, total_steps=60,
                    steps_per_epoch=5),
               dict(base_lr=1e-3, warmup_steps=0, total_steps=100,
                    min_lr=1e-6),
               dict(base_lr=2.5e-4, warmup_steps=40, total_steps=80,
                    warmup_init_lr=1e-7, steps_per_epoch=8)):
        ours = optim.cosine_schedule(**kw)
        ref = cosine_schedule(**kw)
        # JAX evaluates the schedule in float32, the port in float64
        np.testing.assert_allclose([ours(i) for i in range(120)],
                                   [float(ref(i)) for i in range(120)],
                                   rtol=3e-5, atol=1e-12)


def test_weight_decay_mask_matches_jax():
    import jax

    from efficient_attention_tpu.models.efficient_vit import (
        EfficientTransformer as JaxViT,
    )
    from efficient_attention_tpu.training.optim import weight_decay_mask
    from efficient_attention_torch.interop import state_dict_from_jax
    from efficient_attention_torch.models import EfficientTransformer

    cfg = dict(attn_name="eva", img_size=56, patch_size=8, embed_dim=48,
               depth=1, num_heads=4, num_classes=10,
               attn_args={"window_size": 7, "num_landmarks": 49,
                          "attn_2d": True, "use_rpe": True})
    params = jax.eval_shape(JaxViT(**cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 56, 56, 3)))
    jmask = weight_decay_mask(params["params"])
    want = {k: bool(v.item()) for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jmask)).items()}
    got = optim.weight_decay_mask(EfficientTransformer(**cfg).named_parameters())
    assert got == want
    assert got["blocks.0.attn.local_relative_position_bias_table"]
    assert not got["pos_embed"] and not got["blocks.0.norm1.weight"]


@pytest.mark.parametrize("clip", [None, 0.5, 100.0])
def test_clipped_adamw_matches_optax(clip):
    from efficient_attention_tpu.training.optim import make_optimizer

    rng = np.random.default_rng(1)
    init = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "bias": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in init.items()} for _ in range(5)]
    schedule = optim.cosine_schedule(1e-2, 2, 5, steps_per_epoch=1)
    tx = make_optimizer("adamw", lambda s: jnp.asarray(
        [schedule(i) for i in range(5)])[s], weight_decay=0.05,
        clip_grad=clip, params_for_mask=init)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, v in init.items()]
    opt = optim.make_optimizer("adamw", named, schedule, weight_decay=0.05,
                               clip_grad=clip)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, params)
        params = optax.apply_updates(params, upd)
        for k, p in named:
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k, p in named:
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optim.make_optimizer("sgd", named, schedule)


def test_shard_indices_and_metrics_match_jax():
    from efficient_attention_tpu.data.imagenet import shard_indices
    from efficient_attention_tpu.training.metrics import SmoothedValue
    from efficient_attention_torch.data import imagenet
    from efficient_attention_torch.training import metrics

    for n, epoch, reps, rank, shuffle in ((100, 0, 1, 0, True),
                                          (101, 3, 4, 2, True),
                                          (50, 1, 2, 1, False)):
        np.testing.assert_array_equal(
            imagenet.shard_indices(n, epoch, 7, reps, rank, shuffle),
            shard_indices(n, epoch, 7, reps, rank, shuffle))
    a, b = metrics.SmoothedValue(window_size=3), SmoothedValue(window_size=3)
    for v in (1.0, 4.0, 2.0, 8.0):
        a.update(v)
        b.update(v)
    assert str(a) == str(b) and a.global_avg == b.global_avg == 3.75
    lines = []
    logger = metrics.MetricLogger(print_fn=lines.append)
    for _ in logger.log_every(range(3), 2, "h"):
        logger.update(loss=1.5)
    assert logger.global_avg_dict() == {"loss": 1.5} and len(lines) == 3


def _zero_noise(monkeypatch):
    from efficient_attention_torch.attention.eva import EVA

    monkeypatch.setattr(EVA, "_sample_weights", lambda self, mu: mu)


def test_vit_trajectory_golden(monkeypatch):
    """60 AdamW steps of the recorded reference run, replayed through the
    port's train step in train mode at zero RF noise (the golden's
    deterministic forward) on the packed path."""
    from efficient_attention_torch.models import EfficientTransformer
    from efficient_attention_torch.training.train_state import (
        TrainState,
        make_vit_train_step,
    )

    _zero_noise(monkeypatch)
    data = np.load(os.path.join(GOLDENS, "trajectory_vit_adamw.npz"))

    def state_dict(prefix):
        return {k[len(prefix):]: torch.from_numpy(data[k]) for k in data.files
                if k.startswith(prefix)}

    model = EfficientTransformer(
        attn_name="eva", attn_args={"window_size": 7, "num_landmarks": 49,
                                    "attn_2d": True, "use_rpe": True,
                                    "adaptive_proj": "default"},
        img_size=112, patch_size=8, embed_dim=48, depth=2, num_heads=4,
        num_classes=10)
    model.load_state_dict(state_dict("sd0__"), strict=True)
    schedule = optim.cosine_schedule(5e-4, warmup_steps=2 * 5,
                                     total_steps=12 * 5, warmup_init_lr=1e-6,
                                     min_lr=1e-5, steps_per_epoch=5)
    np.testing.assert_allclose([schedule(i) for i in range(60)], data["lrs"],
                               rtol=1e-5, atol=1e-9)
    opt = optim.make_optimizer("adamw", model.named_parameters(), schedule,
                               weight_decay=0.05, clip_grad=5.0)
    state = TrainState(model, opt)
    step = make_vit_train_step(None, num_classes=10, label_smoothing=0.1)
    losses = [float(step(state, torch.from_numpy(data["images"][i]),
                         torch.from_numpy(data["labels"][i]), None).loss)
              for i in range(data["images"].shape[0])]
    ref = data["losses"]
    np.testing.assert_allclose(losses[:10], ref[:10], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(losses, ref, rtol=2e-2, atol=2e-2)
    final = state_dict("sdF__")
    for name, p in model.named_parameters():
        want = final[name].numpy()
        err = np.max(np.abs(p.detach().numpy() - want)
                     / (np.abs(want) * 2e-2 + 2e-3))
        assert err < 1.0, (name, err)


def test_train_step_accumulation_and_skip(monkeypatch):
    """Two microbatches give the one-batch update; a non-finite loss skips
    the update; the EMA is a lerp; the bf16 cast returns f32 gradients."""
    from efficient_attention_torch.models import EfficientTransformer
    from efficient_attention_torch.training.train_state import (
        TrainState,
        cast_modules,
        make_vit_train_step,
    )

    _zero_noise(monkeypatch)
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.standard_normal((4, 56, 56, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, 4))
    cfg = dict(attn_name="eva", img_size=56, patch_size=8, embed_dim=48,
               depth=1, num_heads=4, num_classes=10,
               attn_args={"window_size": 7, "num_landmarks": 49,
                          "attn_2d": True, "use_rpe": True})
    after = []
    for accum in (1, 2):
        torch.manual_seed(0)
        model = EfficientTransformer(**cfg)
        opt = optim.make_optimizer("adamw", model.named_parameters(),
                                   lambda s: 1e-3)
        state = TrainState(model, opt, ema_decay=0.9)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = make_vit_train_step(None, 10, accum_steps=accum)
        m = step(state, images, labels, None)
        after.append((float(m.loss), float(m.grad_norm),
                      [p.detach().clone() for p in model.parameters()],
                      state))
    (l1, n1, p1, s1), (l2, n2, p2, _) = after
    np.testing.assert_allclose([l1, n1], [l2, n2], rtol=1e-5)
    # Adam's first step moves each weight by about lr * sign(g), so
    # summation-order differences in a tiny g can move it by a few 1e-6
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    assert s1.step == 1
    for n, p in s1.model.named_parameters():  # e = e0 * d + p * (1 - d)
        torch.testing.assert_close(s1.ema_params[n],
                                   0.9 * start[n] + 0.1 * p.detach())
    bad = make_vit_train_step(None, 10, skip_nonfinite=True)
    before = [p.detach().clone() for p in s1.model.parameters()]
    m = bad(s1, images * float("nan"), labels, None)
    assert bool(m.skipped) and s1.step == 1
    assert all(torch.equal(a, b) for a, b in zip(before, s1.model.parameters()))
    params = dict(s1.model.named_parameters())
    with cast_modules(s1.model, torch.bfloat16):
        assert all(t.dtype == torch.bfloat16 for t in s1.model.parameters())
        s1.model.head.bias.float().sum().backward()
    assert all(p is params[n] for n, p in s1.model.named_parameters())
    assert params["head.bias"].grad.dtype == torch.float32


def test_drop_path_schedule_and_generators():
    from efficient_attention_torch.models import EfficientTransformer
    from efficient_attention_torch.models.layers import DropPath, set_generator

    m = EfficientTransformer(depth=4, embed_dim=48, num_heads=4, img_size=32,
                             patch_size=8, num_classes=10, drop_path_rate=0.3)
    np.testing.assert_allclose([b.drop_path.rate for b in m.blocks],
                               np.linspace(0, 0.3, 4))
    gen = torch.Generator().manual_seed(5)
    set_generator(m, gen)
    assert all(b.drop_path.generator is gen for b in m.blocks)
    dp = DropPath(0.5).train()
    x = torch.ones(64, 3)
    outs = [DropPath(0.5, torch.Generator().manual_seed(1)).train()(x)
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert set(outs[0][:, 0].tolist()) <= {0.0, 2.0}
    assert torch.equal(dp.eval()(x), x)
    # --checkpoint-activations: the model holds the generator too, for the
    # blocks' recompute (tests/test_torch_vit_data.py checks the gradients)
    remat = EfficientTransformer(depth=2, embed_dim=48, num_heads=4,
                                 img_size=32, patch_size=8,
                                 checkpoint_activations=True)
    set_generator(remat, gen)
    assert remat.checkpoint_activations and remat.generator is gen


def _train_argv(tmp_path, *extra):
    return ["--model", "evit_tiny_p8", "--attn-name", "eva",
            "--attn-window-size", "7", "--attn-num-landmarks", "49",
            "--attn-attn-2d", "--attn-use-rpe", "--device", "cpu",
            "--input-size", "112", "--depth", "2", "--batch-size", "4",
            "--num-classes", "10", "--epochs", "1",
            "--max-steps-per-epoch", "2", "--output-dir", str(tmp_path),
            *extra]


def test_cli_trains_on_cpu(tmp_path, capsys):
    from efficient_attention_torch.cli import train_vit
    from efficient_attention_torch.ops.kernels import eva_packed, eva_single

    before = (eva_packed.LAUNCHES_FWD, eva_packed.LAUNCHES_BWD,
              eva_single.LAUNCHES)
    record = train_vit.cli_main(_train_argv(tmp_path, "--profile"))
    # the CPU takes the kernels' plain versions
    assert (eva_packed.LAUNCHES_FWD, eva_packed.LAUNCHES_BWD,
            eva_single.LAUNCHES) == before
    for k in ("loss", "grad_norm", "val_loss", "val_acc1"):
        assert np.isfinite(record[k]), k
    assert record["val_batches"] == 4
    lines = (tmp_path / "log.txt").read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["epoch"] == 0
    assert "aten::" in capsys.readouterr().out  # the profile of steps 1-3


@pytest.mark.parametrize("flag", [
    ["--mesh-fsdp", "2"], ["--distributed"],
    ["--tensorboard-logdir", "x"], ["--wandb-project", "x"],
    ["--azureml-logging"], ["--opt", "sgd"],
])
def test_cli_unported_flags_raise(tmp_path, flag):
    from efficient_attention_torch.cli import train_vit

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_vit.cli_main(_train_argv(tmp_path, *flag))


@pytest.mark.parametrize("alphas", [(0.0, 1.0), (0.8, 0.0)])
def test_mixup_with_one_alpha_zero_draws_only_the_other(alphas):
    """timm's rule: with ``--mixup 0`` every mixed sample is cutmix, with
    ``--cutmix 0`` every one is mixup (the JAX version draws Beta(0, 0)
    there, which gives NaN images and targets; ROADMAP.md Queue 3)."""
    B, h, w = 4, 8, 8
    images, labels = _plane_batch(B, h, w)
    cfg = mixup.MixupConfig(mixup_alpha=alphas[0], cutmix_alpha=alphas[1],
                            num_classes=10, mode="elem")
    for seed in range(8):
        out, targets = mixup.apply_mixup(images, labels, cfg,
                                         torch.Generator().manual_seed(seed))
        assert torch.isfinite(out).all() and torch.isfinite(targets).all()
        for i in range(B):
            vals = set(torch.unique(out[i]).tolist())
            if alphas[0] == 0.0:  # cutmix: only the two planes' values
                assert vals <= {i + 1.0, B - i + 0.0}
            else:  # mixup: one blended value everywhere
                assert len(vals) == 1

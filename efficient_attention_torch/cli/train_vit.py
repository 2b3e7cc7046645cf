"""ViT CLI of the port: training, ``--eval`` and ``--throughput``.

Counterpart of ``efficient_attention_tpu/cli/train_vit.py``, with the same
flags and the same two-pass parsing, which injects the chosen attention's
flags into a nested namespace (``vit/main.py:186-193``).  Without ``--eval``
or ``--throughput`` it trains with the DeiT recipe's defaults (AdamW,
per-epoch cosine or ``--sched step``, mixup/cutmix, label smoothing, random
erasing, stochastic depth, RandAugment) on ``--data-set``: IMAGENET image
folders (``--data-path DIR`` holding ``train/`` and ``val/``), optionally
through a uint8 cache, CIFAR10/100, or synthetic images.  Batches come from
``data.imagenet.PrefetchLoader`` (``--num-workers`` threads or, with
``--decode-backend process``, spawned processes), in the order of DeiT's
RASampler under ``--repeated-aug``.  After each epoch it scores every
validation image (with the EMA under ``--model-ema``), appends the epoch's
record to ``log.txt`` under ``--output-dir`` and saves a checkpoint to
``--output-dir/ckpt`` (the newest 3 kept); ``--resume`` continues from the
newest there, bit for bit on the CPU.  ``--eval`` scores the validation set
and ``--throughput`` times forwards, each from the checkpoint under
``--resume``; ``--init-params`` loads a reference checkpoint's weights.
The model runs on ``--device`` (default ``cuda``), on one device.  Flags
whose module is not ported yet raise ``NotImplementedError`` naming their
ROADMAP.md item.

Example (the ImageNet recipe, ``main.sh -d imagenet``, with DeiT-tiny-p8
and 2-D EVA, the main path):

  python -m efficient_attention_torch.cli.train_vit \\
      --model evit_tiny_p8 --attn-name eva --attn-window-size 7 \\
      --attn-num-landmarks 49 --attn-attn-2d --attn-use-rpe \\
      --batch-size 128 --epochs 300 --lr 5e-4 --warmup-epochs 10 \\
      --clip-grad 5.0 --repeated-aug --model-ema --bf16 \\
      --data-set IMAGENET --data-path /data/imagenet --output-dir run
  # later: the same flags with --resume run/ckpt, or --eval --resume run/ckpt

The PVTv2 archs (``--model pvt_*``, e.g. ``pvt_medium2``, PVTv2-B3) take the
same flags, ``--use-conv-patchify`` and ``--checkpoint-activations``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "EfficientAttention-Torch ViT training", add_help=False)
    # the JAX CLI's flags (vit/main.py:32-195)
    parser.add_argument("--batch-size", default=64, type=int)
    parser.add_argument("--epochs", default=300, type=int)
    parser.add_argument("--model", default="evit_tiny_p16", type=str)
    parser.add_argument("--attn-name", default="softmax", type=str)
    parser.add_argument("--input-size", default=224, type=int)
    parser.add_argument("--drop", default=0.0, type=float)
    parser.add_argument("--drop-path", default=0.1, type=float)
    parser.add_argument("--attn-drop-rate", default=0.0, type=float)
    parser.add_argument("--model-ema", action="store_true", default=False)
    parser.add_argument("--model-ema-decay", default=0.99996, type=float)
    parser.add_argument("--sched", default="cosine", type=str,
                        choices=["cosine", "step"])
    parser.add_argument("--decay-epochs", default=30, type=float,
                        help="epochs between step-scheduler decays")
    parser.add_argument("--decay-rate", default=0.1, type=float)
    parser.add_argument("--cooldown-epochs", default=0, type=int,
                        help="extra epochs held at min-lr after the decay "
                             "ends (timm --cooldown-epochs)")
    parser.add_argument("--opt", default="adamw", type=str)
    parser.add_argument("--opt-eps", default=1e-8, type=float)
    parser.add_argument("--opt-betas", default=None, type=str,
                        help="optimizer betas, e.g. '0.9,0.999'")
    parser.add_argument("--momentum", default=0.9, type=float,
                        help="sgd/nag momentum")
    parser.add_argument("--no-pos-emb", action="store_true", default=False)
    parser.add_argument("--weight-decay", default=0.05, type=float)
    parser.add_argument("--lr", default=5e-4, type=float)
    parser.add_argument("--lr-ratio", default=1.0, type=float)
    parser.add_argument("--warmup-epochs", default=10, type=int)
    parser.add_argument("--warmup-lr", default=1e-6, type=float)
    parser.add_argument("--min-lr", default=1e-5, type=float)
    parser.add_argument("--clip-grad", default=None, type=float)
    parser.add_argument("--mixup", default=0.8, type=float)
    parser.add_argument("--cutmix", default=1.0, type=float)
    parser.add_argument("--mixup-prob", default=1.0, type=float)
    parser.add_argument("--mixup-switch-prob", default=0.5, type=float)
    parser.add_argument("--mixup-mode", default="batch", type=str,
                        choices=["batch", "pair", "elem"])
    parser.add_argument("--cutmix-minmax", default=None, type=str,
                        help="cutmix box side range as 'lo,hi' fractions")
    parser.add_argument("--smoothing", default=0.1, type=float)
    # augmentation of real images (vit/main.py:105-124); the synthetic
    # dataset takes none, as in the JAX CLI
    parser.add_argument("--aa", default="rand-m9-mstd0.5-inc1", type=str)
    parser.add_argument("--color-jitter", default=0.4, type=float)
    parser.add_argument("--train-interpolation", default="bicubic", type=str)
    parser.add_argument("--reprob", default=0.25, type=float)
    parser.add_argument("--remode", default="pixel", type=str)
    parser.add_argument("--recount", default=1, type=int)
    parser.add_argument("--repeated-aug", action="store_true", default=False)
    parser.add_argument("--data-path", default=None, type=str)
    parser.add_argument("--data-set", default="SYNTHETIC", type=str,
                        choices=["IMAGENET", "CIFAR10", "CIFAR100",
                                 "SYNTHETIC"])
    parser.add_argument("--num-classes", default=1000, type=int)
    parser.add_argument("--output-dir", default="./checkpoints/vit")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--resume", default="", type=str,
                        help="restore the newest checkpoint under "
                             "--output-dir/ckpt (the path must name it)")
    parser.add_argument("--init-params", default="", type=str,
                        help="warm-start the parameters from a reference "
                             "checkpoint ({'model': state_dict}) or a step "
                             "of this CLI's checkpoints")
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--checkpoint-activations", action="store_true")
    parser.add_argument("--throughput", action="store_true")
    parser.add_argument("--profile", nargs="?", const="", default=None,
                        metavar="LOGDIR",
                        help="trace 3 steps (train steps 1-3, or 3 more "
                             "forwards with --throughput) with "
                             "torch.profiler, print the ops by device time, "
                             "and write a Chrome trace to LOGDIR if given")
    parser.add_argument("--num-workers", default=8, type=int,
                        help="loader workers (threads or processes)")
    parser.add_argument("--uint8-cache", default="", type=str)
    parser.add_argument("--decode-backend", default="thread",
                        choices=["thread", "process"])
    parser.add_argument("--accum-steps", default=1, type=int)
    parser.add_argument("--max-steps-per-epoch", default=None, type=int,
                        help="truncate epochs (smoke tests)")
    parser.add_argument("--mesh-fsdp", default=1, type=int)
    parser.add_argument("--mesh-model", default=1, type=int)
    parser.add_argument("--bf16", action="store_true", default=False,
                        help="mixed precision: float32 master parameters, "
                             "bfloat16 compute (--eval/--throughput: the "
                             "model in bfloat16)")
    parser.add_argument("--tensorboard-logdir", default=None, type=str)
    parser.add_argument("--wandb-project", default=None, type=str)
    parser.add_argument("--azureml-logging", action="store_true")
    dist = parser.add_argument_group("distributed")
    dist.add_argument("--distributed", action="store_true", default=False)
    dist.add_argument("--coordinator-address", default=None, type=str)
    dist.add_argument("--num-processes", default=None, type=int)
    dist.add_argument("--process-id", default=None, type=int)
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to run on ('cuda' or 'cpu')")
    return parser


def parse_args(argv=None):
    """Two-pass parse: learn model/attn first, then register their flags
    (``vit/main.py:186-193``)."""
    from efficient_attention_torch import AttentionFactory, NestedNamespace
    from efficient_attention_torch.models.efficient_vit import EfficientTransformer
    from efficient_attention_torch.models.pvt import PyramidVisionTransformerV2

    parser = build_parser()
    known, _ = parser.parse_known_args(argv)
    if known.model.startswith("pvt"):
        parser = PyramidVisionTransformerV2.add_model_specific_args(parser)
    else:
        parser = EfficientTransformer.add_model_specific_args(parser)
    parser = AttentionFactory.add_attn_specific_args(
        parser, known.attn_name, struct_name="attn_specific_args",
        prefix="attn")
    parser.add_argument("--help", action="help")
    return parser.parse_args(argv, namespace=NestedNamespace())


def check_ported(args) -> None:
    """Raise ``NotImplementedError`` for every flag set to something whose
    module is not ported yet, naming its ROADMAP.md item."""
    queued = [
        (args.mesh_fsdp != 1 or args.mesh_model != 1,
         "--mesh-fsdp/--mesh-model", "Queue 1, item 7"),
        (args.distributed or args.coordinator_address is not None
         or args.num_processes is not None or args.process_id is not None,
         "the distributed flags", "Queue 1, item 7"),
        (args.tensorboard_logdir is not None, "--tensorboard-logdir",
         "Queue 1, item 8"),
        (args.wandb_project is not None, "--wandb-project", "Queue 1, item 8"),
        (args.azureml_logging, "--azureml-logging", "Queue 1, item 8"),
    ]
    for unported, flag, item in queued:
        if unported:
            raise NotImplementedError(
                f"{flag} is not ported yet; see ROADMAP.md {item}")


def build_dataset(args, train: bool):
    """The train or val split of ``--data-set`` (JAX
    ``cli/train_vit.py:172-210``): SYNTHETIC (16 batches to train on, 4 to
    score), CIFAR10/100 from their archives under ``--data-path``, or
    IMAGENET from ``{data_path}/{train,val}`` image folders, through the
    uint8 cache ``{uint8_cache}.{split}`` where ``--uint8-cache`` is set
    (built on first use).  Training takes ``--aa`` or, without it,
    ``--color-jitter``.  A real dataset without ``--data-path`` raises
    (the JAX CLI trains on synthetic images then)."""
    from efficient_attention_torch.data.imagenet import (
        CachedUint8Dataset,
        ImageFolderDataset,
        SyntheticImageDataset,
    )

    if args.data_set == "SYNTHETIC":
        return SyntheticImageDataset(
            num_samples=args.batch_size * (16 if train else 4),
            img_size=args.input_size, num_classes=args.num_classes,
            train=train)
    if not args.data_path:
        raise ValueError(f"--data-set {args.data_set} needs --data-path")
    augment = None
    if train:
        from efficient_attention_torch.data.randaugment import (
            build_train_augment,
        )

        aa = None if (not args.aa or args.aa.lower() == "none") else args.aa
        augment = build_train_augment(aa, args.color_jitter)
    if args.data_set in ("CIFAR10", "CIFAR100"):
        from efficient_attention_torch.data.cifar import CIFARDataset

        return CIFARDataset(
            args.data_path, num_classes=10 if args.data_set == "CIFAR10"
            else 100, img_size=args.input_size, train=train, augment=augment)
    split = "train" if train else "val"
    if args.uint8_cache:
        path = f"{args.uint8_cache}.{split}"
        if not os.path.exists(path + ".imgs.npy"):
            print(f"| building uint8 cache {path} (one-time decode)",
                  flush=True)
            CachedUint8Dataset.build(os.path.join(args.data_path, split),
                                     path, log_every=10000,
                                     num_workers=args.num_workers)
        return CachedUint8Dataset(path, img_size=args.input_size,
                                  train=train, augment=augment,
                                  interpolation=args.train_interpolation)
    return ImageFolderDataset(os.path.join(args.data_path, split),
                              img_size=args.input_size, train=train,
                              augment=augment,
                              interpolation=args.train_interpolation)


def epoch_indices(args, n: int, epoch: int) -> np.ndarray:
    """One epoch's sample order: DeiT's RASampler under
    ``--repeated-aug``, else a shuffle, both seeded by ``--seed`` +
    ``epoch``."""
    from efficient_attention_torch.data.imagenet import (
        ra_sampler_indices,
        shard_indices,
    )

    if args.repeated_aug:
        return ra_sampler_indices(n, epoch, args.seed)
    return shard_indices(n, epoch, args.seed)


def epoch_steps(args, n: int) -> int:
    """The train steps of an epoch over ``n`` samples: the sampler's whole
    batches (under ``--repeated-aug`` about ``n``, where the JAX CLI counts
    ``3 n`` for its schedule), at most ``--max-steps-per-epoch``."""
    steps = max(1, len(epoch_indices(args, n, 0)) // args.batch_size)
    if args.max_steps_per_epoch:
        steps = min(steps, args.max_steps_per_epoch)
    return steps


def resume_directory(args) -> str:
    """``--output-dir/ckpt``, where checkpoints go and ``--resume``
    restores from; a ``--resume`` path naming another directory raises (the
    JAX CLI ignores the path)."""
    directory = os.path.join(args.output_dir, "ckpt")
    if args.resume and (os.path.realpath(args.resume)
                        != os.path.realpath(directory)):
        raise ValueError(f"--resume {args.resume}: checkpoints are restored "
                         f"from --output-dir/ckpt ({directory})")
    return directory


def load_init_params(model: torch.nn.Module, path: str) -> None:
    """``--init-params``: load the parameters of ``path`` into ``model``,
    strictly.  ``path`` is the reference's own checkpoint (``vit/main.py``
    saves ``{'model': state_dict, ..., 'args': Namespace}``) or a step of
    this CLI's checkpoints (its directory or its ``state.pt``)."""
    from efficient_attention_torch.config import NestedNamespace
    from efficient_attention_torch.training.checkpoint import STATE_FILE

    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    # the reference pickles its parsed flags beside the weights: read them
    # as namespaces, and nothing else but tensors and containers
    with torch.serialization.safe_globals([
            argparse.Namespace, NestedNamespace,
            (NestedNamespace, "efficient_attention.NestedNamespace")]):
        saved = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "params"):
        if isinstance(saved, dict) and key in saved:
            model.load_state_dict(saved[key], strict=True)
            print(f"| initialized params from {path} ('{key}')")
            return
    raise ValueError(f"--init-params {path}: neither a reference checkpoint "
                     "('model') nor a step of this CLI ('params')")


def build_model(args) -> torch.nn.Module:
    """The model of ``args`` with weights drawn from ``args.seed``, in eval
    mode on the CPU in float32."""
    from efficient_attention_torch.config import namespace_to_dict
    from efficient_attention_torch.models import create_model
    from efficient_attention_torch.models.layers import init_weights

    attn_args = namespace_to_dict(getattr(args, "attn_specific_args",
                                          argparse.Namespace()))
    model_kwargs = dict(
        attn_name=args.attn_name, attn_args=attn_args,
        img_size=args.input_size, num_classes=args.num_classes,
        drop_rate=args.drop, drop_path_rate=args.drop_path,
        attn_drop_rate=args.attn_drop_rate,
        checkpoint_activations=getattr(args, "checkpoint_activations", False))
    if args.model.startswith("pvt"):
        # PVT's own kwargs only (JAX cli/train_vit.py:250-265), and its stem
        # flag, which the JAX CLI registers but does not pass on
        model_kwargs["use_conv_patchify"] = getattr(args, "use_conv_patchify",
                                                    False)
    else:
        model_kwargs.update(
            patchify_stem=getattr(args, "patchify_stem", "default"),
            use_glu=getattr(args, "use_glu", False),
            use_pos_emb=not getattr(args, "no_pos_emb", False))
        if getattr(args, "depth", None):
            model_kwargs["depth"] = args.depth
        if getattr(args, "num_heads", None):
            model_kwargs["num_heads"] = args.num_heads
    model = create_model(args.model, **model_kwargs)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    return model.eval()


def evaluate(model, dataset, args, device, dtype) -> dict:
    """Top-1, top-5 and loss over every image of ``dataset``, each batch's
    means weighted by its images (the JAX CLI drops a last partial batch
    and averages batch means); ``model`` is any callable from images to
    logits."""
    from efficient_attention_torch.data.imagenet import PrefetchLoader
    from efficient_attention_torch.training.train_state import vit_eval_step

    totals = {"acc1": 0.0, "acc5": 0.0, "loss": 0.0}
    n = batches = 0
    loader = PrefetchLoader(dataset, args.batch_size, np.arange(len(dataset)),
                            num_threads=args.num_workers, drop_last=False,
                            backend=args.decode_backend)
    for imgs, labels in loader:
        out = vit_eval_step(
            model, torch.from_numpy(imgs).to(device=device, dtype=dtype),
            torch.from_numpy(labels).to(device=device, dtype=torch.int64))
        for k in totals:
            totals[k] += float(out[k]) * len(labels)
        n += len(labels)
        batches += 1
    stats = {k: v / max(n, 1) for k, v in totals.items()}
    stats.update(batches=batches, images=n)
    return stats


def _print_profile(prof, device, logdir) -> None:
    print(prof.key_averages().table(
        sort_by="self_device_time_total" if device.type == "cuda"
        else "self_cpu_time_total", row_limit=20))
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


@torch.no_grad()
def compute_throughput(model, args, device, dtype) -> dict:
    """Images/sec over 30 timed forwards of one ``--batch-size`` batch
    (``vit/utils.py:249-273``), after 3 warm-up forwards."""
    x = torch.ones((args.batch_size, args.input_size, args.input_size, 3),
                   dtype=dtype, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(3):
        model(x)
    sync()
    t0 = time.perf_counter()
    for _ in range(30):
        model(x)
    sync()
    ips = args.batch_size * 30 / (time.perf_counter() - t0)
    print(f"throughput: {ips:.1f} images/sec")
    if getattr(args, "profile", None) is not None:
        with _profiler(device) as prof:
            for _ in range(3):
                model(x)
            sync()
        _print_profile(prof, device, args.profile)
    return {"images_per_sec": ips}


def restore(ckpt, state, generator) -> bool:
    """Load the newest checkpoint of ``ckpt`` into ``state`` and the step's
    ``generator``; False where there is none.  An epoch's batches are a
    function of (seed, epoch), so they replay."""
    saved = ckpt.load()
    if saved is None:
        return False
    state.load_state_dict(saved)
    generator.set_state(saved["rng"]["generator"])
    return True


def train(args, device) -> dict:
    """The training loop (JAX ``cli/train_vit.py:213-461``) on one device;
    returns the last epoch's record."""
    from efficient_attention_torch.data.erasing import ErasingConfig
    from efficient_attention_torch.data.imagenet import PrefetchLoader
    from efficient_attention_torch.data.mixup import MixupConfig
    from efficient_attention_torch.training.checkpoint import CheckpointManager
    from efficient_attention_torch.training.metrics import (
        MetricLogger,
        write_log_line,
    )
    from efficient_attention_torch.training.optim import (
        cosine_schedule,
        make_optimizer,
        step_schedule,
    )
    from efficient_attention_torch.training.train_state import (
        TrainState,
        make_vit_train_step,
    )

    model = build_model(args)
    if args.init_params:
        load_init_params(model, args.init_params)
    model = model.to(device)  # float32 master parameters
    train_ds = build_dataset(args, train=True)
    val_ds = build_dataset(args, train=False)
    # linear lr scaling (vit/main.py:292-293)
    lr = args.lr * args.lr_ratio * args.batch_size / 512.0
    steps_per_epoch = epoch_steps(args, len(train_ds))
    if args.sched == "step":
        schedule = step_schedule(
            lr, warmup_steps=args.warmup_epochs * steps_per_epoch,
            decay_steps=max(1, int(args.decay_epochs * steps_per_epoch)),
            decay_rate=args.decay_rate, warmup_init_lr=args.warmup_lr)
    else:
        # --cooldown-epochs: the cosine ends early and the tail holds min-lr
        schedule = cosine_schedule(
            lr, warmup_steps=args.warmup_epochs * steps_per_epoch,
            total_steps=max(1, args.epochs - args.cooldown_epochs)
            * steps_per_epoch,
            warmup_init_lr=args.warmup_lr, min_lr=args.min_lr,
            steps_per_epoch=steps_per_epoch)
    betas = (tuple(float(b) for b in args.opt_betas.replace(" ", "")
                   .strip("()").split(","))
             if args.opt_betas else (0.9, 0.999))
    optimizer = make_optimizer(args.opt, model.named_parameters(), schedule,
                               weight_decay=args.weight_decay,
                               clip_grad=args.clip_grad, betas=betas,
                               eps=args.opt_eps)
    state = TrainState(model, optimizer,
                       ema_decay=args.model_ema_decay if args.model_ema else 0.0)
    mixup_cfg = None
    if args.mixup > 0 or args.cutmix > 0:
        minmax = (tuple(float(v) for v in args.cutmix_minmax.split(","))
                  if args.cutmix_minmax else None)
        mixup_cfg = MixupConfig(
            mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
            prob=args.mixup_prob, switch_prob=args.mixup_switch_prob,
            label_smoothing=args.smoothing, num_classes=args.num_classes,
            mode=args.mixup_mode, cutmix_minmax=minmax)
    erasing_cfg = (ErasingConfig(prob=args.reprob, mode=args.remode,
                                 count=args.recount)
                   if args.reprob > 0 else None)
    train_step = make_vit_train_step(
        mixup_cfg, num_classes=args.num_classes,
        label_smoothing=args.smoothing, accum_steps=args.accum_steps,
        erasing_cfg=erasing_cfg,
        compute_dtype=torch.bfloat16 if args.bf16 else None)

    def eval_model(x):
        if state.ema_params is None:
            return model(x)
        return torch.func.functional_call(model, state.ema_params, (x,))

    os.makedirs(args.output_dir, exist_ok=True)
    log_path = os.path.join(args.output_dir, "log.txt")
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    ckpt = CheckpointManager(resume_directory(args), keep_last=3)
    start_epoch = 0
    if args.resume:
        if restore(ckpt, state, generator):
            start_epoch = state.step // steps_per_epoch
            print(f"resumed at step {state.step} (epoch {start_epoch})")
        else:
            print(f"| --resume: no checkpoint in {ckpt.directory}; "
                  "training from the start")
    prof = None
    record = {}
    for epoch in range(start_epoch, args.epochs):
        logger = MetricLogger()
        # the steps an epoch takes: no batch past them is decoded
        idx = epoch_indices(args, len(train_ds), epoch)[
            :steps_per_epoch * args.batch_size]
        loader = PrefetchLoader(train_ds, args.batch_size, idx,
                                num_threads=args.num_workers, seed=epoch,
                                backend=args.decode_backend)
        t0 = time.time()
        for i, (imgs, labels) in enumerate(
                logger.log_every(loader, 50, f"Epoch [{epoch}]")):
            if args.profile is not None and epoch == start_epoch and i == 1:
                prof = _profiler(device)
                prof.start()
            metrics = train_step(
                state, torch.from_numpy(imgs).to(device),
                torch.from_numpy(labels).to(device=device, dtype=torch.int64),
                generator)
            loss = float(metrics.loss)
            logger.update(loss=loss, grad_norm=float(metrics.grad_norm))
            if prof is not None and i == 3:
                prof.stop()
                _print_profile(prof, device, args.profile)
                prof = None
            if not math.isfinite(loss):
                # the reference aborts on a non-finite loss (vit/engine.py:53-55)
                print("Loss is not finite, stopping training")
                sys.exit(1)
        if prof is not None:  # the epoch ended inside the traced steps
            prof.stop()
            _print_profile(prof, device, args.profile)
            prof = None
        model.eval()
        val_stats = evaluate(eval_model, val_ds, args, device, torch.float32)
        record = {"epoch": epoch, **logger.global_avg_dict(),
                  **{f"val_{k}": v for k, v in val_stats.items()},
                  "epoch_time": time.time() - t0}
        write_log_line(log_path, record)
        print(json.dumps(record))
        ckpt.save(state.step, dict(state.state_dict(),
                                   rng={"generator": generator.get_state()}),
                  metrics={"acc1": val_stats["acc1"]})
    return record


def main(args) -> dict:
    check_ported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    # float32 means float32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not (args.eval or args.throughput):
        return train(args, device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = build_model(args)
    if args.init_params:
        load_init_params(model, args.init_params)
    if args.resume:
        # as the JAX CLI, --resume restores before --eval and --throughput;
        # --eval scores the EMA where the checkpoint holds one
        from efficient_attention_torch.training.checkpoint import (
            CheckpointManager,
        )

        ckpt = CheckpointManager(resume_directory(args))
        step = ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(f"--resume: no checkpoint in "
                                    f"{ckpt.directory}")
        saved = ckpt.load(step, mmap=True)
        params = dict(saved["params"])  # the buffers too
        use_ema = args.eval and saved["ema_params"] is not None
        if use_ema:
            params.update(saved["ema_params"])
        model.load_state_dict(params, strict=True)
        print(f"| restored the {'EMA' if use_ema else 'parameters'} of step "
              f"{step} from {ckpt.directory}")
        del saved, params
    model = model.to(device=device, dtype=dtype)
    if args.throughput:
        return compute_throughput(model, args, device, dtype)
    stats = evaluate(model, build_dataset(args, train=False), args, device,
                     dtype)
    print(json.dumps(stats))
    return stats


def cli_main(argv=None):
    return main(parse_args(argv))


if __name__ == "__main__":
    cli_main()

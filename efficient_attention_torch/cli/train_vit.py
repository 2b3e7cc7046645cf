"""ViT CLI of the port: the ``--eval`` and ``--throughput`` paths.

Counterpart of ``efficient_attention_tpu/cli/train_vit.py`` with the same
two-pass parsing, which injects the chosen attention's flags into a nested
namespace (``vit/main.py:186-193``).  This slice serves: ``--eval`` scores
the synthetic validation set, ``--throughput`` times forwards.  Training,
real datasets and checkpoints are ROADMAP.md Queue 1, item 3.  The model
runs on ``--device`` (default ``cuda``).

Example (DeiT-tiny-p8 with 2-D EVA, the main path):

  python -m efficient_attention_torch.cli.train_vit \\
      --model evit_tiny_p8 --attn-name eva --attn-window-size 7 \\
      --attn-num-landmarks 49 --attn-attn-2d --attn-use-rpe \\
      --batch-size 128 --eval --bf16
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "EfficientAttention-Torch ViT eval", add_help=False)
    parser.add_argument("--batch-size", default=64, type=int)
    parser.add_argument("--model", default="evit_tiny_p16", type=str)
    parser.add_argument("--attn-name", default="softmax", type=str)
    parser.add_argument("--input-size", default=224, type=int)
    parser.add_argument("--drop", default=0.0, type=float)
    parser.add_argument("--drop-path", default=0.1, type=float)
    parser.add_argument("--attn-drop-rate", default=0.0, type=float)
    parser.add_argument("--no-pos-emb", action="store_true", default=False)
    parser.add_argument("--data-set", default="SYNTHETIC", type=str,
                        choices=["IMAGENET", "CIFAR10", "CIFAR100",
                                 "SYNTHETIC"])
    parser.add_argument("--num-classes", default=1000, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--throughput", action="store_true")
    parser.add_argument("--profile", action="store_true", default=False,
                        help="with --throughput: trace 3 more forwards with "
                             "torch.profiler and print the ops by device time")
    parser.add_argument("--bf16", action="store_true", default=False,
                        help="run the model in bfloat16")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to run on ('cuda' or 'cpu')")
    return parser


def parse_args(argv=None):
    """Two-pass parse: learn model/attn first, then register their flags
    (``vit/main.py:186-193``)."""
    from efficient_attention_torch import AttentionFactory, NestedNamespace
    from efficient_attention_torch.models.efficient_vit import EfficientTransformer

    parser = build_parser()
    known, _ = parser.parse_known_args(argv)
    parser = EfficientTransformer.add_model_specific_args(parser)
    parser = AttentionFactory.add_attn_specific_args(
        parser, known.attn_name, struct_name="attn_specific_args",
        prefix="attn")
    parser.add_argument("--help", action="help")
    return parser.parse_args(argv, namespace=NestedNamespace())


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
    """Mean top-1/top-5/loss over the whole batches of ``dataset``."""
    from efficient_attention_torch.data.imagenet import batch_iterator
    from efficient_attention_torch.training.train_state import vit_eval_step

    totals = {"acc1": 0.0, "acc5": 0.0, "loss": 0.0}
    n = 0
    for imgs, labels in batch_iterator(dataset, args.batch_size,
                                       np.arange(len(dataset))):
        out = vit_eval_step(
            model, torch.from_numpy(imgs).to(device=device, dtype=dtype),
            torch.from_numpy(labels).to(device))
        for k in totals:
            totals[k] += float(out[k])
        n += 1
    stats = {k: v / max(n, 1) for k, v in totals.items()}
    stats["batches"] = n
    return stats


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
    if getattr(args, "profile", False):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            for _ in range(3):
                model(x)
            sync()
        print(prof.key_averages().table(
            sort_by="self_device_time_total" if device.type == "cuda"
            else "self_cpu_time_total", row_limit=20))
    return {"images_per_sec": ips}


def main(args) -> dict:
    if not (args.eval or args.throughput):
        raise NotImplementedError(
            "ViT training is not ported yet (ROADMAP.md Queue 1, item 3); "
            "pass --eval or --throughput")
    if args.data_set != "SYNTHETIC":
        raise NotImplementedError(
            f"--data-set {args.data_set} is not ported yet (ROADMAP.md "
            "Queue 1, item 3); use SYNTHETIC")
    from efficient_attention_torch.data.imagenet import SyntheticImageDataset

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    # float32 means float32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = build_model(args).to(device=device, dtype=dtype)
    if args.throughput:
        return compute_throughput(model, args, device, dtype)
    val_ds = SyntheticImageDataset(
        num_samples=args.batch_size * 4, img_size=args.input_size,
        num_classes=args.num_classes, train=False)
    stats = evaluate(model, val_ds, args, device, dtype)
    print(json.dumps(stats))
    return stats


def cli_main(argv=None):
    return main(parse_args(argv))


if __name__ == "__main__":
    cli_main()

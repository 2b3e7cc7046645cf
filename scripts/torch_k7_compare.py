#!/usr/bin/env python3
"""Time K7 ``local_packed`` and the local-attention serving cell on one GPU,
for one or more checkouts of the repository in turns.

    python3 scripts/torch_k7_compare.py OLD_CHECKOUT . . OLD_CHECKOUT

runs one process per argument, in the order given (old, new, new, old to
compare two commits on one card), each importing
``efficient_attention_torch`` from its own checkout and building its own
kernel there, and prints one JSON line a run:

* K7's time a call (CUDA events over 50 calls) and on the device
  (torch.profiler, 20 calls) at the serving cell's shape: B=128, 28x28
  tokens, 3 heads of 64, window 7, an RPE bias, bf16;
* the cell's forward images/s (DeiT-tiny-p8 + 2-D local attention, window
  7, RPE, B=128 bf16, random weights; ``cli.train_vit``'s
  ``compute_throughput``, twice);
* one forward's device busy time under torch.profiler, the share of it in
  K7 and the idle share against the forward's unprofiled time;

with the card's name and power limit.  Exits non-zero without a GPU.
"""
import json
import os
import subprocess
import sys
import time

CELL_ARGV = [
    "--model", "evit_tiny_p8", "--input-size", "224", "--batch-size", "128",
    "--seed", "0", "--device", "cuda", "--attn-name", "local",
    "--attn-window-size", "7", "--attn-attn-2d", "--attn-use-rpe",
    "--throughput", "--bf16",
]


def self_device_ms(torch, prof, tag=""):
    """Device time (ms) of the kernels whose name holds ``tag``."""
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and tag in e.key:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
    return total / 1e3


def one(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch_k7_compare: no CUDA device")
    from efficient_attention_torch.cli import train_vit
    from efficient_attention_torch.ops.kernels import local_packed as k7

    if not os.path.abspath(k7.__file__).startswith(root):
        raise SystemExit(f"imported {k7.__file__}, not from {root}")
    device, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(128, 784, 3 * 192, generator=gen, device="cuda").to(bf16)
    bias = 0.5 * torch.randn(3, 49, 49, generator=gen, device="cuda")

    def call():
        return k7.local_attention_packed(qkv, 64 ** -0.5, 3, 28, 7, bias=bias)

    for _ in range(3):
        call()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(50):
        call()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / 50
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    k7_device_ms = self_device_ms(torch, prof, "local_packed") / 20

    args = train_vit.parse_args(CELL_ARGV)
    model = train_vit.build_model(args).to(device, bf16)
    rates = [train_vit.compute_throughput(model, args, device, bf16)["images_per_sec"]
             for _ in range(2)]
    x = torch.randn(128, 224, 224, 3, generator=gen, device="cuda").to(bf16)
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
        with train_vit._profiler(device) as prof:
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    busy = self_device_ms(torch, prof)
    k7_ms = self_device_ms(torch, prof, "local_packed")
    forward_ms = 128e3 / max(rates)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return {"root": root, "k7_call_ms": call_ms, "k7_device_ms": k7_device_ms,
            "images_per_s": rates, "forward_busy_ms": busy,
            "forward_k7_ms": k7_ms, "k7_share_of_busy": k7_ms / busy,
            "forward_wall_ms_profiled": wall_ms,
            "idle_share_unprofiled": 1 - busy / forward_ms, "card": card}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in sys.argv[1:]:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""K6 ``performer_fused`` in bf16 on one GPU: what ``chip_smoke.py`` does not
measure.

    python3 scripts/torch_performer_fused_check.py [--root DIR] [--time-only]

prints, each as one JSON line with the card's name and power limit, at the
Performer cell's headline (B=128, 784 tokens, 3 heads of 64, m = 64), at
DeiT-tiny-p16's 196 tokens, at 3136 tokens, and at head dims 16 and 32 (the
cell's width in 12 and 6 heads), ``SHAPES``:

* K6 through its wrapper on its default route, and the Performer module's
  forward on K6 and on the eager path in turns at 784 and 3136 tokens (the
  ``--time-only`` lines);
* K6 through its wrapper on the route ``plan`` picks (the ring route) and
  on the kernel that took the geometry before it (the wmma kernel,
  ``config=0``), CUDA events over 20 calls, in turns (old, plan, plan,
  old), with the largest difference between the two routes' outputs;
* every layout of the ring route in ``LAYOUTS`` that fits (warps a block,
  tile rows, ring slots, blocks an SM), in two turns, with the
  blocks an SM that the occupancy calculator allows;
* K6 against its data movement alone (``performer_fused_movement.cu``: the
  same grid, slot ring and tiles, no arithmetic), whole, pass A alone and
  without the output writes, in turns, at the headline and 3136 tokens;
* the mean SM cycles an item spends in each phase (``PHASES``) on both
  routes, from copies built with ``-DPERFORMER_PHASES`` (thread 0's clock:
  on the ring route warp 0's own work, the staging phases absorbing its
  waits for the other warps), with the blocks' mean lifetime and how many
  ran at once.

The kernel's checks against its plain version are ``chip_smoke.py``'s.
``--root DIR`` imports the port from the checkout at DIR instead of this
one; ``--time-only`` prints only the wrapper's and the module's times, and
``--cell`` only the Performer cell's forward images/s (B=128, bf16; the
kernel path and the eager path in turns), so that an older checkout can be
timed beside this one in the same call, in turns.  Exits non-zero without a
GPU or outside a checkout.
"""
import argparse
import ctypes
import itertools
import json
import os
import subprocess
import sys

import numpy as np

# (B, tokens, heads, head dim, features)
SHAPES = {"headline": (128, 784, 3, 64, 64), "p16": (128, 196, 3, 64, 64),
          "3136": (128, 3136, 3, 64, 64), "d16": (128, 784, 12, 16, 64),
          "d32": (128, 784, 6, 32, 64)}
# the ring layouts timed: (warps, tile rows, ring slots, blocks an SM)
LAYOUTS = (tuple(itertools.product((4,), (32, 64), (4, 5, 6, 8), (2, 3)))
           + tuple(itertools.product((8,), (64, 128), (4, 6), (1,))))
# kPhase* in csrc/performer_fused.cu
PHASES = ("A staging", "A logits", "A max", "B staging", "B logits + norms",
          "B features + z", "B kv products", "C staging", "C logits + norms",
          "C q' + den", "C products", "C writes", "kv reduction")
MAX_BLOCKS = 16384  # kPhaseBlocks


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def inputs(torch, B, N, nh, d, m, seed=60):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(B, N, 3 * nh * d, generator=gen, device="cuda").to(torch.bfloat16),
            torch.randn(nh, m, d, generator=gen, device="cuda"))


def wrapper_times(torch, k6, card, root):
    """The default route only (any checkout's wrapper)."""
    out = {}
    with torch.no_grad():
        for label, (B, N, nh, d, m) in SHAPES.items():
            qkv, proj = inputs(torch, B, N, nh, d, m)
            call = lambda: k6.performer_attention_fused(qkv, proj, nh)  # noqa: E731
            out[label] = [cuda_ms(torch, call), cuda_ms(torch, call)]
    print(json.dumps({"wrapper_ms": out, "root": root, "card": card}), flush=True)


def module_times(torch, card, root):
    """The Performer module's forward (dim 192, 3 heads, 64 features, B=128,
    bf16, eval; chip_smoke.py's crossover) on K6 and on the eager path, in
    turns (eager, K6, K6, eager), at 784 and 3136 tokens (any checkout)."""
    from efficient_attention_torch.attention.kernelized import KernelizedAttention

    gen = torch.Generator(device="cuda").manual_seed(61)
    out = {}
    for side in (28, 56):
        attn = KernelizedAttention(192, 3, approx_attn_dim=64).to("cuda", torch.bfloat16).eval()
        xs = torch.randn(128, side, side, 192, generator=gen, device="cuda").to(torch.bfloat16)
        turns = {}
        for impl in ("xla", "auto", "auto", "xla"):
            attn.impl = impl
            with torch.no_grad():
                turns.setdefault("eager" if impl == "xla" else "k6", []).append(
                    cuda_ms(torch, lambda: attn(xs), iters=10))
        out[side * side] = turns
    print(json.dumps({"module_ms": out, "root": root, "card": card}), flush=True)


def route_times(torch, k6, card):
    """Old kernel / plan / plan / old, per shape."""
    for label, (B, N, nh, d, m) in SHAPES.items():
        qkv, proj = inputs(torch, B, N, nh, d, m)
        calls = {"old": lambda: k6.performer_attention_fused(qkv, proj, nh, config=0),
                 "plan": lambda: k6.performer_attention_fused(qkv, proj, nh)}
        with torch.no_grad():
            diff = float((calls["old"]().float() - calls["plan"]().float()).abs().max())
            times = {}
            for key in ("old", "plan", "plan", "old"):
                times.setdefault(key, []).append(cuda_ms(torch, calls[key], iters=50))
        plan = k6.plan(B, N, nh, d, m, 2)
        print(json.dumps({"shape": label, "geometry": (B, N, nh, d, m), "ms": times,
                          "plan": plan._asdict() if plan else None,
                          "max_abs_diff_plan_vs_old": diff, "card": card}), flush=True)


def layout_times(torch, k6, card):
    """Every layout of ``LAYOUTS`` that fits, in two turns."""
    lib = k6._lib()
    for label, (B, N, nh, d, m) in SHAPES.items():
        qkv, proj = inputs(torch, B, N, nh, d, m)
        fits = [c for c in LAYOUTS if k6.plan(B, N, nh, d, m, 2, configs=(c,)) is not None
                and k6.plan(B, N, nh, d, m, 2, configs=(c,)).warps == c[0]]
        calls = {c: (lambda c: lambda: k6.performer_attention_fused(qkv, proj, nh, config=c))(c)
                 for c in fits}
        times = {}
        with torch.no_grad():
            for turn in (fits, fits[::-1]):
                for c in turn:
                    times.setdefault(str(c), []).append(cuda_ms(torch, calls[c]))
        occupancy = {str(c): lib.performer_fused_ring_blocks_per_sm(
            d, m, c[0], k6.plan(B, N, nh, d, m, 2, configs=(c,)).smem) for c in fits}
        best = min(times, key=lambda k: sum(times[k]))
        print(json.dumps({"shape": label, "layout": "(warps, tile, slots, bps)",
                          "ms": times, "fastest": best, "blocks_an_sm": occupancy,
                          "card": card}), flush=True)


def movement_times(torch, _build, k6, card):
    """K6 against its data movement alone (``performer_fused_movement.cu``:
    the same grid, ring and tiles at head dim 64, no arithmetic), with pass A
    alone and without the output writes, in turns, at the headline and 3136
    tokens."""
    so = _build.BUILD_DIR / "libperformer_fused_movement.so"
    built = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                         "performer_fused_movement.cu")],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"the movement kernel's build failed:\n{built.stdout}{built.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.performer_fused_movement_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                                                    + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream
    for label in ("headline", "3136"):
        B, N, nh, d, m = SHAPES[label]
        qkv, proj = inputs(torch, B, N, nh, d, m)
        out = torch.empty(B, N, nh * d, dtype=torch.bfloat16, device="cuda")

        def mover(mode):
            def call():
                if lib.performer_fused_movement_launch(qkv.data_ptr(), out.data_ptr(), B, N,
                                                       nh, mode, stream):
                    raise RuntimeError("the movement kernel did not launch")
            return call
        calls = {"K6": lambda: k6.performer_attention_fused(qkv, proj, nh),
                 "movement": mover(0), "movement, pass A": mover(1),
                 "movement, no writes": mover(2)}
        times = {}
        with torch.no_grad():
            for turn in (list(calls), list(calls)[::-1]):
                for key in turn:
                    times.setdefault(key, []).append(cuda_ms(torch, calls[key], iters=30))
        print(json.dumps({"shape": label, "movement_ms": times, "card": card}), flush=True)


def phases(torch, _build, k6, card):
    """Each phase's mean cycles an item on both routes, per shape."""
    so = _build.BUILD_DIR / f"lib{k6.NAME}_phases.so"
    built = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-DPERFORMER_PHASES",
                            "-o", str(so), str(_build.CSRC_DIR / f"{k6.NAME}.cu")],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"the -DPERFORMER_PHASES build failed:\n{built.stdout}{built.stderr}")
    spills = [line.strip() for line in built.stdout.splitlines() if "spill" in line]
    lib = ctypes.CDLL(str(so))
    lib.performer_fused_launch.argtypes = k6._lib().performer_fused_launch.argtypes
    lib.performer_fused_phases_copy.argtypes = [ctypes.c_void_p]
    lib.performer_fused_ring_blocks.argtypes = [ctypes.c_int] * 3
    stream = torch.cuda.current_stream().cuda_stream
    for label, (B, N, nh, d, m) in SHAPES.items():
        qkv, proj = inputs(torch, B, N, nh, d, m)
        out = torch.empty(B, N, nh * d, dtype=torch.bfloat16, device="cuda")
        plan = k6.plan(B, N, nh, d, m, 2)
        for route, layout in (("old", (0,) * 4), ("plan", tuple(plan[:4]))):
            rc = lib.performer_fused_launch(
                qkv.data_ptr(), proj.data_ptr(), out.data_ptr(), B, N, nh, d, m, 1,
                d ** -0.25, 0.5 * d ** -0.5, m ** -0.5, *layout, stream)
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"{label} {route} did not launch: {rc}")
            t = np.zeros((len(PHASES) + 3, MAX_BLOCKS), np.uint64)
            if lib.performer_fused_phases_copy(t.ctypes.data) != 0:
                raise RuntimeError("could not read the probes")
            # the launch's blocks (the probe array keeps earlier launches'
            # entries past them)
            n = B * nh if route == "old" else lib.performer_fused_ring_blocks(B, nh, plan.bps)
            t = t[:, :n].astype(np.int64)
            items = t[len(PHASES)]
            life_us = (t[-1] - t[-2]) / 1e3
            print(json.dumps({
                "shape": label, "route": route, "layout": layout, "blocks": int(n),
                "items_a_block": [int(items.min()), int(items.max())],
                "cycles_an_item": {p: float(t[i].sum() / items.sum())
                                   for i, p in enumerate(PHASES)},
                "cycles_an_item_total": float(t[:len(PHASES)].sum() / items.sum()),
                "block_us": float(life_us.mean()),
                "blocks_at_once": float(life_us.sum() / ((t[-1].max() - t[-2].min()) / 1e3)),
                "probe_build_spills": spills, "card": card}), flush=True)


# the Performer serving cell (chip_smoke.py's CELL_ARGV + CELLS["performer"])
CELL_ARGV = ["--model", "evit_tiny_p8", "--attn-name", "performer", "--attn-approx-attn-dim",
             "64", "--attn-proj-method", "favorp", "--input-size", "224", "--batch-size",
             "128", "--seed", "0", "--device", "cuda", "--throughput", "--bf16"]


def cell_rates(torch, card, root):
    """The Performer cell's forward images/s (``compute_throughput``), the
    kernel path and the eager path in turns (kernel, eager, eager, kernel)."""
    import copy

    from efficient_attention_torch.cli import train_vit

    device, bf16 = torch.device("cuda"), torch.bfloat16
    args = train_vit.parse_args(CELL_ARGV)
    kernel = train_vit.build_model(args).to(device, bf16)
    eager = copy.deepcopy(kernel)
    for blk in eager.blocks:
        blk.attn.impl = "xla"
    rates = {}
    for path, model in (("kernel", kernel), ("eager", eager), ("eager", eager),
                        ("kernel", kernel)):
        rates.setdefault(path, []).append(
            train_vit.compute_throughput(model, args, device, bf16)["images_per_sec"])
    print(json.dumps({"cell_images_per_s": rates, "root": root, "card": card}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    parser.add_argument("--time-only", action="store_true")
    parser.add_argument("--cell", action="store_true")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    try:
        import torch
        from efficient_attention_torch.ops.kernels import _build
        from efficient_attention_torch.ops.kernels import performer_fused as k6
    except ImportError as err:
        print(f"torch_performer_fused_check: run from a checkout ({err})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("torch_performer_fused_check: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.build((k6.NAME,))
    if args.cell:
        cell_rates(torch, card, root)
        return 0
    wrapper_times(torch, k6, card, root)
    module_times(torch, card, root)
    if not args.time_only:
        route_times(torch, k6, card)
        layout_times(torch, k6, card)
        movement_times(torch, _build, k6, card)
        phases(torch, _build, k6, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

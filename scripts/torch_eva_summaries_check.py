#!/usr/bin/env python3
"""K8 ``eva_summaries`` and K10a ``eva_summaries_from_x`` in bf16 on one GPU:
what ``chip_smoke.py`` does not measure.

    python3 scripts/torch_eva_summaries_check.py [--root DIR] [--time-only]

prints, each as one JSON line with the card's name and power limit, at the
DeiT-tiny-p8 headline (B=128, 28x28 tokens, chunks of 4x4, 3 heads of 64,
x of width 192), at PVT-B3's three EVA stages (B=128, head dim 32; x of
width 64, 128 and 320) and at DeiT-tiny-p16 (14x14 tokens, chunks of 2x2),
``SHAPES``:

* each kernel through its wrapper on the route ``mma_plan`` picks (the
  persistent tensor-core kernel) and on the first kernel (a block a strip,
  head and image), CUDA events over 20 calls, in turns (first, plan, plan,
  first), and K10a's yardstick ``torch.addmm(bqkv, x, Wqkv)`` then K8 on
  the plan's route, in turns with K10a; with the largest difference between
  the two routes' outputs;
* every layout of the persistent route that fits (warps a block, ring
  stages, blocks an SM, teams: ``LAYOUTS``), in two turns,
  with the blocks an SM that the occupancy calculator allows;
* the mean SM cycles a block spends in each phase (``PHASES``) on both
  routes, from copies built with ``-DEVA_SUM_PHASES``, with the blocks' mean
  lifetime and how many ran at once;
* the DeiT-tiny-p8 + EVA cell's forward images/s (B=128, bf16,
  ``cli/train_vit.py::compute_throughput``) on the default K2 route and the
  eval routes that run K8 or K10a (``ROUTES``), in ``TURNS`` turns.

The kernels' checks against their plain versions are ``chip_smoke.py``'s.
``--root DIR`` imports the port from the checkout at DIR instead of this one;
``--time-only`` prints only the wrappers' times on their default routes and
``--routes`` only the route rates, so that an older checkout can be timed
beside this one in the same call, in turns.  Exits non-zero without a GPU or
outside a checkout.
"""
import argparse
import ctypes
import itertools
import json
import os
import subprocess
import sys

import numpy as np

# (B, grid side, chunk side, heads, head dim); x is heads * head dim wide
SHAPES = {"headline": (128, 28, 4, 3, 64), "pvt stage 1": (128, 56, 8, 2, 32),
          "pvt stage 2": (128, 28, 4, 4, 32), "pvt stage 3": (128, 14, 2, 10, 32),
          "p16": (128, 14, 2, 3, 64)}
# the persistent route's layouts timed: (warps, stages, blocks an SM, teams)
LAYOUTS = tuple(itertools.product((8, 16), (1, 2, 3), (1, 2), (1,))) + ((16, 1, 1, 2),)
# a block's phases (kSum* in csrc/eva_eval.cuh): the first kernel marks them
# in warp 0's chunk; the persistent kernel sums them over its items, each
# ending at a barrier (Dense is the block-wide product there; LN, the logits,
# softmax, beta and the writes are one warp's per chunk); K10's two-team
# kernel, by the first thread of each team, without barriers: the
# projectors' staging and projection, the body team's wait and its phases
PHASES = ("staging", "projection", "means", "dense (+ LN on the first kernel)",
          "logits + softmax + beta (+ LN and writes on the persistent kernel)",
          "writes (two-team kernel: the body team's wait for projected rows)")
MAX_BLOCKS = 16384  # kSumPhaseBlocks
# the serving cell (chip_smoke.py's MAIN_ARGV) and the eval routes timed:
# EVA's toggles on the attention args (attention/eva.py dispatch order)
CELL_ARGV = ["--model", "evit_tiny_p8", "--attn-name", "eva", "--attn-window-size", "7",
             "--attn-num-landmarks", "49", "--attn-attn-2d", "--attn-use-rpe",
             "--attn-adaptive-proj", "default", "--input-size", "224", "--batch-size", "128",
             "--seed", "0", "--device", "cuda", "--throughput", "--bf16"]
ROUTES = {"default K2": {},
          "summaries": {"use_single_kernel": False, "use_pallas_summaries": True},
          "summaries+fused-out": {"use_single_kernel": False, "use_pallas_summaries": True,
                                  "fuse_output_proj": True},
          "megakernel": {"use_single_kernel": False, "use_megakernel": True}}
TURNS = 4


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


def inputs(torch, B, g, j, nh, d, seed=70):
    """qkv and x (bf16), Wqkv at 1/sqrt(fan-in), bqkv, and the adaptive Dense
    and LN (f32), drawn as chip_smoke.py's eval_inputs draws them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    dim = nh * d
    return {"qkv": r(B, g * g, 3 * dim).to(torch.bfloat16),
            "x": r(B, g * g, dim).to(torch.bfloat16),
            "wqkv": (r(dim, 3 * dim) / dim ** 0.5).to(torch.bfloat16),
            "bqkv": 0.1 * r(3 * dim),
            "adaptive": [0.2 * r(d, d), 0.1 * r(d), 0.2 * r(d, d), 0.1 * r(d),
                         1 + 0.1 * r(d), 0.1 * r(d), 1 + 0.1 * r(d), 0.1 * r(d)]}


def wrappers(k8, k10, a, shape, **kw):
    """K8's and K10a's wrapper calls on inputs ``a``."""
    B, g, j, nh, d = shape
    summ = (*a["adaptive"], nh, g, j, True)
    return {"K8": lambda: k8.eva_summaries_packed(a["qkv"], *summ, **kw),
            "K10a": lambda: k10.eva_summaries_from_x(a["x"], a["wqkv"], a["bqkv"], *summ,
                                                     **kw)}


def wrapper_times(torch, k8, k10, card, root):
    """The default routes only (any checkout's wrappers)."""
    out = {}
    with torch.no_grad():
        for label, shape in SHAPES.items():
            a = inputs(torch, *shape)
            calls = wrappers(k8, k10, a, shape)
            out[label] = {name: [cuda_ms(torch, c), cuda_ms(torch, c)]
                          for name, c in calls.items()}
    print(json.dumps({"wrapper_ms": out, "root": root, "card": card}), flush=True)


def route_times(torch, k8, k10, card):
    """First kernel / plan / yardstick / yardstick / plan / first, per shape."""
    for label, shape in SHAPES.items():
        B, g, j, nh, d = shape
        a = inputs(torch, *shape)
        first = wrappers(k8, k10, a, shape, config=0)
        new = wrappers(k8, k10, a, shape)
        summ = (*a["adaptive"], nh, g, j, True)
        dim = nh * d

        def yardstick():
            qkv = torch.addmm(a["bqkv"].to(torch.bfloat16), a["x"].view(-1, dim),
                              a["wqkv"]).view(B, g * g, 3 * dim)
            return k8.eva_summaries_packed(qkv, *summ)

        with torch.no_grad():
            diff = {name: max(float((o.float() - r.float()).abs().max())
                              for o, r in zip(new[name](), first[name]()))
                    for name in new}
            times = {}
            for name in new:
                turns = [("first", first[name]), ("plan", new[name])]
                if name == "K10a":
                    turns.append(("addmm + K8", yardstick))
                for key, call in turns + turns[::-1]:
                    times.setdefault(f"{name} {key}", []).append(
                        cuda_ms(torch, call, iters=50))
        plans = {name: k8.mma_plan(B, nh, g, g, j, d, 2, xdim=xd)
                 for name, xd in (("K8", 0), ("K10a", dim))}
        print(json.dumps({"shape": label, "geometry": shape, "ms": times,
                          "plan": {k: v._asdict() if v else None for k, v in plans.items()},
                          "max_abs_diff_plan_vs_first": diff, "card": card}), flush=True)


def layout_times(torch, k8, k10, card):
    """Every layout of the persistent route that fits, in two turns."""
    for label, shape in SHAPES.items():
        B, g, j, nh, d = shape
        a = inputs(torch, *shape)
        for name, xd, lib_bps in (
                ("K8", 0, k8._lib().eva_summaries_mma_blocks_per_sm),
                ("K10a", nh * d, k10._lib().eva_mega_summaries_mma_blocks_per_sm)):
            fits = [c for c in LAYOUTS
                    if k8.mma_plan(B, nh, g, g, j, d, 2, xdim=xd, configs=(c,)) is not None]
            calls = {c: wrappers(k8, k10, a, shape, config=c)[name] for c in fits}
            times = {}
            with torch.no_grad():
                for turn in (fits, fits[::-1]):
                    for c in turn:
                        times.setdefault(str(c), []).append(cuda_ms(torch, calls[c]))
            occupancy = {str(c): lib_bps(d, c[0], c[3], k8.mma_plan(
                B, nh, g, g, j, d, 2, xdim=xd, configs=(c,)).smem) for c in fits}
            print(json.dumps({"shape": label, "kernel": name,
                              "layout": "(warps, stages, blocks an SM, teams)",
                              "ms": times, "blocks_an_sm": occupancy, "card": card}),
                  flush=True)


def phase_libs(_build, k8, k10):
    """Copies of both libraries built with -DEVA_SUM_PHASES (in parallel)."""
    procs, libs = {}, {}
    for name, mod in ((k8.NAME, k8), (k10.NAME, k10)):
        so = _build.BUILD_DIR / f"lib{name}_sum_phases.so"
        procs[name] = (so, mod, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DEVA_SUM_PHASES", "-o", str(so),
             str(_build.CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, mod, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"the -DEVA_SUM_PHASES build of {name} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in ("eva_summaries_launch", "eva_mega_summaries_launch"):
            if hasattr(mod._lib(), fn):
                getattr(lib, fn).argtypes = getattr(mod._lib(), fn).argtypes
        libs[name] = lib
    return libs


def phases(torch, _build, k8, k10, card):
    """Each phase's mean cycles a block on both routes, per shape."""
    libs = phase_libs(_build, k8, k10)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, shape in SHAPES.items():
        B, g, j, nh, d = shape
        a = inputs(torch, *shape)
        w = k8.adaptive_operands(a["qkv"], d, *a["adaptive"], True, "phases")
        N, dim, C = g * g, nh * d, (g // j) ** 2
        rf = torch.empty(B, C, dim, dtype=torch.bfloat16, device="cuda")
        beta = torch.empty_like(rf)
        stream = torch.cuda.current_stream().cuda_stream
        for name, xd in (("K8", 0), ("K10a", dim)):
            plan = k8.mma_plan(B, nh, g, g, j, d, 2, xdim=xd)
            for route, cfg in (("first", (0, 0, 0, 0)),
                               ("plan", tuple(plan[:4]) if plan else None)):
                if cfg is None:
                    continue
                if name == "K8":
                    lib, copy = libs[k8.NAME], "eva_summaries_sum_phases_copy"
                    rc = lib.eva_summaries_launch(
                        a["qkv"].data_ptr(), *[t.data_ptr() for t in w], rf.data_ptr(),
                        beta.data_ptr(), B, N, g, j, nh, d, 1, 1, *cfg, stream)
                else:
                    lib, copy = libs[k10.NAME], "eva_mega_sum_phases_copy"
                    rc = lib.eva_mega_summaries_launch(
                        a["x"].data_ptr(), a["wqkv"].data_ptr(), a["bqkv"].data_ptr(),
                        *[t.data_ptr() for t in w], rf.data_ptr(), beta.data_ptr(), B, N,
                        xd, g, j, nh, d, 1, 1, *cfg, stream)
                torch.cuda.synchronize()
                if rc != 0:
                    raise RuntimeError(f"{name} {route} did not launch: {rc}")
                t = np.zeros((8, MAX_BLOCKS), np.uint64)
                getattr(lib, copy).argtypes = [ctypes.c_void_p]
                if getattr(lib, copy)(t.ctypes.data) != 0:
                    raise RuntimeError("could not read the probes")
                # the launch's blocks (the probe array keeps earlier launches'
                # entries past them)
                n = ((g // j) * nh * B if route == "first"
                     else k8.mma_blocks(B, nh, g // j, cfg[2], sms))
                t = t[:, :n].astype(np.int64)
                life_us = (t[1] - t[0]) / 1e3
                print(json.dumps({
                    "shape": label, "kernel": name, "route": route, "config": cfg,
                    "blocks": n,
                    "cycles_a_block": {p: float(t[2 + i].mean()) for i, p in enumerate(PHASES)},
                    "block_us": float(life_us.mean()),
                    "blocks_at_once": float(life_us.sum() / ((t[1].max() - t[0].min()) / 1e3)),
                    "card": card}), flush=True)


def route_rates(torch, card, root):
    """Forward images/s of each route in ``ROUTES``, in turns (forward
    order, then reversed)."""
    from efficient_attention_torch.cli import train_vit

    device, bf16 = torch.device("cuda"), torch.bfloat16
    models = {}
    for route, toggles in ROUTES.items():
        args = train_vit.parse_args(CELL_ARGV)
        for key, value in toggles.items():
            setattr(args.attn_specific_args, key, value)
        models[route] = (train_vit.build_model(args).to(device, bf16), args)
    rates = {}
    for turn in range(TURNS):
        for route in list(ROUTES)[::1 if turn % 2 == 0 else -1]:
            model, args = models[route]
            rates.setdefault(route, []).append(
                train_vit.compute_throughput(model, args, device, bf16)["images_per_sec"])
    print(json.dumps({"route_images_per_s": rates, "root": root, "card": card}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    parser.add_argument("--time-only", action="store_true")
    parser.add_argument("--routes", action="store_true")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    try:
        import torch
        from efficient_attention_torch.ops.kernels import _build
        from efficient_attention_torch.ops.kernels import eva_mega as k10
        from efficient_attention_torch.ops.kernels import eva_summaries as k8
    except ImportError as err:
        print(f"torch_eva_summaries_check: run from a checkout ({err})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("torch_eva_summaries_check: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.build((k8.NAME, k10.NAME))
    if args.routes:
        route_rates(torch, card, root)
        return 0
    wrapper_times(torch, k8, k10, card, root)
    if not args.time_only:
        route_times(torch, k8, k10, card)
        layout_times(torch, k8, k10, card)
        phases(torch, _build, k8, k10, card)
        route_rates(torch, card, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())

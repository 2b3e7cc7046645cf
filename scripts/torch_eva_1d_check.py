#!/usr/bin/env python3
"""K4 ``eva_1d`` on one GPU: what ``chip_smoke.py`` does not measure.

    python3 scripts/torch_eva_1d_check.py [--root DIR] [--time-only]

prints, each as one JSON line with the card's name and power limit, at
``chip_smoke.py``'s K4 shapes ``recipe`` (the WMT encoder's batch: B=64
sentences of 32 tokens, 8 heads of 64, window 8, halo 4, 8 chunks, T5
bias, random lengths) and ``long`` (B=16 sentences of 256 tokens):

Each timing section starts with two seconds of f32 matrix products, so
that it runs at the clocks of a loaded card (read back by nvidia-smi).

* K4 through its wrapper on its default route in f32 and bf16, a call
  (CUDA events over 100 calls, two turns) and on the device (``device_ms``:
  20 calls run back to back behind a sleep kernel, two turns,
  after every CUDA-event turn),
  and the f32 MT encoder's forward of one batch on K4 and on the eager path
  in turns (the ``--time-only`` lines);
* in f32, the split-TF32 route at ``plan``'s item size and the CUDA-core
  kernel (``config=0``) in turns (old, plan, plan, old), a call and on the
  device, with torch.profiler's reading of each beside it and the largest
  difference between their outputs;
* the split-TF32 route at every item size of ``ROWS`` that the shape
  takes (query rows an item, a block an item, a warp a 16-row strip), on
  the device in two turns: the sweep behind ``TF32_ROWS``;
* the route against its data movement alone (``eva_1d_movement.cu``: the
  same grid and items, no arithmetic), with and without the output writes,
  at the plan's item size, on the device in turns;
* the mean SM cycles a warp spends in each phase (``PHASES``) of both
  kernels, from a copy built with ``-DEVA1D_PHASES`` (lane 0's clock of
  each warp), with the blocks' mean lifetime and how many warps ran at
  once.

The kernel's checks against its plain version are ``chip_smoke.py``'s.
``--root DIR`` imports the port from the checkout at DIR instead of this
one; ``--time-only`` prints only the wrapper's and the encoder's times, so
that an older checkout can be timed beside this one in the same call, in
turns.  Exits non-zero without a GPU or outside a checkout.
"""
import argparse
import copy
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

SHAPES = ("recipe", "long")
# the split-TF32 route's item sizes timed (query rows), those that a shape
# takes
ROWS = (16, 32, 64, 128)
# kPhase* in csrc/eva_1d.cu
PHASES = ("staging", "logits", "softmax", "output")
PHASE_SLOTS = 1 << 16  # kPhaseSlots


def cuda_ms(torch, fn, iters=100, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def warm(torch, seconds=2.0):
    """Keeps the card busy for a while (f32 matrix products), so that the
    timings after it run at the clocks of a loaded card; returns the SM
    clock, memory clock and power draw that nvidia-smi reads then."""
    import time

    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a = (a @ a).tanh_()
        torch.cuda.synchronize()
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def device_ms(torch, call, n=20):
    """Mean device time of a call over ``n`` calls run back to back, as
    ``chip_smoke.py``'s ``device_ms`` reads it: one pair of CUDA events
    around the ``n`` calls while a sleep kernel holds the stream until all
    of them are queued; raises where the host did not get ahead."""
    call()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    held = torch.cuda.Event()
    for cycles in (4 * 10 ** 7, 4 * 10 ** 8):  # ~20 and ~200 ms at 1.98 GHz
        torch.cuda._sleep(cycles)
        held.record()
        start.record()
        for _ in range(n):
            call()
        end.record()
        ahead = not held.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / n
    raise RuntimeError(f"device_ms: the host did not queue {n} calls within the sleep")


def profiler_ms(torch, call, tag="eva_1d_", n=20):
    """torch.profiler's reading of ``n`` calls, to hold ``device_ms``
    against: the kernels named ``tag``, their summed device time over
    ``n``, the launches it recorded, and the sum over those."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages() if tag in e.key]
    got = sum(e.count for e in seen)
    ms = sum(getattr(e, "self_device_time_total", 0) for e in seen) / 1e3
    return {"over_n": ms / n, "recorded": got, "over_recorded": ms / max(got, 1)}


def shape_inputs(torch, S, label, dtype_name, seed=80):
    """chip_smoke.py's K4 inputs at one of its shapes, and the geometry
    arguments (scale, heads, window, halo)."""
    B, N, nh, d, ws, ext, C, bias_kind = dict(S.K4_CHECKS)[label]
    qkv, rf, beta, mask, bias = S.k4_inputs(B, N, nh, d, ws, ext, C, bias_kind,
                                            getattr(torch, dtype_name), seed=seed)
    return (qkv, rf, beta, mask, bias), (d ** -0.5, nh, ws, ext)


def wrapper_times(torch, S, k4, card, root):
    """The default route, a call in two turns, then on the device in two
    turns, a shape and type (any checkout's wrapper)."""
    calls = {}
    for label in SHAPES:
        for dtype_name in ("float32", "bfloat16"):
            a, geo = shape_inputs(torch, S, label, dtype_name)
            calls[f"{label} {dtype_name}"] = (lambda a, geo: lambda: k4.eva_attention_1d(
                *a[:4], *geo, bias=a[4]))(a, geo)
    out = {key: {"ms_a_call": [], "device_ms": []} for key in calls}
    clocks = warm(torch)
    with torch.no_grad():
        for _ in range(2):
            for key, call in calls.items():
                out[key]["ms_a_call"].append(cuda_ms(torch, call))
        for _ in range(2):
            for key, call in calls.items():
                out[key]["device_ms"].append(device_ms(torch, call))
    print(json.dumps({"wrapper": out, "clocks_after_warm_up": clocks, "root": root,
                      "card": card}), flush=True)


def encoder_times(torch, S, card, root):
    """The f32 MT encoder's forward of one batch (64 sentences of 32 tokens,
    chip_smoke.py's model), on K4 and on the eager path in turns (any
    checkout)."""
    from efficient_attention_torch.cli import generate

    args = generate.parse_args(S.MT_ARGV)
    model = generate.build_model(args, S.MT_VOCAB, S.MT_VOCAB).cuda().eval()
    eager = copy.deepcopy(model)
    for layer in eager.encoder.layers:
        layer.self_attn.attn.impl = "xla"
    src, _, _, _ = generate.load_pairs(args)
    _, src_b, _, _, _ = next(generate.generation_batches(args, src))
    src_t = torch.from_numpy(src_b).cuda()
    turns = {}
    warm(torch)
    with torch.no_grad():
        for path, m in (("kernel", model), ("eager", eager), ("eager", eager),
                        ("kernel", model)):
            turns.setdefault(path, []).append(cuda_ms(torch, lambda: m.encode(src_t), 20))
    print(json.dumps({"encoder_forward_ms": turns, "batch": list(src_b.shape),
                      "root": root, "card": card}), flush=True)


def route_times(torch, S, k4, card):
    """f32: the CUDA-core kernel and the split-TF32 route, in turns."""
    for label in SHAPES:
        a, geo = shape_inputs(torch, S, label, "float32")
        calls = {"old": lambda: k4.eva_attention_1d(*a[:4], *geo, bias=a[4], config=0),
                 "plan": lambda: k4.eva_attention_1d(*a[:4], *geo, bias=a[4])}
        clocks = warm(torch)
        with torch.no_grad():
            mask = a[3]
            diff = float((calls["old"]() - calls["plan"]())[~mask].abs().max())
            ms, dev = {}, {}
            for key in ("old", "plan", "plan", "old"):
                ms.setdefault(key, []).append(cuda_ms(torch, calls[key]))
            for key in ("old", "plan", "plan", "old"):
                dev.setdefault(key, []).append(device_ms(torch, calls[key]))
            prof = {key: profiler_ms(torch, calls[key]) for key in ("old", "plan")}
        B, N, _ = a[0].shape
        nh, ws, ext = geo[1:]
        d, C = a[0].shape[-1] // (3 * nh), a[1].shape[1]
        plan = k4.plan(B, N, ws, ext, C, nh, d, 4)
        print(json.dumps({"shape": label, "ms_a_call": ms, "device_ms": dev,
                          "profiler_ms": prof,
                          "clocks_after_warm_up": clocks,
                          "plan": plan._asdict() if plan else None,
                          "max_abs_diff_plan_vs_old": diff, "card": card}), flush=True)


def rows_times(torch, S, k4, card):
    """Every item size of ``ROWS`` that a shape takes, on the device in two
    turns."""
    for label in SHAPES:
        a, geo = shape_inputs(torch, S, label, "float32")
        B, N, _ = a[0].shape
        nh, ws, ext = geo[1:]
        d, C = a[0].shape[-1] // (3 * nh), a[1].shape[1]
        fits = [r for r in ROWS if r <= -(-N // 16) * 16
                and k4.tf32_config_ok(d, ws, ext, C, r)]
        times = {}
        warm(torch)
        with torch.no_grad():
            for turn in (fits, fits[::-1]):
                for rows in turn:
                    times.setdefault(rows, []).append(device_ms(
                        torch, lambda: k4.eva_attention_1d(*a[:4], *geo, bias=a[4],
                                                           config=rows)))
        print(json.dumps({"shape": label, "rows_an_item": times,
                          "plan": k4.plan(B, N, ws, ext, C, nh, d, 4)._asdict(),
                          "card": card}), flush=True)


def movement_times(torch, S, _build, k4, card):
    """The route against its data movement alone (``eva_1d_movement.cu``),
    with and without the output writes, at the plan's item size, in turns."""
    so = _build.BUILD_DIR / "libeva_1d_movement.so"
    built = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                         "eva_1d_movement.cu")],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"the movement kernel's build failed:\n{built.stdout}{built.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.eva_1d_movement_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                                           + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream
    for label in SHAPES:
        (qkv, rf, beta, mask, bias), geo = shape_inputs(torch, S, label, "float32")
        B, N, _ = qkv.shape
        nh, ws, ext = geo[1:]
        d, C = qkv.shape[-1] // (3 * nh), rf.shape[1]
        plan = k4.plan(B, N, ws, ext, C, nh, d, 4)
        out = torch.empty(B, N, nh * d, device="cuda")

        def mover(mode):
            def call():
                if lib.eva_1d_movement_launch(qkv.data_ptr(), rf.data_ptr(), beta.data_ptr(),
                                              out.data_ptr(), B, N, nh, ws, ext, C,
                                              plan.rows, mode, stream):
                    raise RuntimeError("the movement kernel did not launch")
            return call
        calls = {"K4": lambda: k4.eva_attention_1d(qkv, rf, beta, mask, *geo, bias=bias),
                 "movement": mover(0), "movement, no writes": mover(1)}
        times = {}
        warm(torch)
        with torch.no_grad():
            for turn in (list(calls), list(calls)[::-1]):
                for key in turn:
                    times.setdefault(key, []).append(device_ms(torch, calls[key]))
        print(json.dumps({"shape": label, "plan": plan._asdict(), "device_ms": times,
                          "card": card}), flush=True)


def phases(torch, S, _build, k4, card):
    """Each phase's mean cycles a warp on both kernels, per shape, in
    f32."""
    so = _build.BUILD_DIR / f"lib{k4.NAME}_phases.so"
    built = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-DEVA1D_PHASES",
                            "-o", str(so), str(_build.CSRC_DIR / f"{k4.NAME}.cu")],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"the -DEVA1D_PHASES build failed:\n{built.stdout}{built.stderr}")
    spills = [line.strip() for line in built.stdout.splitlines() if "spill" in line]
    lib = ctypes.CDLL(str(so))
    lib.eva_1d_launch.argtypes = k4._lib().eva_1d_launch.argtypes
    lib.eva_1d_phases_copy.argtypes = [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    for label in SHAPES:
        (qkv, rf, beta, mask, bias), (scale, nh, ws, ext) = shape_inputs(
            torch, S, label, "float32")
        B, N, _ = qkv.shape
        d, C = qkv.shape[-1] // (3 * nh), rf.shape[1]
        out = torch.empty(B, N, nh * d, device="cuda")
        wpb = k4.wpb_plan(B, N, ws, ext, C, nh, d, 4)
        plan = k4.plan(B, N, ws, ext, C, nh, d, 4)
        for route, rows in (("cuda cores", 0), ("split tf32", plan.rows)):
            rc = lib.eva_1d_launch(qkv.data_ptr(), rf.data_ptr(), beta.data_ptr(),
                                   mask.data_ptr(), bias.data_ptr(), out.data_ptr(), B, N,
                                   nh, d, ws, ext, C, wpb, 0, scale, rows, stream)
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"{label} {route} did not launch: {rc}")
            t = np.zeros((len(PHASES) + 2, PHASE_SLOTS), np.uint64)
            if lib.eva_1d_phases_copy(t.ctypes.data) != 0:
                raise RuntimeError("could not read the probes")
            # the launch's warps (the probe array keeps earlier launches'
            # entries past them)
            if rows:
                warps = B * nh * -(-N // rows) * plan.warps
            else:
                warps = 4 * -(-N // (wpb * ws)) * nh * B
            t = t[:, :warps].astype(np.int64)
            life_us = (t[-1] - t[-2]) / 1e3
            print(json.dumps({
                "shape": label, "route": route, "rows": rows, "warps": int(warps),
                "cycles_a_warp": {p: float(t[i].mean()) for i, p in enumerate(PHASES)},
                "cycles_a_warp_total": float(t[:len(PHASES)].sum(0).mean()),
                "block_us": float(life_us.mean()),
                "warps_at_once": float(life_us.sum() / ((t[-1].max() - t[-2].min()) / 1e3)),
                "probe_build_spills": spills, "card": card}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    parser.add_argument("--time-only", action="store_true")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    try:
        import torch
        import chip_smoke as S
        from efficient_attention_torch.ops.kernels import _build
        from efficient_attention_torch.ops.kernels import eva_1d as k4
    except ImportError as err:
        print(f"torch_eva_1d_check: run from a checkout ({err})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("torch_eva_1d_check: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.build((k4.NAME,))
    ptxas = [line.strip() for line in (_build.BUILD_DIR / f"{k4.NAME}.log").read_text()
             .splitlines() if "registers" in line or "spill" in line]
    print(json.dumps({"ptxas": ptxas, "root": root, "card": card}), flush=True)
    wrapper_times(torch, S, k4, card, root)
    encoder_times(torch, S, card, root)
    if not args.time_only:
        route_times(torch, S, k4, card)
        rows_times(torch, S, k4, card)
        movement_times(torch, S, _build, k4, card)
        phases(torch, S, _build, k4, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

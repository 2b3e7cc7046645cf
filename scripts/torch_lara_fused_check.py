#!/usr/bin/env python3
"""K5 ``lara_fused`` at the LARA cell's headline (B=128, 28x28 tokens, 3
heads of 64, 49 landmarks, bf16) on one GPU: what ``chip_smoke.py`` does not
measure.

    python3 scripts/torch_lara_fused_check.py [--root DIR] [--time-only]

prints, each as one JSON line with the card's name and power limit:

* K5 through its wrapper (the route ``plan`` picks), CUDA events over 20
  calls, in two turns;
* the cluster route launched at each candidate cluster size, in two turns,
  with the blocks' shared memory and how many clusters fit the card at once
  (the occupancy calculator), and the CUDA-core kernel on the same inputs;
  the same at DeiT-tiny-p16's and PVT-B3 stage 1's token counts
  (``OTHER_SHAPES``);
* the mean SM cycles a block of the cluster route spends in each phase
  (``PHASES``: staging, phase A's two halves, the three steps of the
  exchange, phase B), from a copy built with ``-DLARA_PHASES``, with the
  blocks' mean lifetime and how many ran at once.

The kernel's checks against its plain version and its registers are
``chip_smoke.py``'s.  ``--root DIR`` imports the port from the checkout at
DIR instead of this one; ``--time-only`` prints only the wrapper's time, so
that an older checkout can be timed beside this one in the same call, in
turns.  Exits non-zero without a GPU or outside a checkout.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

B, N, NH, D, C = 128, 784, 3, 64, 49
# the cluster sizes timed at the headline, and at DeiT-tiny-p16's 196 tokens
# and PVT-B3 stage 1's 3136 tokens (one head of 64 there)
RANKS = (2, 4, 7, 8, 14, 16)
OTHER_SHAPES = {"p16": ((128, 196, 3), (1, 2, 4, 7)), "pvt stage 1": ((32, 3136, 1), (8, 16))}
PHASES = ("stage", "statistics", "maxima exchanged (barriers #0, #1)", "sums and kv",
          "sums sent, phase B products (barrier #2)", "owners' sums sent back",
          "barrier #3", "phase B")
MAX_BLOCKS = 16384  # kPhaseBlocks in csrc/lara_fused.cu


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


def inputs(torch, seed=60, b=B, n=N, nh=NH):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    return (r(b, n, 3 * nh * D).to(torch.bfloat16), 0.5 * r(b, nh, C, D),
            0.5 * r(b, nh, C, D), torch.softmax(r(b, nh, C), -1), r(b, nh, C))


def launcher(torch, lib, a, ranks):
    """A call that launches the kernel of ``lib`` on ``a`` with ``ranks``
    (the launcher's route argument), raising if it does not launch."""
    qkv = a[0]
    b, n, nh = qkv.shape[0], qkv.shape[1], qkv.shape[2] // (3 * D)
    out = torch.empty(b, n, nh * D, dtype=qkv.dtype, device="cuda")
    args = (*(t.data_ptr() for t in a), out.data_ptr(), b, n, nh, D, C, 1, D ** -0.5,
            D ** -0.5, 2.0, ranks, torch.cuda.current_stream().cuda_stream)

    def call():
        rc = lib.lara_fused_launch(*args)
        if rc != 0:
            raise RuntimeError(f"lara_fused did not launch at ranks={ranks}: "
                               f"{lib.lara_fused_error_string(rc).decode()}")
        return out
    return call


def wrapper_times(torch, k5, a, card, root):
    call = lambda: k5.lara_attention_fused(a[0], *a[1:], D ** -0.5, NH, 2.0)  # noqa: E731
    with torch.no_grad():
        times = [cuda_ms(torch, call), cuda_ms(torch, call)]
    route = k5.plan(B, N, NH, D, C, 2) if hasattr(k5, "plan") else None
    print(json.dumps({"headline_ms": times, "route": route, "root": root, "card": card}),
          flush=True)


def rank_times(torch, k5, a, card):
    """The cluster route at each candidate cluster size, in two turns, and
    the CUDA-core kernel on the same inputs; then the other shapes' cluster
    sizes."""
    lib = k5._lib()
    shapes = {"headline": (a, RANKS + ("cuda cores",))}
    for label, ((b, n, nh), ranks) in OTHER_SHAPES.items():
        shapes[label] = (inputs(torch, 61, b, n, nh), ranks)
    for label, (x, ranks) in shapes.items():
        b, n = x[0].shape[:2]
        calls = {R: launcher(torch, lib, x, 0 if R == "cuda cores" else R) for R in ranks}
        ref = launcher(torch, lib, x, k5.plan(b, n, x[1].shape[1], D, C, 2)[0])().float()
        diff = {str(k): float((c().float() - ref).abs().max()) for k, c in calls.items()}
        times = {}
        for turn in (list(calls), list(reversed(calls))):
            for key in turn:
                times.setdefault(str(key), []).append(cuda_ms(torch, calls[key]))
        real = [R for R in ranks if R != "cuda cores"]
        print(json.dumps({
            "shape": label, "plan": k5.plan(b, n, x[1].shape[1], D, C, 2), "ranks_ms": times,
            "max_abs_diff_from_plan": diff,
            "smem_bytes": {R: k5.smem_bytes(D, C, 2, -(-n // R), R) for R in real},
            "clusters_at_once": {R: lib.lara_fused_max_active_clusters(n, D, C, R)
                                 for R in real},
            "card": card}), flush=True)


def phases(torch, _build, k5, a, card):
    """Each phase's mean cycles a block, from a copy of the library built
    with -DLARA_PHASES, at the cluster size ``plan`` picks."""
    so = _build.BUILD_DIR / f"lib{k5.NAME}_phases.so"
    built = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-DLARA_PHASES", "-o",
                            str(so), str(_build.CSRC_DIR / f"{k5.NAME}.cu")],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"the -DLARA_PHASES build failed:\n{built.stdout}{built.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.lara_fused_launch.argtypes = k5._lib().lara_fused_launch.argtypes
    lib.lara_fused_error_string.restype = ctypes.c_char_p
    R = k5.plan(B, N, NH, D, C, 2)[0]
    launcher(torch, lib, a, R)()
    torch.cuda.synchronize()
    lib.lara_fused_phases_copy.argtypes = [ctypes.c_void_p]
    t = np.zeros((12, MAX_BLOCKS), np.uint64)
    if lib.lara_fused_phases_copy(t.ctypes.data) != 0:
        raise RuntimeError("could not read the probes")
    n = int((t[11] > 0).sum())
    t = t[:, :n].astype(np.int64)
    life_us = (t[11] - t[10]) / 1e3
    print(json.dumps({
        "phases_at_ranks": R, "blocks": n,
        "cycles_a_block": {p: float((t[i + 1] - t[i]).mean()) for i, p in enumerate(PHASES)},
        "block_us": float(life_us.mean()),
        "blocks_at_once": float(life_us.sum() / ((t[11].max() - t[10].min()) / 1e3)),
        "card": card}), flush=True)


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
        from efficient_attention_torch.ops.kernels import _build
        from efficient_attention_torch.ops.kernels import lara_fused as k5
    except ImportError as err:
        print(f"torch_lara_fused_check: run from a checkout ({err})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("torch_lara_fused_check: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.build((k5.NAME,))
    a = inputs(torch)
    wrapper_times(torch, k5, a, card, root)
    if not args.time_only:
        rank_times(torch, k5, a, card)
        phases(torch, _build, k5, a, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

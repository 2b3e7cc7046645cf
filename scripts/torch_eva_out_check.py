#!/usr/bin/env python3
"""K9 ``eva_packed_out`` and K10b ``eva_attention_from_x`` on their bf16
tensor-core route at the DeiT-tiny-p8 headline (B=128, 28x28 tokens, 3 heads
of 64, window 7, 49 chunks), on one GPU: what ``chip_smoke.py`` does not
measure.

    python3 scripts/torch_eva_out_check.py [--root DIR] [--time-only]

prints, each as one JSON line with the card's name and power limit:

* K9 and K10b through their wrappers, CUDA events over 20 calls, in two
  turns;
* both launched as built (one-pass strips, whose head-dim-64 instantiations
  spill a few registers) and as built with ``-DEVA_OUT_TWO_PASS`` (strips
  of two passes, which do not spill), in turns, with the spills ``ptxas``
  reports for the instantiations the headline runs;
* the mean SM cycles a block spends in each phase (staging waits, the qkv
  projection, the strips, the output projection; summed over its windows),
  from copies built with ``-DEVA_OUT_PHASES``, with the blocks' mean
  lifetime and how many ran at once.

The kernels' checks against their plain versions, their registers and
their yardsticks are ``chip_smoke.py``'s.  ``--root DIR`` imports the port
from the checkout at DIR instead of this one; ``--time-only`` prints only
the wrappers' times, so that an older checkout can be timed beside this one
in the same call.  Exits non-zero without a GPU or outside a checkout.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

B, G, WS, J, NH, D = 128, 28, 7, 4, 3, 64
PHASES = ("stage", "projection", "strips", "output projection")
MAX_BLOCKS = 16384  # kPhaseBlocks in csrc/eva_eval.cuh


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


def inputs(torch, seed=95):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    dim, C, bf16 = NH * D, (G // J) ** 2, torch.bfloat16
    return {"qkv": r(B, G * G, 3 * dim).to(bf16), "x": r(B, G * G, dim).to(bf16),
            "wqkv": (r(dim, 3 * dim) / dim ** 0.5).to(bf16), "bqkv": 0.1 * r(3 * dim),
            "rf": r(B, C, dim).to(bf16), "beta": r(B, C, dim).to(bf16),
            "wo": (r(dim, dim) / dim ** 0.5).to(bf16), "bo": 0.1 * r(dim),
            "bias": 0.5 * r(NH, WS * WS, WS * WS)}


def wrapper_times(torch, k9, k10, a, card, root):
    att = (a["rf"], a["beta"], a["wo"], a["bo"], D ** -0.5, NH, G, WS, a["bias"])
    calls = {"K9": lambda: k9.eva_attention_packed_out(a["qkv"], *att),
             "K10b": lambda: k10.eva_attention_from_x(a["x"], a["wqkv"], a["bqkv"], *att)}
    times = {}
    with torch.no_grad():
        for turn in (list(calls), list(reversed(calls))):
            for name in turn:
                times.setdefault(name, []).append(cuda_ms(torch, calls[name]))
    print(json.dumps({"headline_ms": times, "root": root, "card": card}), flush=True)


def variant(_build, name, flag, log=False):
    """A copy of library ``name`` built with ``flag`` (and, with ``log``,
    what nvcc printed)."""
    so = _build.BUILD_DIR / f"lib{name}_{flag.lstrip('-D').lower()}.so"
    built = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, flag, "-o", str(so),
                            str(_build.CSRC_DIR / f"{name}.cu")],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"the {flag} build failed:\n{built.stdout}{built.stderr}")
    lib = ctypes.CDLL(str(so))
    return (lib, built.stdout + built.stderr) if log else lib


def launcher(torch, k9, k10, lib, name, a):
    """A call that launches ``name``'s kernel from ``lib`` on ``a`` (the
    wrappers' argument types), raising if it does not launch."""
    N, C, dim = G * G, (G // J) ** 2, NH * D
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(B, N, dim, dtype=torch.bfloat16, device="cuda")
    if name == k9.NAME_OUT:
        fn = lib.eva_packed_out_launch
        fn.argtypes = k9._lib_out().eva_packed_out_launch.argtypes
        args = (a["qkv"].data_ptr(), a["rf"].data_ptr(), a["beta"].data_ptr(),
                a["bias"].data_ptr(), a["wo"].data_ptr(), a["bo"].data_ptr(),
                out.data_ptr(), B, N, G, WS, NH, D, C, 1, D ** -0.5, stream)
    else:
        fn = lib.eva_mega_attention_launch
        fn.argtypes = k10._lib().eva_mega_attention_launch.argtypes
        args = (a["x"].data_ptr(), a["wqkv"].data_ptr(), a["bqkv"].data_ptr(),
                a["rf"].data_ptr(), a["beta"].data_ptr(), a["bias"].data_ptr(),
                a["wo"].data_ptr(), a["bo"].data_ptr(), out.data_ptr(), B, N, dim, G, WS,
                NH, D, C, 1, D ** -0.5, stream)

    def call():
        if fn(*args) != 0:
            raise RuntimeError(f"{name} did not launch")
        return out
    return call


def two_pass_times(torch, _build, k9, k10, a, card):
    """Both kernels as built against both built with two-pass strips."""
    calls, spills = {}, {}
    for name in (k9.NAME_OUT, k10.NAME):
        lib, log = variant(_build, name, "-DEVA_OUT_TWO_PASS", log=True)
        built = (_build.BUILD_DIR / f"{name}.log").read_text()
        # the headline's instantiations: D = 64, split off, one pass as
        # built, two passes in the variant
        for label, text, one in (("as built", built, "1"), ("two-pass", log, "0")):
            spills[f"{name} {label}"] = re.search(
                rf"eva_out_mma_kernelILi64ELb[01]ELb{one}ELb0E.*?(\d+ bytes spill stores)",
                text, re.S)[1]
        calls[f"{name} as built"] = launcher(
            torch, k9, k10, k9._lib_out() if name == k9.NAME_OUT else k10._lib(), name, a)
        calls[f"{name} two-pass"] = launcher(torch, k9, k10, lib, name, a)
    same = {name: float((calls[f"{name} as built"]().float()
                         - calls[f"{name} two-pass"]().float()).abs().max())
            for name in (k9.NAME_OUT, k10.NAME)}
    times = {}
    for turn in (list(calls), list(reversed(calls)), list(calls)):
        for key in turn:
            times.setdefault(key, []).append(cuda_ms(torch, calls[key]))
    print(json.dumps({"one_vs_two_pass_ms": times, "spills": spills,
                      "max_abs_diff": same, "card": card}), flush=True)


def phases(torch, _build, k9, k10, a, card):
    """Each phase's mean cycles a block, from copies of both libraries built
    with -DEVA_OUT_PHASES."""
    for name in (k9.NAME_OUT, k10.NAME):
        lib = variant(_build, name, "-DEVA_OUT_PHASES")
        launcher(torch, k9, k10, lib, name, a)()
        torch.cuda.synchronize()
        copy = getattr(lib, f"{name}_phases_copy")
        copy.argtypes = [ctypes.c_void_p]
        t = np.zeros((2 + len(PHASES), MAX_BLOCKS), np.uint64)
        if copy(t.ctypes.data) != 0:
            raise RuntimeError("could not read the probes")
        n = int((t[1] > 0).sum())
        t = t[:, :n].astype(np.int64)
        life_us = (t[1] - t[0]) / 1e3
        print(json.dumps({
            "phases": name, "blocks": n,
            "cycles_a_block": {p: float(t[2 + i].mean()) for i, p in enumerate(PHASES)},
            "block_us": float(life_us.mean()),
            "blocks_at_once": float(life_us.sum() / ((t[1].max() - t[0].min()) / 1e3)),
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
        from efficient_attention_torch.ops.kernels import eva_mega as k10
        from efficient_attention_torch.ops.kernels import eva_packed as k9
    except ImportError as err:
        print(f"torch_eva_out_check: run from a checkout ({err})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("torch_eva_out_check: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.build((k9.NAME_OUT, k10.NAME))
    a = inputs(torch)
    wrapper_times(torch, k9, k10, a, card, root)
    if not args.time_only:
        two_pass_times(torch, _build, k9, k10, a, card)
        phases(torch, _build, k9, k10, a, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where a block of K2 ``eva_single``'s tensor-core kernel spends its time,
and what its wrapper costs the host, on one GPU.

    python3 scripts/torch_eva_single_phases.py

builds ``csrc/eva_single.cu`` twice: as the repository's library and, with
``-DEVA_SINGLE_PHASES``, as a copy whose kernel records ``clock64`` at its
phase boundaries (both into ``build/kernels/``).  At each of K2's serving
shapes (bf16, B=128: the DeiT-tiny-p8 headline, PVTv2-B3's three EVA
stages, DeiT-tiny-p16) it prints one JSON line for each cluster size whose
padded rows fit a block, launching the library directly at that size:

* the mean SM cycles a block spends in each phase: ``stage`` (the token
  table, the q/k/v rows and the bias landing), ``barrier 1`` (waiting for
  the cluster's other blocks), ``sums`` (the owned chunks' q and k sums),
  ``dense`` (the adaptive Dense), ``summaries`` (LN, the members' logits,
  beta and the chunk rows written to every block), ``barrier 2`` and
  ``strips`` (the joint softmax);
* the blocks' mean lifetime (us, from the global timer) and how many ran at
  once on average;
* the library's time a call (CUDA events over 20 calls) at that cluster
  size, whether ``plan()`` picks it, and the output's max abs error against
  the plain version;

and one line a shape with the host's microseconds a call: ``plan()`` as
computed (``plan_us``) and as cached (``plan_cached_us``), and the whole
wrapper, ``eva_attention_single``, enqueued without waiting for the card
(``wrapper_us``).  Each line carries the card's name, power limit and SM
clock.  Exits non-zero without a GPU or outside a checkout.
"""
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

SHAPES = (("headline", (128, 28, 4, 3, 64)), ("pvt stage 1", (128, 56, 8, 2, 32)),
          ("pvt stage 2", (128, 28, 4, 4, 32)), ("pvt stage 3", (128, 14, 2, 10, 32)),
          ("p16", (128, 14, 2, 3, 64)))
PHASES = ("stage", "barrier 1", "sums", "dense", "summaries", "barrier 2", "strips")
MAX_BLOCKS = 16384  # kPhaseBlocks in csrc/eva_single.cu


def main() -> int:
    try:
        import torch
        from efficient_attention_torch.ops.kernels import _build
        from efficient_attention_torch.ops.kernels import eva_single as k2
    except ImportError as err:
        print(f"torch_eva_single_phases: run from a checkout ({err})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("torch_eva_single_phases: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / "libeva_single_phases.so"
    probes = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DEVA_SINGLE_PHASES", "-o", str(so),
         str(_build.CSRC_DIR / f"{k2.NAME}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build([k2.NAME])
    log, _ = probes.communicate()
    if probes.returncode != 0:
        raise RuntimeError(f"the probed build failed:\n{log}")
    real = k2._lib()
    probed = ctypes.CDLL(str(so))
    for fn in ("eva_single_mma_launch", "eva_single_error_string"):
        getattr(probed, fn).argtypes = getattr(real, fn).argtypes
        getattr(probed, fn).restype = getattr(real, fn).restype
    probed.eva_single_phases_copy.argtypes = [ctypes.c_void_p]
    probed.eva_single_phases_copy.restype = ctypes.c_int

    def cuda_ms(fn, iters=20):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def host_us(fn, iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        us = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
        return us

    def launcher(lib, args, bias, cluster):
        """The tensor-core kernel of ``lib`` at an explicit cluster size."""
        qkv, *weights = args[:9]
        nh, gw, ws, j, use_ln = args[10:]
        B, N, three_hd = qkv.shape
        d = three_hd // (3 * nh)
        out = torch.empty(B, N, nh * d, dtype=qkv.dtype, device=qkv.device)
        operands = (qkv.data_ptr(), out.data_ptr(), *(w.data_ptr() for w in weights),
                    bias.data_ptr(), B, N, gw, ws, j, nh, d, cluster, int(use_ln),
                    float(args[9]), torch.cuda.current_stream().cuda_stream)

        def run():
            rc = lib.eva_single_mma_launch(*operands)
            if rc != 0:
                raise RuntimeError(f"cluster {cluster}: "
                                   f"{lib.eva_single_error_string(rc).decode()}")
            return out
        return run

    for label, (B, g, j, nh, d) in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(7)
        r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
        args = (r(B, g * g, 3 * nh * d).to(torch.bfloat16), 0.2 * r(d, d), 0.1 * r(d),
                0.2 * r(d, d), 0.1 * r(d), 1 + 0.1 * r(d), 0.1 * r(d), 1 + 0.1 * r(d),
                0.1 * r(d), d ** -0.5, nh, g, 7, j, True)
        bias = 0.5 * r(nh, 49, 49)
        ref = k2.eva_attention_single_ref(*args, bias=bias).float()
        geo = (B, nh, g, g, 7, j, d, 2)
        picked = k2.plan(*geo)[0]
        n_win = (g // 7) ** 2
        for cs in k2.MMA_CLUSTER_SIZES:
            smem = k2.mma_smem_bytes(g, g, 7, j, d, cs) if n_win % cs == 0 else None
            if (smem is None or smem > k2.SMEM_LIMIT or n_win // cs * 49 > 4096
                    or cs * nh * B > MAX_BLOCKS):
                continue
            ms = cuda_ms(launcher(real, args, bias, cs))
            out = launcher(probed, args, bias, cs)()
            torch.cuda.synchronize()
            t = np.zeros((10, MAX_BLOCKS), np.uint64)
            if probed.eva_single_phases_copy(t.ctypes.data) != 0:
                raise RuntimeError("could not read the probes")
            t = t[:, :cs * nh * B].astype(np.int64)
            life_us = (t[9] - t[8]) / 1e3
            print(json.dumps({
                "shape": label, "cluster": cs, "plan": cs == picked, "smem_bytes": smem,
                "cycles": {p: float(np.mean(x)) for p, x in zip(PHASES, np.diff(t[:8], axis=0))},
                "block_us": float(life_us.mean()),
                "blocks_at_once": float(life_us.sum() / ((t[9].max() - t[8].min()) / 1e3)),
                "ms": ms, "max_abs_err": (out.float() - ref).abs().max().item(),
                "card": card}), flush=True)
        wrapper = lambda: k2.eva_attention_single(*args, bias=bias)  # noqa: E731
        for _ in range(3):
            wrapper()
        print(json.dumps({
            "shape": label, "host": {
                "plan_us": host_us(lambda: k2.plan.__wrapped__(*geo), 200),
                "plan_cached_us": host_us(lambda: k2.plan(*geo), 200),
                "wrapper_us": host_us(wrapper, 50)},
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

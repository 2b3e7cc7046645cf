"""Check and time the port's eva_1d kernel (K4) on one NVIDIA GPU.

Run from the root of a checkout:  python3 scripts/torch_eva_1d_check.py

Builds ``csrc/eva_1d.cu`` and prints its registers; then, for 64, 32, 16
and 8 query rows a block, holds the kernel against its plain version at
``chip_smoke.py``'s three K4 shapes in f32 and bf16 (at query rows that
are not padding) and times it, per call with CUDA events over 100 calls and
on the device with torch.profiler over 20; last, it serves one batch of 64
sentences of the WMT14 EN-DE recipe with ``cli.generate`` and prints the
encode and beam-loop seconds and the K4 launches.  Prints the card's name
and power limit first.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as S  # noqa: E402
from efficient_attention_torch.cli import generate  # noqa: E402
from efficient_attention_torch.ops.kernels import _build  # noqa: E402
from efficient_attention_torch.ops.kernels import eva_1d as K4  # noqa: E402


def device_ms(call, n=20):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if "eva_1d_kernel" in e.key) / n / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print("build seconds", _build.build([K4.NAME]))
    for line in (_build.BUILD_DIR / f"{K4.NAME}.log").read_text().splitlines():
        if "registers" in line:
            print(line.strip())
    results = {}
    for rows in (64, 32, 16, 8):
        K4.ROWS_PER_BLOCK = rows
        for label, (B, N, nh, d, ws, ext, C, bias_kind) in S.K4_CHECKS:
            for dtype_name in ("float32", "bfloat16"):
                qkv, rf, beta, mask, bias = S.k4_inputs(
                    B, N, nh, d, ws, ext, C, bias_kind, getattr(torch, dtype_name),
                    seed=80)
                geo = (d ** -0.5, nh, ws, ext)

                def call():
                    return K4.eva_attention_1d(qkv, rf, beta, mask, *geo, bias=bias)

                with torch.no_grad():
                    ref = K4.eva_1d_ref(qkv, rf, beta, mask, *geo, bias)
                    err = (call().float() - ref.float())[~mask].abs().max().item()
                    ms = S.cuda_ms(call, 100)
                    dev = device_ms(call)
                results[f"{rows} rows, {label} {dtype_name}"] = {
                    "ms_a_call": ms, "device_ms": dev, "max_abs_err": err}
                print(rows, label, dtype_name, "a call", ms, "device", dev,
                      "err", err, flush=True)
    print(json.dumps(results))
    K4.ROWS_PER_BLOCK = 16
    argv = S.MT_ARGV[:-4] + ["--gen-subset-size", "64", "--device", "cuda"]
    K4.LAUNCHES = 0
    t0 = time.perf_counter()
    res = generate.cli_main(argv)
    torch.cuda.synchronize()
    print(f"generate 64 sentences {time.perf_counter() - t0:.3f} s; K4 launches "
          f"{K4.LAUNCHES}; encode {res['encode_s']:.3f} s, beam loop "
          f"{res['beam_s']:.3f} s, {res['decode_steps']} decode steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

The main path is the eval forward of DeiT-tiny-p8 (``evit_tiny_p8``, 224 px,
28x28 tokens, dim 192, 3 heads, 12 blocks) with 2-D EVA (window 7, 49
landmarks, learned RPE, ``adaptive_proj='default'``), random weights from a
seed.  Phases, each raising on failure:

1. build: compile every kernel of the path with nvcc (one process per
   source, all at once) and print the seconds;
2. kernels against their plain versions on the card: ``eva_single`` at the
   main path's shape in bf16 and f32, and at the golden geometry in f32;
3. the serving path: the port's ``cli.train_vit --eval`` in-process at batch
   128 in bf16 on synthetic images, with the kernels' launch counts set to 0
   just before and read just after, then the f32 logits of the kernel path
   against the port's eager path (``impl='xla'``) on the card;
4. timings with CUDA events (kernel, plain version, forward images/s);
5. the kernels line, the card line, and the result line, last.

It exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
import copy
import json
import math
import subprocess
import sys
import time

MAIN_ARGV = [
    "--model", "evit_tiny_p8", "--attn-name", "eva",
    "--attn-window-size", "7", "--attn-num-landmarks", "49",
    "--attn-attn-2d", "--attn-use-rpe", "--attn-adaptive-proj", "default",
    "--input-size", "224", "--batch-size", "128", "--seed", "0",
    "--device", "cuda",
]
HBM_BYTES_PER_S = 3.35e12          # H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# tolerances of kernel vs plain version on the same card inputs: f32 differs
# only in summation order; bf16 also by one rounding of outputs below 4,
# whose bf16 spacing is at most 2**-6
TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2 ** -6}
# f32 logits, kernel path vs eager path, through 12 blocks
LOGITS_TOL = 1e-4


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k2_inputs(B, g, ws, j, nh, d, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    qkv = r(B, g * g, 3 * nh * d).to(dtype)
    weights = [0.2 * r(d, d), 0.1 * r(d), 0.2 * r(d, d), 0.1 * r(d),
               1 + 0.1 * r(d), 0.1 * r(d), 1 + 0.1 * r(d), 0.1 * r(d)]
    bias = 0.5 * r(nh, ws * ws, ws * ws)
    return (qkv, *weights, d ** -0.5, nh, g, ws, j, True), bias


def k2_bound(args, bias, out):
    """Least time for the function at these inputs: every input byte read
    once and the output written once over HBM, or its operations at the peak
    of the inputs' type, whichever is larger."""
    qkv, *weights = args[:9]
    nh, gw, ws, j = args[10:14]
    B, N, three_hd = qkv.shape
    d = three_hd // (3 * nh)
    S, C = ws * ws, (N // gw // j) * (gw // j)
    moved = (qkv.numel() * qkv.element_size() + out.numel() * out.element_size()
             + sum(w.numel() * 4 for w in weights) + bias.numel() * 4)
    flops = B * nh * (4 * N * (S + C) * d      # q.k and p.v over S + C columns
                      + 4 * N * d               # chunk sums of q and k
                      + 4 * C * d * d           # the two adaptive Dense
                      + 6 * N * d)              # <mu,k>, |k|^2, p.v in chunks
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(qkv.dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from efficient_attention_torch.cli import train_vit
        from efficient_attention_torch.ops.kernels import _build
        from efficient_attention_torch.ops.kernels import eva_single as k2
    except ImportError as err:
        print(f"chip_smoke: run from the root of a checkout ({err})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build
    t0 = time.perf_counter()
    built = _build.build([k2.NAME])
    log(f"[build] {json.dumps(built)} in {time.perf_counter() - t0:.2f} s")
    for line in (_build.BUILD_DIR / f"{k2.NAME}.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    lib_smem = k2._lib().eva_single_smem_bytes(98, 64, 2, 49, 7, 7)
    if lib_smem != k2.smem_bytes(98, 64, 2, 49, 7, 7):
        raise AssertionError(f"gate's smem layout {k2.smem_bytes(98, 64, 2, 49, 7, 7)}"
                             f" != kernel's {lib_smem}")

    # ---- 2. kernels against their plain versions
    errors = {}
    for label, geo, dtype in (
            ("main bf16", (128, 28, 7, 4, 3, 64), torch.bfloat16),
            ("main f32", (128, 28, 7, 4, 3, 64), torch.float32),
            ("golden f32", (2, 14, 7, 2, 4, 12), torch.float32)):
        args, bias = k2_inputs(*geo, dtype, seed=len(errors))
        out = k2.eva_attention_single(*args, bias=bias)
        torch.cuda.synchronize()
        ref = k2.eva_attention_single_ref(*args, bias=bias)
        if out.shape != ref.shape or out.dtype != ref.dtype:
            raise AssertionError(f"{label}: {out.shape} {out.dtype} vs "
                                 f"{ref.shape} {ref.dtype}")
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        tol = TOL[str(dtype)]
        log(f"[k2 vs plain] {label}: max abs err {err:.3e} (tol {tol:.1e}), "
            f"max rel err {rel:.3e}")
        if not err <= tol:
            raise AssertionError(f"eva_single {label}: max abs err {err} > {tol}")
        errors[label] = err

    # ---- 3. the serving path, counts set to 0 just before and read just after
    k2.LAUNCHES = 0
    t0 = time.perf_counter()
    stats = train_vit.cli_main(MAIN_ARGV + ["--eval", "--bf16"])
    torch.cuda.synchronize()
    launches = k2.LAUNCHES
    log(f"[serve] eval {json.dumps(stats)} in {time.perf_counter() - t0:.2f} s;"
        f" eva_single launches {launches}")
    if not all(math.isfinite(stats[k]) for k in ("acc1", "acc5", "loss")):
        raise AssertionError(f"non-finite eval stats {stats}")
    if stats["batches"] != 4 or launches != 12 * stats["batches"]:
        raise AssertionError(f"{launches} eva_single launches for "
                             f"{stats['batches']} batches of a 12-block model")
    # f32 logits: the kernel path against the eager path on the card
    args = train_vit.parse_args(MAIN_ARGV + ["--eval"])
    model = train_vit.build_model(args).cuda()
    eager = copy.deepcopy(model)
    for blk in eager.blocks:
        blk.attn.impl = "xla"
    from efficient_attention_torch.data.imagenet import SyntheticImageDataset

    ds = SyntheticImageDataset(8, 224, 1000, train=False)
    x = torch.stack([torch.from_numpy(ds.load(i)[0]) for i in range(8)]).cuda()
    with torch.no_grad():
        logits, logits_eager = model(x), eager(x)
    torch.cuda.synchronize()
    if logits.shape != (8, 1000) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits {logits.shape}")
    lerr = (logits - logits_eager).abs().max().item()
    lscale = logits_eager.abs().max().item()
    log(f"[serve] f32 logits kernel path vs eager path: max abs err {lerr:.3e}"
        f" (tol {LOGITS_TOL:.0e}), max |logit| {lscale:.3e}")
    if not lerr <= LOGITS_TOL:
        raise AssertionError(f"f32 logits differ by {lerr}")

    # ---- 4. timings
    args, bias = k2_inputs(128, 28, 7, 4, 3, 64, torch.bfloat16, seed=7)
    out = k2.eva_attention_single(*args, bias=bias)
    k2_ms = cuda_ms(lambda: k2.eva_attention_single(*args, bias=bias), 20)
    plain_ms = cuda_ms(lambda: k2.eva_attention_single_ref(*args, bias=bias), 5)
    bound_ms, bound_by = k2_bound(args, bias, out)
    log(f"[time] eva_single main shape bf16: {k2_ms:.4f} ms, plain version "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); {card}")
    tp_args = train_vit.parse_args(MAIN_ARGV + ["--throughput", "--bf16"])
    device, bf16 = torch.device("cuda"), torch.bfloat16
    kernel_model = train_vit.build_model(tp_args).to(device, bf16)
    eager_model = copy.deepcopy(kernel_model)
    for blk in eager_model.blocks:
        blk.attn.impl = "xla"
    sm_args = train_vit.parse_args(
        ["--model", "evit_tiny_p8", "--attn-name", "softmax", "--input-size",
         "224", "--batch-size", "128", "--throughput", "--bf16"])
    softmax_model = train_vit.build_model(sm_args).to(device, bf16)
    rates = {}
    for name, m in (("eva kernel path", kernel_model),
                    ("eva eager path", eager_model),
                    ("softmax", softmax_model),
                    ("eva kernel path (again)", kernel_model)):
        rates[name] = train_vit.compute_throughput(m, tp_args, device, bf16)[
            "images_per_sec"]
    fwd_ms = 128e3 / rates["eva kernel path"]
    log(f"[time] forward B=128 bf16 images/s: {json.dumps(rates)}; "
        f"eva_single share of the kernel-path forward "
        f"{12 * k2_ms / fwd_ms:.3f} (12 x {k2_ms:.4f} ms of {fwd_ms:.3f} ms);"
        f" {card}")

    # ---- 5. the kernels line, the card line, the result
    kernels = [{
        "name": k2.NAME, "route": "cuda", "source": k2.SOURCE,
        "replaces": k2.REPLACES, "launches": launches,
        "max_abs_err": errors["main bf16"], "ms": k2_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

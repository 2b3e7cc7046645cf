#!/usr/bin/env python3
"""MT serving of several checkouts of the port in turns, on one GPU.

    python3 scripts/torch_mt_serve_turns.py DIR [DIR ...] [--runs N]

serves ``chip_smoke.py``'s MT cell (its ``MT_ARGV``: the WMT14 EN-DE recipe
in f32, 256 dummy sentences in batches of 64, beam 4, lenpen 0.6, random
weights from the seed) with the port of each checkout DIR, in the order
given (for a comparison: old, new, new, old), each in a process of its own
that imports the port and ``chip_smoke.py`` from DIR: one pass of
``cli.generate.translate`` to warm up (it builds K4), then ``--runs`` timed
passes, each timed as ``chip_smoke.py``'s phase 5 times its passes (the
host's clock around the pass and a synchronize).  Prints one JSON line a
checkout, each pass's sentences/s, hypothesis tokens/s, encode and
beam-loop seconds and BLEU, with the card's name and power limit as
nvidia-smi reads them.  TF32 is off, as in ``chip_smoke.py``.  Exits
non-zero without a GPU or where a DIR is not a checkout.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def serve(root: str, runs: int) -> int:
    """The passes of one checkout, printed as one JSON line."""
    sys.path.insert(0, root)
    try:
        import torch
        import chip_smoke as S
        from efficient_attention_torch.cli import generate
    except ImportError as err:
        print(f"torch_mt_serve_turns: {root} is not a checkout ({err})",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("torch_mt_serve_turns: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    args = generate.parse_args(S.MT_ARGV)
    model = generate.build_model(args, S.MT_VOCAB, S.MT_VOCAB).to(device).eval()
    generate.translate(args, model, device)
    passes = []
    for _ in range(runs):
        t0 = time.perf_counter()
        r = generate.translate(args, model, device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        passes.append({"sentences_per_s": r["sentences"] / wall,
                       "hypothesis_tokens_per_s": r["hypothesis_tokens"] / wall,
                       "encode_s": r["encode_s"], "beam_s": r["beam_s"],
                       "wall_s": wall, "bleu": r["bleu"]})
    print(json.dumps({"root": root, "passes": passes}), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("roots", nargs="+", metavar="DIR")
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    if args.child:
        return serve(roots[0], args.runs)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError) as err:
        print(f"torch_mt_serve_turns: no GPU ({err})", file=sys.stderr)
        return 1
    for turn, root in enumerate(roots):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root,
             "--runs", str(args.runs)], capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        rates = [p["sentences_per_s"] for p in line["passes"]]
        print(json.dumps(dict(line, turn=turn, card=card,
                              sentences_per_s=[min(rates), max(rates)])),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

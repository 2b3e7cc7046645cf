"""BLEU of a hypothesis file against a reference file: the port's
``fairseq_cli/score.py``.

Counterpart of ``efficient_attention_tpu/cli/score.py``, with its flags:
corpus BLEU over whitespace words, each mapped to an id by
``WordIdMapper``; it stops, scoring nothing, where the two files' line
counts differ.  ``--metric chrf|wer`` is not ported yet.

Example (the last step of ``scripts/torch_compound_split_bleu.sh``):

  python3 -m efficient_attention_torch.cli.score --sys gen.out.sys --ref gen.out.ref
"""
from __future__ import annotations

import argparse

from efficient_attention_torch.scoring.bleu import BleuScorer, WordIdMapper


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("eatorch-score")
    p.add_argument("--sys", "-s", required=True, help="system output file")
    p.add_argument("--ref", "-r", required=True, help="reference file")
    p.add_argument("--order", type=int, default=4)
    p.add_argument("--metric", default="bleu", choices=["bleu", "chrf", "wer"])
    return p


def cli_main(argv=None) -> float:
    args = build_parser().parse_args(argv)
    if args.metric != "bleu":
        raise NotImplementedError(
            f"--metric {args.metric} is not ported yet; see ROADMAP.md Queue 1, "
            "item 6 (scoring/{chrf,wer}.py, ops/edit_distance.py)")
    with open(args.sys, encoding="utf-8") as f:
        hyps = [line.rstrip("\n") for line in f]
    with open(args.ref, encoding="utf-8") as f:
        refs = [line.rstrip("\n") for line in f]
    if len(hyps) != len(refs):
        # a cut generation run must not score as a plausible prefix
        raise SystemExit(f"line count mismatch: {args.sys} has {len(hyps)} lines, "
                         f"{args.ref} has {len(refs)}")
    ids = WordIdMapper()
    scorer = BleuScorer()
    for hyp, ref in zip(hyps, refs):
        scorer.add(ids(ref), ids(hyp))
    print(scorer.result_string(args.order))
    return scorer.score(args.order)


if __name__ == "__main__":
    cli_main()

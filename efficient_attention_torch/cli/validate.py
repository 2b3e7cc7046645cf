"""Validation-loss CLI of the port: ``fairseq_cli/validate.py``.

Counterpart of ``efficient_attention_tpu/cli/validate.py``, with its flags.
``--task lm`` (the default) scores the ``valid`` split through
``cli.eval_lm``, whose flags it takes.  ``--task mt`` loads the
translation model of ``cli.train_mt``'s flags from ``--path`` (the newest
checkpoint there, or the average of the newest ``--num-avg-checkpoints``,
through ``cli.generate``'s loader; without ``--path`` the weights drawn from
``--seed``) and sums the label-smoothed loss, the NLL and the target
tokens over the first ``--valid-subset-size`` pairs of the split, in
batches of 16; its last line is ``{"valid_loss", "valid_nll",
"valid_ppl", "tokens"}``, losses a token in nats.  With EVA in the
encoder, every encoder layer runs the ``eva_1d`` kernel (K4) where its gate
holds.  The model runs on ``--device`` (default ``cuda``) in float32.

The split is ``--valid-subset`` (fairseq's flag, default ``valid``): the
JAX CLI reads its pairs through ``load_pairs(args)``, whose split defaults
to ``train``, so it reports a training-set loss (ROADMAP.md Queue 3); pass
``--valid-subset train`` to compute what it computes.  On ``--dummy-data``
any split but ``train`` is the 64 validation pairs of ``cli.train_mt``.

Examples:

  python -m efficient_attention_torch.cli.validate --task mt \\
      --data data-bin/wmt14_en_de --path checkpoints/wmt14/ckpt \\
      --num-avg-checkpoints 10 --attn-name-encoder eva ... \\
      --valid-subset-size 3000
  python -m efficient_attention_torch.cli.validate --task lm \\
      --arch transformer_lm_wiki103 --config configs/wikitext103_causal_eva.yaml \\
      --data data-bin/wikitext-103 --checkpoint checkpoints/wiki103/ckpt
"""
from __future__ import annotations

import argparse
import json
import math

import torch

BATCH = 16


def parse_mt_args(argv=None):
    """``cli.train_mt``'s flags, the attention flags of the names given,
    and validate's own."""
    from efficient_attention_torch import AttentionFactory, NestedNamespace
    from efficient_attention_torch.cli.train_mt import build_parser

    parser = build_parser()
    parser.add_argument("--path", default=None, help="checkpoint dir")
    parser.add_argument("--num-avg-checkpoints", type=int, default=1)
    parser.add_argument("--valid-subset", default="valid",
                        help="the split of --data to score (fairseq "
                             "--valid-subset)")
    parser.add_argument("--valid-subset-size", type=int, default=64)
    known, _ = parser.parse_known_args(argv)
    parser = AttentionFactory.add_attn_specific_args(
        parser, known.attn_name_encoder, struct_name="attn_args_encoder",
        prefix="encoder-attn")
    parser = AttentionFactory.add_attn_specific_args(
        parser, known.attn_name_decoder, struct_name="attn_args_decoder",
        prefix="decoder-attn")
    parser.add_argument("--help", action="help")
    return parser.parse_args(argv, namespace=NestedNamespace())


@torch.no_grad()
def validate_mt(args) -> dict:
    """The summed label-smoothed loss, NLL and target tokens of the model
    over the first ``--valid-subset-size`` pairs, as JAX's line."""
    from efficient_attention_torch.cli import train_mt
    from efficient_attention_torch.cli.generate import load_params
    from efficient_attention_torch.data.text_data import collate_tokens
    from efficient_attention_torch.training.criterions import label_smoothed_nll_loss

    train_mt.check_ported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    src, tgt, sd, td = train_mt.load_pairs(args, split=args.valid_subset)
    model = train_mt.build_model(args, *train_mt.vocab_sizes(args, sd, td))
    params = load_params(args)
    if params is not None:
        model.load_state_dict(params, strict=True)
    model = model.to(device).eval()
    total_loss = total_nll = total_tok = 0.0
    ids = list(range(min(len(src), args.valid_subset_size)))
    for i in range(0, len(ids), BATCH):
        chunk = ids[i:i + BATCH]
        src_b = collate_tokens([src[j] for j in chunk], pad_idx=1)
        tgt_b = collate_tokens([tgt[j] for j in chunk], pad_idx=1)
        prev_b = collate_tokens([tgt[j] for j in chunk], pad_idx=1,
                                move_eos_to_beginning=True)
        logits = model(torch.from_numpy(src_b).to(device),
                       torch.from_numpy(prev_b).to(device))
        loss, nll, n = label_smoothed_nll_loss(
            logits, torch.from_numpy(tgt_b).to(device), args.label_smoothing,
            pad_idx=1)
        total_loss += float(loss)
        total_nll += float(nll)
        total_tok += float(n)
    tokens = max(total_tok, 1)
    result = {"valid_loss": total_loss / tokens,
              "valid_nll": total_nll / tokens,
              "valid_ppl": math.exp(min(total_nll / tokens, 30)),
              "tokens": total_tok}
    print(json.dumps(result))
    return result


def cli_main(argv=None):
    base = argparse.ArgumentParser("validate", add_help=False)
    base.add_argument("--task", choices=["lm", "mt"], default="lm")
    known, rest = base.parse_known_args(argv)
    if known.task == "lm":
        from efficient_attention_torch.cli import eval_lm

        args = eval_lm.parse_args(rest)
        args.split = "valid"
        return eval_lm.main(args)
    return validate_mt(parse_mt_args(rest))


if __name__ == "__main__":
    cli_main()

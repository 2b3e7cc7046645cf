"""LM perplexity CLI of the port, with sliding context windows.

Counterpart of ``efficient_attention_tpu/cli/eval_lm.py``
(``fairseq_cli/eval_lm.py``): scores a split of a binarized corpus
(``--data``; dummy tokens from ``--seed`` otherwise) at ``--context-window
c`` (the wiki103 protocol evaluates at 0, 256 and 480, ``main.sh:84-124``).
The model is ``cli.train_lm``'s, built from the same flags and loaded,
parameters only, from the newest checkpoint in ``--checkpoint`` (a
``<save-dir>/ckpt`` of ``cli.train_lm``), pruned to
``--decoder-layers-to-keep`` where given; without ``--checkpoint`` its
weights are random from ``--seed``.  Blocks of ``--tokens-per-sample + 1``
tokens go in batches of ``--eval-max-batch``; ``--softmax-batch`` bounds
the live full-softmax logits to that many tokens.  The decoder takes its
padding mask, as JAX's ``eval_lm`` builds it, so causal EVA runs its eager
path and no kernel launches.  The model runs on ``--device`` (default
``cuda``; no fallback to the CPU).  The last line is one JSON object:
``nll_loss_base_e``, ``loss_base_2``, ``ppl``, ``tokens``,
``context_window``.

Example:

  python -m efficient_attention_torch.cli.eval_lm \\
      --arch transformer_lm_wiki103 --config configs/wikitext103_causal_eva.yaml \\
      --data data-bin/wikitext-103 --checkpoint checkpoints/wiki103/ckpt \\
      --context-window 480
"""
from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from efficient_attention_torch.cli import train_lm


def parse_args(argv=None):
    """``cli.train_lm``'s flags (with its YAML config and ``--arch``
    presets, so one command line serves both CLIs) and eval_lm's own."""
    parser = train_lm.build_parser()
    parser.add_argument("--context-window", type=int, default=0)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--split", default="test")
    parser.add_argument("--eval-max-batch", type=int, default=32)
    parser.add_argument("--softmax-batch", type=int, default=0,
                        help="most tokens whose full-vocabulary softmax is "
                             "live at once (0: no bound; the adaptive "
                             "softmax streams the vocabulary anyway)")
    parser.add_argument("--output-word-probs", action="store_true",
                        help="print each scored word's log-probability")
    parser.add_argument("--output-word-stats", action="store_true",
                        help="print each word's count and mean log-probability")
    return train_lm.parse_args(argv, parser)


def load_eval_corpus(args):
    """``(tokens, dictionary or None, vocab size)`` of ``--split``: dummy
    tokens from ``--seed`` (``--max-tokens`` x 8) without ``--data``."""
    if args.dummy_data or not args.data:
        rng = np.random.default_rng(args.seed + 1)
        return (rng.integers(4, args.dummy_vocab, size=args.max_tokens * 8)
                .astype(np.int64), None, args.dummy_vocab)
    from efficient_attention_torch.data.dictionary import Dictionary
    from efficient_attention_torch.data.indexed_dataset import MMapIndexedDataset

    d = Dictionary.load(os.path.join(args.data, "dict.txt"))
    ds = MMapIndexedDataset(os.path.join(args.data, args.split))
    return ds.flat_tokens(), d, len(d)


def main(args) -> dict:
    from efficient_attention_torch.data.lm_context_window import context_window_blocks
    from efficient_attention_torch.training.checkpoint import (
        CheckpointManager,
        parse_layers_to_keep,
        prune_layer_params,
    )
    from efficient_attention_torch.training.lm_steps import (
        make_lm_eval_step,
        make_lm_token_nll_step,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    tokens, dictionary, vocab_size = load_eval_corpus(args)
    model = train_lm.build_model(args, vocab_size)
    if args.checkpoint:
        restored = CheckpointManager(args.checkpoint).restore_params()
        if restored is not None:
            step_loaded, params = restored
            print(f"| loaded checkpoint step {step_loaded}")
            keep = parse_layers_to_keep(args.decoder_layers_to_keep)
            if keep:
                params = prune_layer_params(params, keep, "decoder")
                print(f"| pruned decoder to layers {keep}")
            model.load_state_dict(params, strict=True)
    model = model.to(device).eval()

    use_adaptive = model.decoder.adaptive_softmax is not None
    softmax_chunk = (int(args.softmax_batch) if args.softmax_batch and not use_adaptive
                     and args.softmax_batch < 2 ** 30 else None)
    eval_step = make_lm_eval_step(use_adaptive=use_adaptive, softmax_chunk=softmax_chunk)
    want_words = args.output_word_probs or args.output_word_stats
    token_step = (make_lm_token_nll_step(use_adaptive=use_adaptive,
                                         softmax_chunk=softmax_chunk)
                  if want_words else None)
    word_stats = {}
    sample_idx = 0
    total_nll, total_tok = 0.0, 0.0

    def token_str(t):
        return dictionary[int(t)] if dictionary is not None else str(int(t))

    def flush(blocks, masks):
        nonlocal total_nll, total_tok, sample_idx
        arr, msk = np.stack(blocks), np.stack(masks)
        # --softmax-batch also bounds the rows a call scores (fairseq
        # SequenceScorer's batch_for_softmax)
        rows = arr.shape[0]
        if args.softmax_batch and not use_adaptive:
            rows = max(1, args.softmax_batch // max(arr.shape[1] - 1, 1))
        for lo in range(0, arr.shape[0], rows):
            a = torch.from_numpy(arr[lo:lo + rows]).to(device)
            sm = torch.from_numpy(msk[lo:lo + rows, 1:]).to(device)
            tok, tgt = a[:, :-1], a[:, 1:]
            nll, n = eval_step(model, tok, tgt, sm)
            total_nll += float(nll)
            total_tok += float(n)
            if token_step is None:
                continue
            tnll, tmask = (x.cpu().numpy() for x in token_step(model, tok, tgt, sm))
            rows_np = arr[lo:lo + rows]
            for r in range(rows_np.shape[0]):
                pieces = []
                for t in np.flatnonzero(tmask[r]):
                    w = token_str(rows_np[r, 1 + t])
                    lp = -float(tnll[r, t])
                    if args.output_word_probs:
                        pieces.append(f"{w} [{lp:.4f}]")
                    cnt, tot = word_stats.get(w, (0, 0.0))
                    word_stats[w] = (cnt + 1, tot + lp)
                if args.output_word_probs and pieces:
                    print(f"W-{sample_idx}\t" + " ".join(pieces))
                sample_idx += 1

    # the blocks carry one token more than a sample: the inputs and their
    # next-token targets (fairseq eval_lm.py:244-246)
    blocks, masks = [], []
    for block, mask in context_window_blocks(tokens, args.tokens_per_sample + 1,
                                             args.context_window, pad_idx=1):
        blocks.append(block)
        masks.append(mask)
        if len(blocks) == args.eval_max_batch:
            flush(blocks, masks)
            blocks, masks = [], []
    if blocks:
        flush(blocks, masks)
    nll = total_nll / max(total_tok, 1)
    result = {"nll_loss_base_e": nll, "loss_base_2": nll / math.log(2),
              "ppl": math.exp(min(nll, 30)), "tokens": total_tok,
              "context_window": args.context_window}
    if args.output_word_stats:
        # fairseq's WordStat dump: word, count, mean log-prob, by count
        for w, (cnt, tot) in sorted(word_stats.items(), key=lambda kv: -kv[1][0]):
            print(f"{w} | count {cnt} | avg_log_prob {tot / cnt:.4f}")
    print(f"| Evaluated {int(total_tok)} tokens, context window "
          f"{args.context_window}: loss {nll:.4f}, ppl {result['ppl']:.2f}")
    print(json.dumps(result))
    return result


def cli_main(argv=None):
    return main(parse_args(argv))


if __name__ == "__main__":
    cli_main()

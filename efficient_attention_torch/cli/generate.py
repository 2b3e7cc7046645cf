"""Beam-search translation and BLEU: the port's ``fairseq_cli/generate.py``.

Counterpart of ``efficient_attention_tpu/cli/generate.py``, with its flags.
Each batch of ``--gen-batch`` source sentences (the first
``--gen-subset-size`` of the split) is padded to a multiple of 16, encoded
once, repeated over the beams, and decoded by ``SequenceGenerator`` one
token a step, with every decoder layer's cross-attention K/V projected once
into its decode state (fairseq ``static_kv``).  The 1-best hypothesis is
cut after its first eos and scored by corpus BLEU on token ids; the last
line printed is ``{"bleu": ..., "sentences": ...}``.

The model runs on ``--device`` (default ``cuda``), on one device, in
float32 with random weights drawn from ``--seed`` (as the JAX CLI, which
inits f32 parameters and never casts them), on the ``--dummy-data`` pairs
of ``cli.train_mt``.  With EVA in the encoder at eval, every encoder layer
runs the ``eva_1d`` kernel (K4) where its gate holds.  Flags whose module is
not ported yet raise ``NotImplementedError`` naming their ROADMAP.md item.

Example (the WMT14 EN-DE recipe's model, ``main.sh:87-123``):

  python -m efficient_attention_torch.cli.generate --dummy-data \\
      --dummy-vocab 32768 --attn-name-encoder eva \\
      --encoder-attn-window-size 8 --encoder-attn-num-landmarks 8 \\
      --encoder-attn-overlap-window --encoder-attn-use-t5-rpe \\
      --encoder-attn-adaptive-proj no-ln --attn-name-decoder causal_eva \\
      --decoder-attn-window-size 16 --decoder-attn-chunk-size 8 \\
      --decoder-attn-adaptive-proj qk --decoder-attn-causal \\
      --share-all-embeddings --beam 4 --lenpen 0.6 --gen-batch 64 \\
      --gen-subset-size 256
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from efficient_attention_torch.cli.train_mt import build_model, build_parser, load_pairs


def parse_args(argv=None):
    from efficient_attention_torch import AttentionFactory, NestedNamespace

    parser = build_parser()
    parser.add_argument("--path", default=None, help="checkpoint dir")
    parser.add_argument("--beam", type=int, default=4)
    parser.add_argument("--lenpen", type=float, default=0.6)
    parser.add_argument("--max-len-b", type=int, default=64)
    parser.add_argument("--max-len-a", type=float, default=0.0,
                        help="per-sentence max output length = "
                             "max-len-a*src_len + max-len-b")
    parser.add_argument("--min-len", type=int, default=1,
                        help="minimum output length (eos banned below)")
    parser.add_argument("--match-source-len", action="store_true",
                        help="force each output to its source's length")
    parser.add_argument("--input", default="-")
    parser.add_argument("--buffer-size", type=int, default=0)
    parser.add_argument("--print-alignment", nargs="?", const="hard",
                        default=None, choices=["hard", "soft"])
    parser.add_argument("--lm-path", default=None)
    parser.add_argument("--lm-config", default=None)
    parser.add_argument("--lm-weight", type=float, default=0.0)
    parser.add_argument("--scoring", default="bleu",
                        choices=["bleu", "chrf", "wer"])
    parser.add_argument("--nbest", type=int, default=1)
    parser.add_argument("--unnormalized", action="store_true",
                        help="do not length-normalize hypothesis scores")
    parser.add_argument("--unkpen", type=float, default=0.0,
                        help="per-step penalty subtracted from the <unk> "
                             "log-prob")
    parser.add_argument("--no-repeat-ngram-size", type=int, default=0)
    parser.add_argument("--score-reference", action="store_true")
    parser.add_argument("--sampling", action="store_true")
    parser.add_argument("--sampling-topk", type=int, default=-1)
    parser.add_argument("--sampling-topp", type=float, default=-1.0)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--gen-batch", type=int, default=8)
    parser.add_argument("--num-avg-checkpoints", type=int, default=1)
    parser.add_argument("--gen-subset-size", type=int, default=32)
    parser.add_argument("--diverse-beam-groups", type=int, default=-1)
    parser.add_argument("--diverse-beam-strength", type=float, default=0.5)
    parser.add_argument("--diversity-rate", type=float, default=-1.0)
    parser.add_argument("--prefix-size", type=int, default=0)
    parser.add_argument("--constraints", action="store_true")
    parser.add_argument("--bpe", default=None)
    parser.add_argument("--bpe-codes", default=None)
    parser.add_argument("--gpt2-encoder-json", default=None)
    parser.add_argument("--gpt2-vocab-bpe", default=None)
    parser.add_argument("--sentencepiece-model", default=None)
    parser.add_argument("--tokenizer", default=None)
    parser.add_argument("--moses-no-dash-splits", action="store_true",
                        default=False)
    parser.add_argument("--moses-no-escape", action="store_true", default=True)
    parser.add_argument("--results-path", default=None)
    parser.add_argument("--remove-bpe", nargs="?", const="@@ ", default=None)
    known, _ = parser.parse_known_args(argv)
    parser = AttentionFactory.add_attn_specific_args(
        parser, known.attn_name_encoder, struct_name="attn_args_encoder",
        prefix="encoder-attn")
    parser = AttentionFactory.add_attn_specific_args(
        parser, known.attn_name_decoder, struct_name="attn_args_decoder",
        prefix="decoder-attn")
    parser.add_argument("--help", action="help")
    return parser.parse_args(argv, namespace=NestedNamespace())


def check_ported(args) -> None:
    """Raise ``NotImplementedError`` for every flag set to something whose
    module is not ported yet, naming its ROADMAP.md item."""
    item6 = "Queue 1, item 6"
    queued = [
        (args.path is not None, "--path (checkpoints)", "Queue 1, item 8"),
        (args.data is not None and not args.dummy_data, "--data",
         "Queue 1, item 5 (data/{dictionary,indexed_dataset}.py)"),
        (args.lm_path is not None, "--lm-path (shallow fusion)", item6),
        (args.sampling, "--sampling", item6),
        (args.diverse_beam_groups > 1, "--diverse-beam-groups", item6),
        (args.diversity_rate > 0, "--diversity-rate", item6),
        (args.prefix_size > 0, "--prefix-size", item6),
        (args.constraints, "--constraints", item6),
        (args.no_repeat_ngram_size > 0, "--no-repeat-ngram-size", item6),
        (args.print_alignment is not None, "--print-alignment", item6),
        (args.score_reference, "--score-reference", item6),
        (args.scoring != "bleu", f"--scoring {args.scoring}", item6),
        (args.bpe is not None or args.tokenizer is not None,
         "--bpe/--tokenizer (data/encoders.py)", item6),
        (args.results_path is not None, "--results-path", item6),
    ]
    for unported, flag, item in queued:
        if unported:
            raise NotImplementedError(f"{flag} is not ported yet; see ROADMAP.md {item}")


def generation_batches(args, src):
    """Per batch of source ids: ``(ids, src_b [B, S] int64, src_lens [B],
    buf_len, len_kw)``.  The source is padded to a multiple of 16 and the
    output buffer ``max_len_a * S + max_len_b`` rounded up to one (JAX
    ``cli/generate.py:303-331``), so batches recur in shape."""
    from efficient_attention_torch.data.text_data import collate_tokens

    ids = list(range(min(len(src), args.gen_subset_size)))
    for i in range(0, len(ids), args.gen_batch):
        chunk = ids[i: i + args.gen_batch]
        src_pad_to = max(len(src[j]) for j in chunk)
        src_pad_to += (-src_pad_to) % 16
        src_b = collate_tokens([src[j] for j in chunk], pad_idx=1,
                               pad_to_length=src_pad_to)
        src_lens = (src_b != 1).sum(axis=1)
        if args.match_source_len:
            buf_len = int(src_lens.max()) + 1
            len_kw = dict(min_len=0, min_len_a=1.0, max_len_a=1.0, max_len_b=0)
        else:
            buf_len = int(args.max_len_a * src_b.shape[1]) + args.max_len_b
            len_kw = dict(min_len=args.min_len, max_len_a=args.max_len_a,
                          max_len_b=args.max_len_b if args.max_len_a > 0 else None)
        buf_len += (-buf_len) % 16
        yield chunk, src_b, src_lens, buf_len, len_kw


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def translate(args, model, device: torch.device) -> dict:
    """Generate and score every batch with ``model`` (in eval mode on
    ``device``).  Returns the result line's numbers, the 1-best hypotheses,
    the decode steps run and the seconds spent encoding and in the beam
    loop."""
    from efficient_attention_torch.generation.beam_search import SequenceGenerator
    from efficient_attention_torch.scoring.bleu import BleuScorer

    src, tgt, _, _ = load_pairs(args)
    vocab = args.dummy_vocab
    scorer = BleuScorer()
    K = args.beam
    hyps, n_tokens, n_steps = [], 0, 0
    encode_s = beam_s = 0.0
    for chunk, src_b, src_lens, buf_len, len_kw in generation_batches(args, src):
        B = src_b.shape[0]
        t0 = time.perf_counter()
        enc_out, enc_pad = model.encode(torch.from_numpy(src_b).to(device))
        # the encoder output repeated over the beams
        enc_out_k = enc_out.repeat_interleave(K, dim=0)
        enc_pad_k = enc_pad.repeat_interleave(K, dim=0)
        _sync(device)
        t1 = time.perf_counter()

        def step_fn(states, tokens, step):
            logits, states = model.decode_step(states, tokens, step, None, enc_pad_k)
            return logits[:, 0], states

        def init_cache(bk, max_len):
            return model.init_decode_state(bk, max_len, torch.float32, device,
                                           enc_out=enc_out_k)

        gen = SequenceGenerator(
            step_fn, init_cache, vocab_size=vocab, beam_size=K, max_len=buf_len,
            len_penalty=0.0 if args.unnormalized else args.lenpen,
            unk_penalty=args.unkpen, **len_kw)
        tokens, _ = gen.generate(B, src_lengths=torch.from_numpy(src_lens),
                                 device=device)
        tokens = tokens[:, 0, 1:].cpu().numpy()
        t2 = time.perf_counter()
        encode_s += t1 - t0
        beam_s += t2 - t1
        n_steps += gen.steps
        for b, j in enumerate(chunk):
            hyp = tokens[b]
            eos_pos = np.where(hyp == 2)[0]
            if len(eos_pos):
                hyp = hyp[: eos_pos[0] + 1]
            scorer.add(np.asarray(tgt[j]).tolist(), hyp.tolist())
            hyps.append(hyp.tolist())
            n_tokens += len(hyp)
    return {"bleu": scorer.score(), "sentences": len(hyps),
            "detail": scorer.result_string(), "hypotheses": hyps,
            "hypothesis_tokens": n_tokens, "decode_steps": n_steps,
            "encode_s": encode_s,
            "beam_s": beam_s}


def main(args) -> dict:
    check_ported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    # float32 means float32: no TF32 in matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(args, args.dummy_vocab, args.dummy_vocab).to(device).eval()
    result = translate(args, model, device)
    print("| " + result["detail"])
    print(json.dumps({"bleu": result["bleu"], "sentences": result["sentences"]}))
    return result


def cli_main(argv=None):
    return main(parse_args(argv))


if __name__ == "__main__":
    cli_main()

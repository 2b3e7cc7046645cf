"""Beam-search translation and BLEU: the port's ``fairseq_cli/generate.py``.

Counterpart of ``efficient_attention_tpu/cli/generate.py``, with its flags.
The model's parameters come from ``--path``: the newest checkpoint there,
or with ``--num-avg-checkpoints N`` the average of the newest N
(``scripts/average_checkpoints.py``), pruned by
``--{encoder,decoder}-layers-to-keep``; without ``--path``, or with no step
there, the model keeps its weights drawn from ``--seed``.  Each batch of
``--gen-batch`` source sentences (the first ``--gen-subset-size`` of the
split) is padded to a multiple of 16, encoded once, repeated over the
beams, and decoded by ``SequenceGenerator`` one token a step, with every
decoder layer's cross-attention K/V projected once into its decode state
(fairseq ``static_kv``); ``--score-reference`` scores the references by one
teacher-forced forward instead.  The 1-best hypothesis is cut after its
first eos and scored by corpus BLEU: over the words of the target
dictionary with ``--remove-bpe`` (through ``WordIdMapper``), else on token
ids.  ``--results-path`` writes fairseq's ``S-``/``T-``/``H-`` lines (the
``--nbest`` hypotheses; ``P-`` per-token scores under
``--score-reference``) and ends with the ``Generate test with beam=K:``
line that ``scripts/torch_compound_split_bleu.sh`` waits for.  The last
line printed is ``{"bleu": ..., "sentences": ...}``.

The split is ``--gen-subset`` (fairseq's flag, default ``test``) of the
corpus in ``--data``; the JAX CLI has no such flag and translates the
train split, as the port does on ``--dummy-data`` pairs (those of
``cli.train_mt``).  The model runs on ``--device`` (default ``cuda``), on
one device, in float32.  With EVA in the encoder at eval, every encoder
layer runs the ``eva_1d`` kernel (K4) where its gate holds.  Flags whose
module is not ported yet raise ``NotImplementedError`` naming their
ROADMAP.md item.

Example (the WMT14 EN-DE recipe, ``main.sh:87-123``):

  python -m efficient_attention_torch.cli.generate --data data-bin/wmt14_en_de \\
      --attn-name-encoder eva \\
      --encoder-attn-window-size 8 --encoder-attn-num-landmarks 8 \\
      --encoder-attn-overlap-window --encoder-attn-use-t5-rpe \\
      --encoder-attn-adaptive-proj no-ln --attn-name-decoder causal_eva \\
      --decoder-attn-window-size 16 --decoder-attn-chunk-size 8 \\
      --decoder-attn-adaptive-proj qk --decoder-attn-causal \\
      --share-all-embeddings --path checkpoints/wmt14/ckpt \\
      --num-avg-checkpoints 10 --beam 4 --lenpen 0.6 --remove-bpe \\
      --gen-batch 64 --gen-subset-size 3003 --results-path gen.out
  bash scripts/torch_compound_split_bleu.sh gen.out
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from efficient_attention_torch.cli.train_mt import (
    build_model,
    build_parser,
    load_pairs,
    remove_bpe,
    vocab_sizes,
)


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
    parser.add_argument("--gen-subset", default="test",
                        help="the split of --data to translate (fairseq "
                             "--gen-subset); --dummy-data translates its "
                             "train pairs")
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
        (args.lm_path is not None, "--lm-path (shallow fusion)", item6),
        (args.sampling, "--sampling", item6),
        (args.diverse_beam_groups > 1, "--diverse-beam-groups", item6),
        (args.diversity_rate > 0, "--diversity-rate", item6),
        (args.prefix_size > 0, "--prefix-size", item6),
        (args.constraints, "--constraints", item6),
        (args.no_repeat_ngram_size > 0, "--no-repeat-ngram-size", item6),
        (args.print_alignment is not None, "--print-alignment", item6),
        (args.scoring != "bleu", f"--scoring {args.scoring}", item6),
        (args.bpe is not None or args.tokenizer is not None,
         "--bpe/--tokenizer (data/encoders.py)", item6),
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


def load_params(args):
    """The parameters ``--path`` gives, as a state dict on the CPU, or None
    (no ``--path``, or no step there): the newest step's, or the uniform
    average of the newest ``--num-avg-checkpoints`` (each read alone, no
    optimizer), then pruned to ``--{encoder,decoder}-layers-to-keep`` (JAX
    ``cli/generate.py:144-184``)."""
    from efficient_attention_torch.training.checkpoint import (
        CheckpointManager,
        average_checkpoints,
        parse_layers_to_keep,
        prune_layer_params,
    )

    if not args.path:
        return None
    mgr = CheckpointManager(args.path)
    take = mgr.all_steps()[-args.num_avg_checkpoints:]
    if not take:
        return None
    param_sets = [mgr.restore_params(step)[1] for step in take]
    print(f"| averaged {len(param_sets)} checkpoints: {take}")
    params = param_sets[0] if len(param_sets) == 1 else average_checkpoints(param_sets)
    for flag, scope in (("encoder_layers_to_keep", "encoder"),
                        ("decoder_layers_to_keep", "decoder")):
        keep = parse_layers_to_keep(getattr(args, flag))
        if keep:
            params = prune_layer_params(params, keep, scope)
            print(f"| pruned {scope} to layers {keep}")
    return params


def gen_split(args) -> str:
    """The split to translate: ``--gen-subset`` of ``--data``, or the train
    pairs of ``--dummy-data`` (the JAX CLI's)."""
    return "train" if args.dummy_data or not args.data else args.gen_subset


def _cut_at_eos(hyp: np.ndarray) -> np.ndarray:
    eos_pos = np.where(hyp == 2)[0]
    return hyp[: eos_pos[0] + 1] if len(eos_pos) else hyp


@torch.no_grad()
def score_references(model, src_b: np.ndarray, tgt_b: np.ndarray, prev_b: np.ndarray,
                     device: torch.device):
    """``--score-reference`` (fairseq ``SequenceScorer``): each reference's
    per-token log-probabilities by one teacher-forced forward, ``[B, T]``
    with 0 at pads, and their mean over the non-pad tokens ``[B]``."""
    logits = model(torch.from_numpy(src_b).to(device),
                   torch.from_numpy(prev_b).to(device))
    lp = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()
    tok_lp = np.take_along_axis(lp, tgt_b[..., None], axis=-1)[..., 0]
    mask = tgt_b != 1
    tok_lp = np.where(mask, tok_lp, 0.0)
    return tok_lp, tok_lp.sum(axis=1) / np.maximum(mask.sum(axis=1), 1)


@torch.no_grad()
def translate(args, model, device: torch.device) -> dict:
    """Generate and score every batch with ``model`` (in eval mode on
    ``device``).  Returns the result line's numbers, the scorer's line, the
    1-best hypotheses, the ``S-``/``T-``/``H-``/``P-`` lines (where the
    split has dictionaries), the decode steps run and the seconds spent
    encoding and in the beam loop."""
    from efficient_attention_torch.data.text_data import collate_tokens
    from efficient_attention_torch.generation.beam_search import SequenceGenerator
    from efficient_attention_torch.scoring.bleu import BleuScorer, WordIdMapper

    src, tgt, sd, td = load_pairs(args, split=gen_split(args))
    _, vocab = vocab_sizes(args, sd, td)
    scorer = BleuScorer()
    word_ids = WordIdMapper()
    K = args.beam
    hyps, gen_lines, n_tokens, n_steps = [], [], 0, 0
    encode_s = beam_s = 0.0
    for chunk, src_b, src_lens, buf_len, len_kw in generation_batches(args, src):
        B = src_b.shape[0]
        pscores = None
        t0 = time.perf_counter()
        if args.score_reference:
            tgt_b = collate_tokens([tgt[j] for j in chunk], pad_idx=1)
            prev_b = collate_tokens([tgt[j] for j in chunk], pad_idx=1,
                                    move_eos_to_beginning=True)
            pscores, ref_scores = score_references(model, src_b, tgt_b, prev_b,
                                                   device)
            # the hypothesis is the reference, its score the mean log-prob
            tokens = np.concatenate([np.full((B, 1), 2, np.int64), tgt_b],
                                    axis=1)[:, None]
            scores = ref_scores[:, None]
            t1 = t2 = time.perf_counter()
        else:
            enc_out, enc_pad = model.encode(torch.from_numpy(src_b).to(device))
            # the encoder output repeated over the beams
            enc_out_k = enc_out.repeat_interleave(K, dim=0)
            enc_pad_k = enc_pad.repeat_interleave(K, dim=0)
            _sync(device)
            t1 = time.perf_counter()

            def step_fn(states, tokens, step):
                logits, states = model.decode_step(states, tokens, step, None,
                                                   enc_pad_k)
                return logits[:, 0], states

            def init_cache(bk, max_len):
                return model.init_decode_state(bk, max_len, torch.float32, device,
                                               enc_out=enc_out_k)

            gen = SequenceGenerator(
                step_fn, init_cache, vocab_size=vocab, beam_size=K,
                max_len=buf_len,
                len_penalty=0.0 if args.unnormalized else args.lenpen,
                unk_penalty=args.unkpen, **len_kw)
            tokens, scores = gen.generate(B, src_lengths=torch.from_numpy(src_lens),
                                          device=device)
            tokens, scores = tokens.cpu().numpy(), scores.cpu().numpy()
            t2 = time.perf_counter()
            n_steps += gen.steps
        encode_s += t1 - t0
        beam_s += t2 - t1
        for b, j in enumerate(chunk):
            hyp = _cut_at_eos(tokens[b, 0, 1:])
            ref = np.asarray(tgt[j])
            hyps.append(hyp.tolist())
            n_tokens += len(hyp)
            if td is None:
                scorer.add(ref.tolist(), hyp.tolist())
                continue
            hyp_str = remove_bpe(td.string(hyp), args.remove_bpe)
            ref_str = remove_bpe(td.string(ref), args.remove_bpe)
            if args.remove_bpe is not None:
                # the post-processed word sequences, as fairseq scores them
                scorer.add(word_ids(ref_str), word_ids(hyp_str))
            else:
                scorer.add(ref.tolist(), hyp.tolist())
            gen_lines.append(f"S-{j}\t{remove_bpe(sd.string(src[j]), args.remove_bpe)}")
            gen_lines.append(f"T-{j}\t{ref_str}")
            gen_lines.append(f"H-{j}\t{scores[b, 0]:.4f}\t{hyp_str}")
            for k in range(1, min(args.nbest, tokens.shape[1])):
                hk = _cut_at_eos(tokens[b, k, 1:])
                gen_lines.append(f"H-{j}\t{scores[b, k]:.4f}\t"
                                 + remove_bpe(td.string(hk), args.remove_bpe))
            if pscores is not None:
                n_tok = int((ref != 1).sum())
                gen_lines.append(f"P-{j}\t" + " ".join(
                    f"{v:.4f}" for v in pscores[b, :n_tok]))
    return {"bleu": scorer.score(), "sentences": len(hyps),
            "detail": scorer.result_string(), "hypotheses": hyps,
            "gen_lines": gen_lines, "hypothesis_tokens": n_tokens,
            "decode_steps": n_steps, "encode_s": encode_s, "beam_s": beam_s}


def main(args) -> dict:
    """Build the model, load ``--path``'s parameters, translate, print the
    scorer's line and the result line, and write ``--results-path``.
    Returns the result, with the parameters loaded (``params``, None where
    none were) and the seconds their restore and averaging took."""
    check_ported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    # float32 means float32: no TF32 in matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    params = load_params(args)
    load_s = time.perf_counter() - t0
    _, _, sd, td = load_pairs(args, split=gen_split(args))
    model = build_model(args, *vocab_sizes(args, sd, td))
    if params is not None:
        model.load_state_dict(params)
    result = translate(args, model.to(device).eval(), device)
    print("| " + result["detail"])
    if args.results_path:
        # the last line is fairseq's, which compound_split_bleu.sh waits for
        lines = result["gen_lines"] + [
            f"Generate test with beam={args.beam}: {result['detail']}"]
        with open(args.results_path, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        print(f"| wrote generation output to {args.results_path}")
    print(json.dumps({"bleu": result["bleu"], "sentences": result["sentences"]}))
    return dict(result, params=params, load_s=load_s)


def cli_main(argv=None):
    return main(parse_args(argv))


if __name__ == "__main__":
    cli_main()

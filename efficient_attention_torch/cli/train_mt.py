"""MT CLI of the port (``fairseq_cli/train.py`` for the translation task).

Counterpart of ``efficient_attention_tpu/cli/train_mt.py``, with its flags
and its two-pass parsing: the encoder attention chosen by
``--attn-name-encoder`` with nested ``--encoder-attn-*`` flags, ``softmax``
or ``causal_eva`` decoder attention with ``--decoder-attn-*`` flags,
``--config`` YAML and ``--arch`` presets.  ``load_pairs`` reads a split
binarized by ``cli.preprocess`` (``--data DIR``: ``dict.{src,tgt}.txt``
and ``{split}.{lang}.bin/.idx``), or makes the ``--dummy-data`` sentence
pairs from ``--seed`` with the JAX CLI's numpy draws (so both packages
make the same sentences); ``build_model`` makes the ``TransformerModel``,
with weights drawn from ``--seed`` and ``--{encoder,decoder}-layers-to-keep``
setting the depths; ``cli.generate`` serves it.

``main`` trains it: fairseq Adam behind a global-norm clip, the
inverse-sqrt schedule, label-smoothed cross entropy, token-budget batches
of length-sorted pairs (``epoch_batches``), ``--update-freq``
accumulation, ``--bf16`` master-copy mixed precision, an EMA, validation
at every epoch's end and every ``--validate-interval-updates`` with
``--patience``, and in-train BLEU (``--eval-bleu``) over the target
dictionary's words (``--eval-bleu-remove-bpe``), or over token ids on
dummy pairs.  The model runs on ``--device`` (default ``cuda``), on one
device.  In training the encoder's EVA and the decoder's causal EVA run
eager (the decoder takes its target padding mask, so causal EVA never
takes K3, as in JAX); at validation and in-train BLEU the encoder runs the
``eva_1d`` kernel (K4) where its gate holds.

Checkpoints (``training/checkpoint.py``) go to ``<save-dir>/ckpt`` after
every update the manager's policy takes (every
``--save-interval-updates``, the newest ``--keep-last-epochs`` kept;
``--no-save``: none); a run resumes from the newest one there, with the
optimizer, the EMA and the step's generator, replaying the epochs and
batches from ``--seed`` up to it, so a resumed run is bit for bit the
straight one and ``--max-epoch`` counts the whole run's epochs.
``--finetune-from-model DIR`` starts from the parameters of DIR's newest
checkpoint instead, pruned to the kept layers.  Flags whose module is not
ported raise ``NotImplementedError`` naming their ROADMAP.md item.

Example (the WMT14 EN-DE recipe, ``main.sh:103-110``, on a corpus that
``cli.preprocess -s en -t de --joined-dictionary`` wrote):

  python -m efficient_attention_torch.cli.train_mt --data data-bin/wmt14_en_de \\
      --attn-name-encoder eva \\
      --encoder-attn-window-size 8 --encoder-attn-num-landmarks 8 \\
      --encoder-attn-overlap-window --encoder-attn-use-t5-rpe \\
      --encoder-attn-adaptive-proj no-ln --attn-name-decoder causal_eva \\
      --decoder-attn-window-size 16 --decoder-attn-chunk-size 8 \\
      --decoder-attn-adaptive-proj qk --decoder-attn-causal \\
      --share-all-embeddings --save-dir checkpoints/wmt14 \\
      --save-interval-updates 1000 --keep-last-epochs 10 --eval-bleu \\
      --eval-bleu-remove-bpe --eval-bleu-args '{"beam": 4, "lenpen": 0.6}'
"""
from __future__ import annotations

import argparse
import ast
import json
import math
import os
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("eatorch-train-mt", add_help=False)
    p.add_argument("--data", default=None)
    p.add_argument("--dummy-data", action="store_true")
    p.add_argument("--dummy-vocab", type=int, default=256)
    p.add_argument("--source-lang", "-s", default="en")
    p.add_argument("--target-lang", "-t", default="de")
    p.add_argument("--arch", default="transformer_wmt_en_de",
                   help="named architecture preset (fairseq "
                        "register_model_architecture): transformer, "
                        "transformer_wmt_en_de[_big], "
                        "transformer_iwslt_de_en, "
                        "transformer_vaswani_wmt_en_{de,fr}_big; "
                        "explicit flags win")
    p.add_argument("--attn-name-encoder", default="softmax")
    p.add_argument("--attn-name-decoder", default="softmax",
                   choices=["softmax", "causal_eva"])
    p.add_argument("--encoder-embed-dim", type=int, default=512)
    p.add_argument("--encoder-ffn-embed-dim", type=int, default=2048)
    p.add_argument("--encoder-layers", type=int, default=6)
    p.add_argument("--decoder-layers", type=int, default=None,
                   help="decoder depth (defaults to --encoder-layers)")
    p.add_argument("--encoder-attention-heads", type=int, default=8)
    p.add_argument("--encoder-layers-to-keep", default=None,
                   help="comma-separated encoder layer indices to keep "
                        "when loading a full-depth checkpoint (fairseq "
                        "prune_state_dict); e.g. '0,2,4'")
    p.add_argument("--activation-fn", default="relu",
                   choices=["relu", "gelu", "gelu_fast", "gelu_accurate",
                            "relu_squared", "tanh", "linear"],
                   help="FFN activation (fairseq --activation-fn)")
    p.add_argument("--encoder-learned-pos", action="store_true")
    p.add_argument("--decoder-learned-pos", action="store_true")
    p.add_argument("--quant-noise-pq", type=float, default=0.0,
                   help="iPQ quantization noise: drop this fraction of "
                        "block_size-wide weight blocks during training "
                        "(fairseq modules/quant_noise.py)")
    p.add_argument("--quant-noise-pq-block-size", type=int, default=8)
    p.add_argument("--decoder-layers-to-keep", default=None)
    p.add_argument("--share-all-embeddings", action="store_true",
                   help="one embedding table for encoder/decoder/output "
                        "(the WMT recipe, reference main.sh:147; requires "
                        "a joint vocabulary)")
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--checkpoint-activations", action="store_true",
                   help="rematerialize each layer in the backward "
                        "instead of storing activations "
                        "(reference transformer_config.py:165)")
    p.add_argument("--encoder-layerdrop", type=float, default=0.0,
                   help="LayerDrop probability for encoder layers "
                        "(fairseq LayerDropModuleList)")
    p.add_argument("--decoder-layerdrop", type=float, default=0.0)
    p.add_argument("--label-smoothing", type=float, default=0.1)
    p.add_argument("--max-tokens", type=int, default=4096)
    p.add_argument("--batch-size", "--max-sentences", type=int,
                   default=None, dest="batch_size",
                   help="cap sentences per batch alongside the token "
                        "budget (fairseq --batch-size/--max-sentences)")
    p.add_argument("--update-freq", type=int, default=1)
    p.add_argument("--optimizer", default="adam")
    p.add_argument("--adam-betas", default="(0.9, 0.98)")
    p.add_argument("--lr", type=float, default=7e-4)
    p.add_argument("--warmup-updates", type=int, default=6000)
    p.add_argument("--warmup-init-lr", type=float, default=1e-7)
    p.add_argument("--max-update", type=int, default=300000)
    p.add_argument("--clip-norm", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--save-dir", default="./checkpoints/mt")
    p.add_argument("--save-interval-updates", type=int, default=1000)
    p.add_argument("--keep-last-epochs", type=int, default=10)
    p.add_argument("--max-epoch", type=int, default=0,
                   help="stop after this many epochs (fairseq "
                        "--max-epoch; 0 = run to --max-update)")
    p.add_argument("--sentence-avg", action="store_true",
                   help="normalize the loss by sentences instead of "
                        "tokens (fairseq --sentence-avg)")
    p.add_argument("--finetune-from-model", default=None,
                   help="warm-start the PARAMETERS from this checkpoint "
                        "dir and train fresh (fairseq "
                        "--finetune-from-model); incompatible with "
                        "resuming")
    p.add_argument("--no-save", action="store_true",
                   help="never write checkpoints (fairseq --no-save)")
    p.add_argument("--stop-time-hours", type=float, default=-1,
                   help="stop training after this many wall-clock hours "
                        "(fairseq --stop-time-hours)")
    p.add_argument("--profile", nargs="?", const="", default=None,
                   metavar="LOGDIR",
                   help="trace the training loop with torch.profiler "
                        "(fairseq --profile)")
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--max-len", type=int, default=1024)
    p.add_argument("--max-nonfinite-skips", type=int, default=8,
                   help="abort after this many CONSECUTIVE skipped updates "
                        "(non-finite loss/grad -> skip + continue, the bf16 "
                        "analogue of fairseq trainer.py:911-920)")
    p.add_argument("--store-ema", action="store_true",
                   help="maintain an exponential moving average of the "
                        "params (fairseq EMA, dataclass/configs.py:"
                        "1057-1082); saved inside the checkpoint")
    p.add_argument("--ema-decay", type=float, default=0.9999,
                   help="EMA decay (fairseq --ema-decay)")
    p.add_argument("--disable-validation", action="store_true",
                   help="never run validation (fairseq --disable-validation)")
    p.add_argument("--validate-interval-updates", type=int, default=0,
                   help="also validate every N updates (fairseq "
                        "--validate-interval-updates; 0 = only at each "
                        "epoch end)")
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision: f32 master params, bf16 compute "
                        "(fairseq --fp16/--amp)")
    p.add_argument("--heartbeat-timeout", type=float, default=-1,
                   help="abort this rank if no training step completes "
                        "within this many seconds (fairseq "
                        "--heartbeat-timeout / DistributedTimeoutWrapper)")
    p.add_argument("--patience", type=int, default=-1,
                   help="early-stop after this many consecutive epoch "
                        "validations without valid-loss improvement "
                        "(fairseq --patience)")
    p.add_argument("--eval-bleu", action="store_true",
                   help="compute BLEU on the valid subset during "
                        "validation (fairseq translation task --eval-bleu, "
                        "reference tasks/translation.py:370-500)")
    p.add_argument("--eval-bleu-args", default=None,
                   help='JSON generation args, e.g. \'{"beam": 4, '
                        '"lenpen": 0.6, "max_len_b": 200}\'')
    p.add_argument("--eval-bleu-remove-bpe", nargs="?", const="@@ ",
                   default=None,
                   help="strip BPE before scoring (fairseq "
                        "--eval-bleu-remove-bpe)")
    p.add_argument("--eval-bleu-print-samples", action="store_true",
                   help="print one hypothesis/reference pair per "
                        "validation (fairseq --eval-bleu-print-samples)")
    p.add_argument("--eval-bleu-subset-size", type=int, default=64,
                   help="cap on valid sentences decoded for in-train BLEU")
    p.add_argument("--tensorboard-logdir", default="",
                   help="TensorBoard event dir (main.sh:152 parity)")
    p.add_argument("--wandb-project", default=None)
    p.add_argument("--azureml-logging", action="store_true")
    from efficient_attention_torch.parallel.distributed import add_distributed_args

    add_distributed_args(p)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device to run on ('cuda' or 'cpu')")
    return p


def parse_args(argv=None):
    """Two-pass parse (each attention's flags are registered once its name
    is known, from the CLI or the YAML config), then the YAML config and the
    ``--arch`` preset."""
    from efficient_attention_torch import AttentionFactory, NestedNamespace
    from efficient_attention_torch.config_yaml import (
        add_config_flag,
        apply_yaml_config,
        preparse_overrides,
    )
    from efficient_attention_torch.models.archs import MT_ARCHS, apply_arch

    parser = build_parser()
    add_config_flag(parser)
    names = preparse_overrides(parser, argv, ["attn_name_encoder", "attn_name_decoder"])
    parser = AttentionFactory.add_attn_specific_args(
        parser, names["attn_name_encoder"], struct_name="attn_args_encoder",
        prefix="encoder-attn")
    parser = AttentionFactory.add_attn_specific_args(
        parser, names["attn_name_decoder"], struct_name="attn_args_decoder",
        prefix="decoder-attn")
    parser.add_argument("--help", action="help")
    args = parser.parse_args(argv, namespace=NestedNamespace())
    args.attn_name_encoder = names["attn_name_encoder"]
    args.attn_name_decoder = names["attn_name_decoder"]
    args = apply_yaml_config(args, parser, argv)
    return apply_arch(args, parser, argv, MT_ARCHS)


class DummyPairs:
    """``n`` sentences of 5-23 tokens drawn uniformly from
    ``[4, vocab)`` plus eos (2), from ``rng`` (the JAX CLI's ``_Dummy``)."""

    def __init__(self, rng: np.random.Generator, vocab: int, n: int):
        self.seqs = [np.concatenate([rng.integers(4, vocab, size=rng.integers(5, 24)),
                                     [2]]).astype(np.int64) for _ in range(n)]

    def __len__(self) -> int:
        return len(self.seqs)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.seqs[i]

    @property
    def sizes(self) -> np.ndarray:
        return np.asarray([len(s) for s in self.seqs])


def load_pairs(args, split: str = "train"):
    """``(src, tgt, src_dict, tgt_dict)`` of a split: with ``--data`` (and
    not ``--dummy-data``) the binarized split ``{split}.{lang}`` of each
    side and the dictionaries ``dict.{lang}.txt``; otherwise 512 training
    or 64 validation pairs drawn from ``--seed`` (source first, then
    target, from one generator), and no dictionaries."""
    if args.data and not args.dummy_data:
        from efficient_attention_torch.data.dictionary import Dictionary
        from efficient_attention_torch.data.indexed_dataset import MMapIndexedDataset

        sides = [(os.path.join(args.data, f"dict.{lang}.txt"),
                  os.path.join(args.data, f"{split}.{lang}"))
                 for lang in (args.source_lang, args.target_lang)]
        (sd, src), (td, tgt) = ((Dictionary.load(d), MMapIndexedDataset(prefix))
                                for d, prefix in sides)
        return src, tgt, sd, td
    rng = np.random.default_rng(args.seed + (0 if split == "train" else 1))
    n = 512 if split == "train" else 64
    return (DummyPairs(rng, args.dummy_vocab, n),
            DummyPairs(rng, args.dummy_vocab, n), None, None)


def vocab_sizes(args, sd, td):
    """Source and target vocabulary sizes: the dictionaries', or
    ``--dummy-vocab`` on dummy pairs."""
    return (len(sd) if sd else args.dummy_vocab,
            len(td) if td else args.dummy_vocab)


def build_model(args, src_vocab: int, tgt_vocab: int):
    """The ``TransformerModel`` of ``args`` with weights drawn from
    ``args.seed``, on the CPU in float32; ``--encoder-layers-to-keep`` and
    ``--decoder-layers-to-keep`` set the depths they name."""
    from efficient_attention_torch.config import namespace_to_dict
    from efficient_attention_torch.models.transformer import (
        TransformerModel,
        init_weights,
    )
    from efficient_attention_torch.training.checkpoint import parse_layers_to_keep

    enc_keep = parse_layers_to_keep(getattr(args, "encoder_layers_to_keep", None))
    dec_keep = parse_layers_to_keep(getattr(args, "decoder_layers_to_keep", None))
    dec_layers = getattr(args, "decoder_layers", None)
    if dec_layers is None:
        dec_layers = args.encoder_layers
    model = TransformerModel(
        src_vocab, tgt_vocab, embed_dim=args.encoder_embed_dim,
        ffn_dim=args.encoder_ffn_embed_dim,
        num_layers=len(enc_keep) if enc_keep else args.encoder_layers,
        num_decoder_layers=len(dec_keep) if dec_keep else dec_layers,
        num_heads=args.encoder_attention_heads,
        attn_name_encoder=args.attn_name_encoder,
        attn_args_encoder=namespace_to_dict(
            getattr(args, "attn_args_encoder", argparse.Namespace())),
        attn_name_decoder=args.attn_name_decoder,
        attn_args_decoder=namespace_to_dict(
            getattr(args, "attn_args_decoder", argparse.Namespace())),
        dropout=args.dropout, max_len=args.max_len,
        share_all_embeddings=args.share_all_embeddings,
        checkpoint_activations=args.checkpoint_activations,
        encoder_layerdrop=args.encoder_layerdrop,
        decoder_layerdrop=args.decoder_layerdrop,
        quant_noise_pq=args.quant_noise_pq,
        quant_noise_pq_block_size=args.quant_noise_pq_block_size,
        activation_fn=args.activation_fn,
        encoder_learned_pos=args.encoder_learned_pos,
        decoder_learned_pos=args.decoder_learned_pos)
    return init_weights(model, torch.Generator().manual_seed(args.seed))


def check_ported(args) -> None:
    """Raise ``NotImplementedError`` for every flag set to something whose
    module is not ported yet, naming its ROADMAP.md item."""
    item8 = "Queue 1, item 8"
    queued = [
        (args.heartbeat_timeout > 0, "--heartbeat-timeout", item8),
        (bool(args.tensorboard_logdir), "--tensorboard-logdir", item8),
        (args.wandb_project is not None, "--wandb-project", item8),
        (args.azureml_logging, "--azureml-logging", item8),
    ]
    for unported, flag, item in queued:
        if unported:
            raise NotImplementedError(f"{flag} is not ported yet; see ROADMAP.md {item}")


def epoch_batches(order_rng: np.random.Generator, sizes: np.ndarray,
                  train_ok: np.ndarray, max_tokens: int,
                  max_sentences=None, update_freq: int = 1,
                  num_replicas: int = 1):
    """One epoch's global batches of pair indices (JAX
    ``cli/train_mt.py:540-563``): a permutation from ``order_rng``, the
    pairs within ``--max-len`` (``train_ok``), a stable sort by length,
    token-budget batches that split into ``update_freq`` microbatches of
    ``num_replicas`` (data-parallel ranks) equal parts, shuffled by
    ``order_rng`` and each cut to a multiple of ``update_freq x
    num_replicas`` (empty ones dropped)."""
    from efficient_attention_torch.data.text_data import batch_by_size

    quantum = max(1, update_freq) * num_replicas
    order = order_rng.permutation(len(sizes))
    order = order[train_ok[order]]
    order = order[np.argsort(sizes[order], kind="stable")]
    if max_sentences is not None and max_sentences < quantum:
        # every batch would be cut to nothing and the epoch loop would spin
        ranks = "" if num_replicas == 1 else f"{num_replicas} ranks x "
        raise ValueError(f"--batch-size {max_sentences} must be >= {ranks}"
                         f"--update-freq ({quantum}): each batch must split "
                         "into update_freq microbatches over the ranks")
    batches = batch_by_size(order, sizes, max_tokens,
                            max_sentences=max_sentences,
                            required_multiple=quantum)
    order_rng.shuffle(batches)
    batches = [b[: len(b) - len(b) % quantum] for b in batches]
    return [b for b in batches if len(b)]


def collate_pairs(pairs, bidx, device, rows=None):
    """``(src, prev_output_tokens, tgt)`` ``[B, T]`` tensors on ``device``
    of the pairs ``bidx``, each padded to a multiple of 8; the previous
    output tokens are the targets with eos moved to the front.  ``rows``
    (``parallel.local_rows`` with its mesh) picks this rank's rows of the
    batch, which keeps the whole batch's lengths."""
    from efficient_attention_torch.data.text_data import collate_tokens

    samples = [pairs[int(i)] for i in bidx]
    src = collate_tokens([s for s, _ in samples], pad_idx=1)
    tgt = collate_tokens([t for _, t in samples], pad_idx=1)
    prev = collate_tokens([t for _, t in samples], pad_idx=1,
                          move_eos_to_beginning=True)
    out = (torch.from_numpy(a) for a in (src, prev, tgt))
    return tuple((t if rows is None else rows(t)).to(device) for t in out)


def valid_batches(vpairs, max_len: int, max_tokens: int):
    """The validation batches: the pairs within ``max_len`` (fairseq's
    max-positions filter), sorted by length, in token-budget batches."""
    from efficient_attention_torch.data.text_data import batch_by_size

    vsizes = np.maximum(vpairs.src_sizes, vpairs.tgt_sizes)
    valid_ids = np.flatnonzero(vsizes <= max_len)
    vorder = valid_ids[np.argsort(vsizes[valid_ids], kind="stable")]
    return batch_by_size(vorder, vsizes, max_tokens)


def valid_sums(model, eval_step, vpairs, batches, device):
    """Summed smoothed loss, NLL and target tokens of ``model`` (in eval
    mode) over ``batches`` of ``vpairs``, as Python floats."""
    loss_sum = nll_sum = tok_sum = 0.0
    for bidx in batches:
        ls, ns, nt = eval_step(model, *collate_pairs(vpairs, bidx, device))
        loss_sum += float(ls)
        nll_sum += float(ns)
        tok_sum += float(nt)
    return loss_sum, nll_sum, tok_sum


def remove_bpe(sentence: str, symbol) -> str:
    """fairseq ``post_process`` for the subword-nmt symbol: drop ``symbol``
    (``'@@ '``) so continued pieces join their next word; None keeps the
    sentence."""
    if symbol is None:
        return sentence
    return (sentence + " ").replace(symbol, "").rstrip()


@torch.no_grad()
def bleu_chunks(vpairs, ids, gen_args, vocab: int, model, device,
                print_samples: bool = False, td=None, bpe_symbol=None,
                sharding=None) -> float:
    """In-train BLEU (JAX ``cli/train_mt.py:412-480``, fairseq
    ``translation.py`` ``_inference_with_bleu``) over the pairs ``ids``:
    beam search in chunks of 8 sentences, each with an output buffer of
    ``max_len_a * S + max_len_b`` (default ``2 S``) tokens, the 1-best cut
    before its first eos and scored against the reference without its eos:
    with a target dictionary ``td`` over its words (``bpe_symbol`` removed,
    ``--eval-bleu-remove-bpe``) through ``WordIdMapper``, else on token
    ids.  With ``sharding`` each data-parallel rank translates every
    ``dp``-th chunk and the n-gram counts are summed over the ranks."""
    from efficient_attention_torch.data.text_data import collate_tokens
    from efficient_attention_torch.parallel.distributed import dp_coordinate
    from efficient_attention_torch.generation.beam_search import SequenceGenerator
    from efficient_attention_torch.scoring.bleu import BleuScorer, WordIdMapper

    K = int(gen_args.get("beam", 4))
    scorer = BleuScorer()
    word_ids = WordIdMapper()
    printed = False
    rank, size = dp_coordinate(None if sharding is None else sharding.mesh)
    for i in range(8 * rank, len(ids), 8 * size):
        chunk = ids[i: i + 8]
        src_b = torch.from_numpy(collate_tokens(
            [vpairs[int(j)][0] for j in chunk], pad_idx=1)).to(device)
        enc_out, enc_pad = model.encode(src_b)
        enc_out_k = enc_out.repeat_interleave(K, dim=0)
        enc_pad_k = enc_pad.repeat_interleave(K, dim=0)

        def step_fn(states, tokens, step):
            logits, states = model.decode_step(states, tokens, step, None, enc_pad_k)
            return logits[:, 0], states

        def init_cache(bk, max_len):
            return model.init_decode_state(bk, max_len, torch.float32, device,
                                           enc_out=enc_out_k)

        S = src_b.shape[1]
        buf_len = (int(gen_args.get("max_len_a", 0) * S)
                   + int(gen_args.get("max_len_b", 2 * S)))
        gen = SequenceGenerator(step_fn, init_cache, vocab_size=vocab,
                                beam_size=K, max_len=buf_len,
                                len_penalty=float(gen_args.get("lenpen", 1.0)),
                                pad=1, eos=2)
        tokens, _ = gen.generate(src_b.shape[0], device=device)
        tokens = tokens[:, 0, 1:].cpu().numpy()
        for b, j in enumerate(chunk):
            hyp = tokens[b]
            eos_pos = np.where(hyp == 2)[0]
            if len(eos_pos):
                hyp = hyp[: eos_pos[0]]
            ref = np.asarray(vpairs[int(j)][1])
            ref = ref[ref != 2]
            if td is not None:
                hyp_s = remove_bpe(td.string(hyp), bpe_symbol)
                ref_s = remove_bpe(td.string(ref), bpe_symbol)
                shown = (hyp_s, ref_s)
                scorer.add(word_ids(ref_s), word_ids(hyp_s))
            else:
                shown = (hyp.tolist(), ref.tolist())
                scorer.add(ref.tolist(), hyp.tolist())
            if print_samples and not printed:
                print(f"| example hypothesis: {shown[0]}")
                print(f"| example reference:  {shown[1]}")
                printed = True
    if size > 1:
        order = scorer.order
        counts = sharding.all_reduce_dp(torch.tensor(
            scorer.match + scorer.total + [scorer.sys_len, scorer.ref_len],
            dtype=torch.float64, device=device)).long().tolist()
        scorer.match, scorer.total = counts[:order], counts[order:2 * order]
        scorer.sys_len, scorer.ref_len = counts[2 * order:]
    return scorer.score()


def main(args) -> dict:
    """Train; in a process group (joined under ``--distributed`` or
    ``torchrun``, and left again where this call joined it) data-parallel,
    each rank on its rows of every global batch, validation and BLEU
    reduced over the ranks, rank 0 alone printing and saving."""
    from efficient_attention_torch.parallel.distributed import run_in_group

    check_ported(args)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    return run_in_group(args, _train)


def _train(args) -> dict:
    import functools

    import torch.distributed as dist

    from efficient_attention_torch.cli.train_lm import _print_profile, _profiler
    from efficient_attention_torch.parallel import local_rows, make_mesh, shard_model
    from efficient_attention_torch.parallel.distributed import (
        dp_coordinate,
        generator_states,
        is_primary,
        rank_seed,
        restore_generator,
        run_device,
    )
    from efficient_attention_torch.data.text_data import LanguagePairDataset
    from efficient_attention_torch.training.lm_steps import (
        make_mt_eval_step,
        make_mt_train_step,
    )
    from efficient_attention_torch.training.metrics import MetricLogger
    from efficient_attention_torch.training.optim import (
        inverse_sqrt_schedule,
        make_optimizer,
    )
    from efficient_attention_torch.training.checkpoint import (
        CheckpointManager,
        maybe_prune_for_keep,
        parse_layers_to_keep,
    )
    from efficient_attention_torch.training.train_state import TrainState

    device = run_device(args)
    # float32 means float32: no TF32 in matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    src, tgt, sd, td = load_pairs(args)
    src_vocab, tgt_vocab = vocab_sizes(args, sd, td)
    model = build_model(args, src_vocab, tgt_vocab).to(device)
    mesh = make_mesh(device_type=device.type) if dist.is_initialized() else None
    sharding = None if mesh is None else shard_model(model, mesh)
    dp_rank, dp_size = dp_coordinate(mesh)
    accum = max(1, args.update_freq)
    rows = (None if mesh is None
            else functools.partial(local_rows, mesh=mesh, microbatches=accum))
    pairs = LanguagePairDataset(src, tgt)
    schedule = inverse_sqrt_schedule(args.lr, args.warmup_updates,
                                     args.warmup_init_lr)
    optimizer = make_optimizer(args.optimizer, model.named_parameters(), schedule,
                               weight_decay=0.0, clip_grad=args.clip_norm or None,
                               betas=tuple(ast.literal_eval(args.adam_betas)))
    state = TrainState(model if sharding is None else sharding.model, optimizer,
                       ema_decay=args.ema_decay if args.store_ema else 0.0,
                       sharding=sharding)
    train_step = make_mt_train_step(
        pad_idx=1, label_smoothing=args.label_smoothing,
        accum_steps=args.update_freq,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        sentence_avg=args.sentence_avg)

    vsrc, vtgt, _, _ = load_pairs(args, split="valid")
    vpairs = LanguagePairDataset(vsrc, vtgt)
    vbatches = valid_batches(vpairs, args.max_len, args.max_tokens)
    eval_step = make_mt_eval_step(pad_idx=1, label_smoothing=args.label_smoothing)
    gen_args = json.loads(args.eval_bleu_args) if args.eval_bleu_args else {}
    vsizes = np.maximum(vpairs.src_sizes, vpairs.tgt_sizes)
    bleu_ids = np.flatnonzero(vsizes <= args.max_len)[: args.eval_bleu_subset_size]

    def validate() -> dict:
        """Valid-split loss, NLL and perplexity of the float32 parameters
        (and BLEU with ``--eval-bleu``)."""
        if args.disable_validation:
            return {}
        model.eval()
        loss_sum, nll_sum, tok_sum = valid_sums(
            model, eval_step, vpairs, vbatches[dp_rank::dp_size], device)
        if sharding is not None:
            loss_sum, nll_sum, tok_sum = sharding.all_reduce_dp(torch.tensor(
                [loss_sum, nll_sum, tok_sum], dtype=torch.float64,
                device=device)).tolist()
        n = max(tok_sum, 1.0)
        vm = {"valid_loss": loss_sum / n, "valid_nll_loss": nll_sum / n,
              "valid_ppl": math.exp(min(nll_sum / n, 50.0))}
        if args.eval_bleu:
            vm["valid_bleu"] = bleu_chunks(vpairs, bleu_ids.tolist(), gen_args,
                                           tgt_vocab, model, device,
                                           args.eval_bleu_print_samples, td,
                                           args.eval_bleu_remove_bpe, sharding)
        print("| valid " + " ".join(f"{k.removeprefix('valid_')} {v:.3f}"
                                    for k, v in vm.items()))
        return vm

    sizes = np.maximum(pairs.src_sizes, pairs.tgt_sizes)
    train_ok = sizes <= args.max_len
    n_dropped = int((~train_ok).sum())
    if n_dropped:
        print(f"| WARNING: {n_dropped} train examples exceed --max-len "
              f"{args.max_len} and were dropped (fairseq max-positions "
              "filtering)")
    generator = torch.Generator(device=device).manual_seed(
        rank_seed(args.seed, mesh))
    order_rng = np.random.default_rng(args.seed)
    if is_primary():
        os.makedirs(args.save_dir, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(args.save_dir, "ckpt"),
                             keep_last=args.keep_last_epochs,
                             save_interval_steps=args.save_interval_updates)
    if args.finetune_from_model:
        # parameters only: optimizer, schedule and batch order start afresh
        if ckpt.latest_step() is not None:
            raise ValueError("--finetune-from-model cannot be combined with "
                             "resuming from --save-dir")
        restored = CheckpointManager(args.finetune_from_model).restore_params()
        if restored is None:
            raise FileNotFoundError(f"--finetune-from-model "
                                    f"{args.finetune_from_model}: no checkpoint found")
        fstep, fparams = restored
        for flag, scope in (("encoder_layers_to_keep", "encoder"),
                            ("decoder_layers_to_keep", "decoder")):
            fparams = maybe_prune_for_keep(
                fparams, parse_layers_to_keep(getattr(args, flag)), scope)
        model.load_state_dict(fparams)
        if state.ema_params is not None:
            state.ema_params = {n: p.detach().clone()
                                for n, p in model.named_parameters()}
        print(f"| finetuning from {args.finetune_from_model} (step {fstep}); "
              "optimizer and schedule reset")
    # auto-resume: the whole state and the step's generator; the epochs and
    # batches are a function of the seed, so the first ``skip`` batches are
    # drawn again and passed over
    skip = ckpt.latest_step() or 0
    if skip:
        saved = ckpt.load(skip)
        state.load_state_dict(saved)
        restore_generator(generator, saved["rng"], mesh)
        print(f"| resumed from checkpoint step {skip}")
    logger = MetricLogger()
    stats: dict = {}
    t0 = time.time()
    consec_skips = 0
    best_valid, bad_valids = float("inf"), 0
    prof = None
    epoch = 0
    while state.step < args.max_update:
        if stats.get("time_stop"):
            break
        epoch += 1
        if args.max_epoch and epoch > args.max_epoch:
            print(f"| stopping: --max-epoch {args.max_epoch} reached")
            break
        for bidx in epoch_batches(order_rng, sizes, train_ok, args.max_tokens,
                                  args.batch_size, args.update_freq, dp_size):
            if state.step >= args.max_update:
                break
            if skip:
                skip -= 1
                continue
            if args.profile is not None and state.step == 1 and prof is None:
                prof = _profiler(device)
                prof.start()
            metrics = train_step(state, *collate_pairs(pairs, bidx, device,
                                                       rows), generator)
            if prof is not None and state.step == 4:
                prof.stop()
                _print_profile(prof, device, args.profile)
                prof = None
            if bool(metrics.skipped):
                consec_skips += 1
                print(f"| WARNING: non-finite loss/grad detected, skipping "
                      f"update ({consec_skips} consecutive)")
                if consec_skips >= args.max_nonfinite_skips:
                    raise FloatingPointError(
                        f"{consec_skips} consecutive non-finite updates; aborting")
                continue
            consec_skips = 0
            step = state.step
            loss = float(metrics.loss)
            logger.update(loss=loss, gnorm=float(metrics.grad_norm))
            if step % args.log_interval == 0:
                print(f"| step {step} {logger} | {time.time() - t0:.0f}s")
            if not args.no_save and ckpt.should_save(step):
                ckpt.save(step, dict(state.state_dict(),
                                     rng=generator_states(generator)))
            stats = {"step": step, "loss": loss}
            if (args.stop_time_hours > 0
                    and time.time() - t0 > args.stop_time_hours * 3600):
                print(f"| stopping: --stop-time-hours {args.stop_time_hours} reached")
                stats["time_stop"] = True
                break
            if (args.validate_interval_updates > 0
                    and step % args.validate_interval_updates == 0):
                stats.update(validate())
        # epoch boundary: fairseq validates once an epoch (not in an epoch
        # whose batches were all passed over on resume)
        if not skip and state.step > 0:
            stats.update(validate())
            if args.patience > 0 and "valid_loss" in stats:
                if stats["valid_loss"] < best_valid - 1e-9:
                    best_valid, bad_valids = stats["valid_loss"], 0
                else:
                    bad_valids += 1
                    if bad_valids >= args.patience:
                        print(f"| early stop: valid loss has not improved for "
                              f"{bad_valids} epochs (--patience {args.patience})")
                        stats["early_stop"] = True
                        break
    if prof is not None:  # training ended inside the traced steps
        prof.stop()
        _print_profile(prof, device, args.profile)
    ckpt.wait()
    print(json.dumps(stats))
    return stats


def cli_main(argv=None):
    return main(parse_args(argv))


if __name__ == "__main__":
    cli_main()

"""MT CLI of the port (``fairseq_cli/train.py`` for the translation task).

Counterpart of ``efficient_attention_tpu/cli/train_mt.py``, with its flags
and its two-pass parsing: the encoder attention chosen by
``--attn-name-encoder`` with nested ``--encoder-attn-*`` flags, ``softmax``
or ``causal_eva`` decoder attention with ``--decoder-attn-*`` flags,
``--config`` YAML and ``--arch`` presets.  ``load_pairs`` makes the
``--dummy-data`` sentence pairs from ``--seed`` with the JAX CLI's numpy
draws (so both packages make the same sentences) and ``build_model`` the
``TransformerModel``, with weights drawn from ``--seed``; ``cli.generate``
serves it.  Training itself (``main``), ``--data`` and checkpoints are not
ported yet (ROADMAP.md Queue 1, items 5, 6 and 8) and raise.
"""
from __future__ import annotations

import argparse

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
    dist = p.add_argument_group("distributed")
    dist.add_argument("--distributed", action="store_true", default=False)
    dist.add_argument("--coordinator-address", default=None, type=str)
    dist.add_argument("--num-processes", default=None, type=int)
    dist.add_argument("--process-id", default=None, type=int)
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
    """``(src, tgt, src_dict, tgt_dict)`` of a split: with ``--dummy-data``
    (or no ``--data``) 512 training or 64 validation pairs drawn from
    ``--seed`` (source first, then target, from one generator), and no
    dictionaries."""
    if args.data and not args.dummy_data:
        raise NotImplementedError(
            "--data is not ported yet; see ROADMAP.md Queue 1, item 5 "
            "(data/{dictionary,indexed_dataset}.py)")
    rng = np.random.default_rng(args.seed + (0 if split == "train" else 1))
    n = 512 if split == "train" else 64
    return (DummyPairs(rng, args.dummy_vocab, n),
            DummyPairs(rng, args.dummy_vocab, n), None, None)


def build_model(args, src_vocab: int, tgt_vocab: int):
    """The ``TransformerModel`` of ``args`` with weights drawn from
    ``args.seed``, on the CPU in float32."""
    from efficient_attention_torch.config import namespace_to_dict
    from efficient_attention_torch.models.transformer import (
        TransformerModel,
        init_weights,
    )

    for flag in ("encoder_layers_to_keep", "decoder_layers_to_keep"):
        if getattr(args, flag, None):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet; see ROADMAP.md "
                "Queue 1, item 8 (training/checkpoint.py)")
    dec_layers = getattr(args, "decoder_layers", None)
    model = TransformerModel(
        src_vocab, tgt_vocab, embed_dim=args.encoder_embed_dim,
        ffn_dim=args.encoder_ffn_embed_dim, num_layers=args.encoder_layers,
        num_decoder_layers=args.encoder_layers if dec_layers is None else dec_layers,
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


def main(args) -> dict:
    raise NotImplementedError(
        "MT training is a later slice of the port; see ROADMAP.md Queue 1, "
        "item 6 (LanguagePairDataset, batch_by_size, the Adam + inverse-sqrt "
        "step, trajectory_mt_adam.npz); cli.generate serves the model")


def cli_main(argv=None):
    return main(parse_args(argv))


if __name__ == "__main__":
    cli_main()

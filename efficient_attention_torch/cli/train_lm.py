"""LM training CLI of the port (``fairseq_cli/train.py`` for the LM task).

Counterpart of ``efficient_attention_tpu/cli/train_lm.py``, with its flags:
causal-EVA or softmax decoder attention chosen by ``--attn-name-decoder``
with nested ``--decoder-attn-*`` flags, ``--arch`` presets and ``--config``
YAML, NAG (or AdamW, or fairseq Adam) behind a global-norm clip, the
cosine(t-mult), inverse-sqrt or polynomial schedule, layerdrop and
``--checkpoint-activations``, token blocks, the adaptive or full
softmax loss, ``--update-freq`` accumulation, ``--bf16`` master-copy mixed
precision, validation every ``--validate-interval-updates`` and at the end.
``--data DIR`` trains on a corpus binarized by ``cli.preprocess`` (its
``dict.txt`` and ``train``/``valid`` splits); ``--dummy-data`` on tokens
drawn from ``--seed`` (the ``fairseq/benchmark/dummy_lm.py`` analogue).
The model runs on ``--device`` (default ``cuda``), on one device; the
token blocks are dense (``dense_tokens``), so causal EVA takes the
``causal_packed`` kernel (K3) where its gate holds.

Checkpoints (``training/checkpoint.py``) go to ``<save-dir>/ckpt`` every
``--save-interval-updates``, the newest ``--keep-interval-updates`` kept
(``--no-save``: none); a run resumes from the newest one there, with the
optimizer, the EMA, the step's generator and the batch order (replayed
from ``--seed``), so a resumed run is bit for bit the straight one.
``--finetune-from-model DIR`` starts from the parameters of DIR's newest
checkpoint instead (optimizer and schedule fresh; not with a checkpoint to
resume), and ``--decoder-layers-to-keep`` builds that many layers and
prunes a deeper checkpoint on load.  Flags whose module is not ported
raise ``NotImplementedError`` naming their ROADMAP.md item.

Example (the wiki103 recipe with causal EVA at full width):

  python -m efficient_attention_torch.cli.train_lm \\
      --arch transformer_lm_wiki103 --config configs/wikitext103_causal_eva.yaml \\
      --data data-bin/wikitext-103 --save-dir checkpoints/wiki103 \\
      --dropout 0 --bf16 --max-update 8
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("eatorch-train-lm", add_help=False)
    p.add_argument("--data", default=None, help="binarized data dir")
    p.add_argument("--dummy-data", action="store_true")
    p.add_argument("--dummy-vocab", type=int, default=1000)
    p.add_argument("--attn-name-decoder", default="softmax",
                   choices=["softmax", "causal_eva"])
    p.add_argument("--arch", default=None,
                   help="named architecture preset (transformer_lm, "
                        "transformer_lm_big, transformer_lm_wiki103, "
                        "transformer_lm_gpt, transformer_lm_gpt2_"
                        "{tiny,small,medium,big}); explicit flags win")
    p.add_argument("--decoder-embed-dim", type=int, default=1024)
    p.add_argument("--decoder-ffn-embed-dim", type=int, default=4096)
    p.add_argument("--decoder-layers", type=int, default=16)
    p.add_argument("--decoder-attention-heads", type=int, default=8)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--checkpoint-activations", action="store_true")
    p.add_argument("--decoder-layerdrop", type=float, default=0.0)
    p.add_argument("--activation-fn", default="relu",
                   choices=["relu", "gelu", "gelu_fast", "gelu_accurate",
                            "relu_squared", "tanh", "linear"])
    p.add_argument("--decoder-learned-pos", action="store_true")
    p.add_argument("--quant-noise-pq", type=float, default=0.0)
    p.add_argument("--quant-noise-pq-block-size", type=int, default=8)
    p.add_argument("--decoder-layers-to-keep", default=None)
    p.add_argument("--tokens-per-sample", type=int, default=512)
    p.add_argument("--max-tokens", type=int, default=9216)
    p.add_argument("--update-freq", type=int, default=1)
    p.add_argument("--optimizer", default="nag",
                   choices=["nag", "adamw", "adam", "sgd", "adafactor"])
    p.add_argument("--lr", type=float, default=1.0)
    p.add_argument("--lr-scheduler", default="cosine",
                   choices=["cosine", "inverse_sqrt", "polynomial"])
    p.add_argument("--lr-period-updates", type=float, default=270000)
    p.add_argument("--t-mult", type=float, default=2.0)
    p.add_argument("--lr-shrink", type=float, default=0.75)
    p.add_argument("--warmup-updates", type=int, default=16000)
    p.add_argument("--warmup-init-lr", type=float, default=1e-7)
    p.add_argument("--min-lr", type=float, default=1e-9)
    p.add_argument("--max-update", type=int, default=286000)
    p.add_argument("--clip-norm", type=float, default=0.1)
    p.add_argument("--criterion", default="adaptive_loss",
                   choices=["adaptive_loss", "cross_entropy"])
    p.add_argument("--adaptive-cutoffs", default="20000,60000")
    p.add_argument("--adaptive-input", action="store_true")
    p.add_argument("--tie-adaptive-weights", action="store_true")
    p.add_argument("--no-decoder-final-norm", action="store_true")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--save-dir", default="./checkpoints/lm")
    p.add_argument("--save-interval-updates", type=int, default=1000)
    p.add_argument("--keep-interval-updates", type=int, default=3)
    p.add_argument("--finetune-from-model", default=None)
    p.add_argument("--no-save", action="store_true")
    p.add_argument("--stop-time-hours", type=float, default=-1)
    p.add_argument("--profile", nargs="?", const="", default=None,
                   metavar="LOGDIR",
                   help="trace train steps 1-3 with torch.profiler, print the "
                        "ops by device time, and write a Chrome trace to "
                        "LOGDIR if given")
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--max-len", type=int, default=3072)
    p.add_argument("--base-layers", type=int, default=0)
    p.add_argument("--base-experts", type=int, default=0)
    p.add_argument("--base-sublayers", type=int, default=1)
    p.add_argument("--base-shuffle", action="store_true")
    p.add_argument("--seq-parallel", type=int, default=1)
    p.add_argument("--pipeline-stages", type=int, default=1)
    p.add_argument("--pipeline-chunks", type=int, default=2)
    p.add_argument("--max-nonfinite-skips", type=int, default=8)
    p.add_argument("--store-ema", action="store_true")
    p.add_argument("--ema-decay", type=float, default=0.9999)
    p.add_argument("--disable-validation", action="store_true")
    p.add_argument("--validate-interval-updates", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision: float32 master parameters, "
                        "bfloat16 forward and backward")
    p.add_argument("--heartbeat-timeout", type=float, default=-1)
    p.add_argument("--patience", type=int, default=-1)
    p.add_argument("--tensorboard-logdir", default="")
    p.add_argument("--wandb-project", default=None)
    p.add_argument("--azureml-logging", action="store_true")
    from efficient_attention_torch.parallel.distributed import add_distributed_args

    add_distributed_args(p)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device to run on ('cuda' or 'cpu')")
    return p


def parse_args(argv=None, parser=None):
    """Two-pass parse (the attention's flags are registered once its name is
    known, from the CLI or the YAML config), then the YAML config and the
    ``--arch`` preset; ``parser`` is :func:`build_parser`'s, or one that
    adds to it (``cli.eval_lm``)."""
    from efficient_attention_torch import AttentionFactory, NestedNamespace
    from efficient_attention_torch.config_yaml import (
        add_config_flag,
        apply_yaml_config,
        preparse_overrides,
    )
    from efficient_attention_torch.models.archs import LM_ARCHS, apply_arch

    parser = build_parser() if parser is None else parser
    add_config_flag(parser)
    names = preparse_overrides(parser, argv, ["attn_name_decoder"])
    parser = AttentionFactory.add_attn_specific_args(
        parser, names["attn_name_decoder"], struct_name="attn_args_decoder",
        prefix="decoder-attn")
    parser.add_argument("--help", action="help")
    args = parser.parse_args(argv, namespace=NestedNamespace())
    args.attn_name_decoder = names["attn_name_decoder"]
    args = apply_yaml_config(args, parser, argv)
    return apply_arch(args, parser, argv, LM_ARCHS)


def check_ported(args) -> None:
    """Raise ``NotImplementedError`` for every flag set to something whose
    module is not ported yet, naming its ROADMAP.md item."""
    queued = [
        (args.pipeline_stages > 1, "--pipeline-stages", "Queue 1, item 7"),
        (args.seq_parallel > 1, "--seq-parallel", "Queue 1, item 7"),
        (args.base_layers > 0, "--base-layers", "Queue 1, item 7"),
        (args.heartbeat_timeout > 0, "--heartbeat-timeout", "Queue 1, item 8"),
        (bool(args.tensorboard_logdir), "--tensorboard-logdir", "Queue 1, item 8"),
        (args.wandb_project is not None, "--wandb-project", "Queue 1, item 8"),
        (args.azureml_logging, "--azureml-logging", "Queue 1, item 8"),
    ]
    for unported, flag, item in queued:
        if unported:
            raise NotImplementedError(f"{flag} is not ported yet; see ROADMAP.md {item}")


def load_corpus(args, split: str = "train"):
    """The token stream of ``split`` and the vocabulary size: with
    ``--data``, the binarized split read through its ``dict.txt``;
    otherwise dummy tokens from ``--seed`` (the JAX CLI's
    ``--dummy-data``): ``--max-tokens`` x 64 for training, x 4 for
    validation, uniform over ``[4, --dummy-vocab)``."""
    if args.dummy_data or not args.data:
        rng = np.random.default_rng(args.seed + (0 if split == "train" else 1))
        n = args.max_tokens * (64 if split == "train" else 4)
        return (rng.integers(4, args.dummy_vocab, size=n).astype(np.int64),
                args.dummy_vocab)
    from efficient_attention_torch.data.dictionary import Dictionary
    from efficient_attention_torch.data.indexed_dataset import MMapIndexedDataset

    vocab = len(Dictionary.load(os.path.join(args.data, "dict.txt")))
    return MMapIndexedDataset(os.path.join(args.data, split)).flat_tokens(), vocab


def build_model(args, vocab_size: int, dense_tokens: bool = False):
    """The LM of ``args`` with weights drawn from ``args.seed``, on the CPU
    in float32; ``--decoder-layers-to-keep`` sets the depth."""
    from efficient_attention_torch.config import namespace_to_dict
    from efficient_attention_torch.models.transformer import (
        TransformerLM,
        init_weights,
    )
    from efficient_attention_torch.training.checkpoint import parse_layers_to_keep

    attn_args = namespace_to_dict(getattr(args, "attn_args_decoder",
                                          argparse.Namespace()))
    cutoffs = None
    if args.criterion == "adaptive_loss":
        cutoffs = tuple(c for c in (int(x) for x in args.adaptive_cutoffs.split(","))
                        if c < vocab_size) or None
    keep = parse_layers_to_keep(args.decoder_layers_to_keep)
    model = TransformerLM(
        vocab_size, embed_dim=args.decoder_embed_dim,
        ffn_dim=args.decoder_ffn_embed_dim,
        num_layers=len(keep) if keep else args.decoder_layers,
        num_heads=args.decoder_attention_heads,
        attn_name=args.attn_name_decoder, attn_args=attn_args,
        dropout=args.dropout, max_len=args.max_len, adaptive_cutoffs=cutoffs,
        adaptive_input=bool(args.adaptive_input and cutoffs),
        tie_adaptive=bool(args.tie_adaptive_weights),
        final_norm=not args.no_decoder_final_norm,
        base_layers=args.base_layers,
        checkpoint_activations=args.checkpoint_activations,
        layerdrop=args.decoder_layerdrop, quant_noise_pq=args.quant_noise_pq,
        quant_noise_pq_block_size=args.quant_noise_pq_block_size,
        activation_fn=args.activation_fn,
        learned_pos=args.decoder_learned_pos, dense_tokens=dense_tokens)
    return init_weights(model, torch.Generator().manual_seed(args.seed))


def make_schedule(args):
    from efficient_attention_torch.training.optim import (
        cosine_tmult_schedule,
        inverse_sqrt_schedule,
        polynomial_schedule,
    )

    if args.lr_scheduler == "inverse_sqrt":
        return inverse_sqrt_schedule(args.lr, args.warmup_updates,
                                     args.warmup_init_lr)
    if args.lr_scheduler == "polynomial":
        return polynomial_schedule(args.lr, args.warmup_updates, args.max_update)
    return cosine_tmult_schedule(
        args.lr, args.warmup_updates, int(args.lr_period_updates),
        t_mult=args.t_mult, min_lr=args.min_lr,
        warmup_init_lr=args.warmup_init_lr, lr_shrink=args.lr_shrink,
        max_steps=args.max_update)


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _print_profile(prof, device, logdir) -> None:
    print(prof.key_averages().table(
        sort_by="self_device_time_total" if device.type == "cuda"
        else "self_cpu_time_total", row_limit=20))
    from efficient_attention_torch.parallel.distributed import is_primary

    if logdir and is_primary():
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def main(args) -> dict:
    """Train; in a process group (joined under ``--distributed`` or
    ``torchrun``, and left again where this call joined it) data-parallel,
    each rank on its rows of the global batch, rank 0 alone printing and
    saving."""
    from efficient_attention_torch.parallel.distributed import run_in_group

    check_ported(args)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    return run_in_group(args, _train)


def _train(args) -> dict:
    import torch.distributed as dist

    from efficient_attention_torch.data.text_data import TokenBlockDataset
    from efficient_attention_torch.parallel import local_rows, make_mesh, shard_model
    from efficient_attention_torch.parallel.distributed import (
        dp_coordinate,
        generator_states,
        is_primary,
        rank_seed,
        restore_generator,
        run_device,
    )
    from efficient_attention_torch.training.checkpoint import (
        CheckpointManager,
        maybe_prune_for_keep,
        parse_layers_to_keep,
    )
    from efficient_attention_torch.training.lm_steps import (
        make_lm_eval_step,
        make_lm_train_step,
    )
    from efficient_attention_torch.training.metrics import MetricLogger
    from efficient_attention_torch.training.optim import make_optimizer
    from efficient_attention_torch.training.train_state import TrainState

    device = run_device(args)
    # float32 means float32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    tokens, vocab_size = load_corpus(args)
    # token blocks only ever carry trailing pads (the last block), which
    # causal attention hides from every real query and the loss masks, so
    # the model takes no padding mask and causal EVA may take K3
    model = build_model(args, vocab_size, dense_tokens=True).to(device)
    mesh = make_mesh(device_type=device.type) if dist.is_initialized() else None
    sharding = None if mesh is None else shard_model(model, mesh)
    dp_rank, dp_size = dp_coordinate(mesh)
    blocks = TokenBlockDataset(tokens, args.tokens_per_sample + 1, pad_idx=1)
    accum = max(1, args.update_freq)
    # the global batch splits into update_freq microbatches that each split
    # over the data-parallel ranks (JAX cli/train_lm.py:497-500)
    quantum = dp_size * accum
    batch_size = max(quantum, (args.max_tokens // args.tokens_per_sample) * accum)
    batch_size -= batch_size % quantum
    optimizer = make_optimizer(args.optimizer, model.named_parameters(),
                               make_schedule(args), weight_decay=0.0,
                               clip_grad=args.clip_norm)
    state = TrainState(model if sharding is None else sharding.model, optimizer,
                       ema_decay=args.ema_decay if args.store_ema else 0.0,
                       sharding=sharding)
    use_adaptive = model.decoder.adaptive_softmax is not None
    train_step = make_lm_train_step(
        pad_idx=1, accum_steps=accum, use_adaptive=use_adaptive,
        compute_dtype=torch.bfloat16 if args.bf16 else None)

    valid_blocks = None
    if not args.disable_validation:
        try:
            vtokens, _ = load_corpus(args, split="valid")
            valid_blocks = TokenBlockDataset(vtokens, args.tokens_per_sample + 1,
                                             pad_idx=1)
        except FileNotFoundError:
            print("| no valid split found; skipping in-train validation")
    eval_step = make_lm_eval_step(use_adaptive=use_adaptive, pad_idx=1)

    def validate() -> dict:
        """Valid-split loss and perplexity, on the float32 parameters (or
        their EMA); data-parallel, rank ``r`` scores batches ``r, r + dp,
        ...`` and the sums are reduced."""
        if valid_blocks is None:
            return {}
        model.eval()
        params = state.ema_params
        nll_sum = tok_sum = 0.0
        vb = max(1, args.max_tokens // args.tokens_per_sample)
        n = (len(valid_blocks) // vb) * vb
        for i in range(dp_rank * vb, n, dp_size * vb):
            batch = torch.from_numpy(np.stack(
                [valid_blocks[j] for j in range(i, i + vb)])).to(device)
            t_in, t_tg = batch[:, :-1], batch[:, 1:]
            mask = torch.ones_like(t_tg, dtype=torch.bool)
            if params is None:
                ns, nt = eval_step(model, t_in, t_tg, mask)
            else:
                ns, nt = eval_step(
                    lambda *a: torch.func.functional_call(model, params, a),
                    t_in, t_tg, mask)
            nll_sum += float(ns)
            tok_sum += float(nt)
        if sharding is not None:
            nll_sum, tok_sum = sharding.all_reduce_dp(torch.tensor(
                [nll_sum, tok_sum], dtype=torch.float64, device=device)).tolist()
        nll = nll_sum / max(tok_sum, 1.0)
        vm = {"valid_loss": nll, "valid_ppl": math.exp(min(nll, 50.0)),
              "valid_batches": n // vb}
        print(f"| valid loss {nll:.3f} ppl {vm['valid_ppl']:.2f}")
        return vm

    generator = torch.Generator(device=device).manual_seed(
        rank_seed(args.seed, mesh))
    order_rng = np.random.default_rng(args.seed)
    order = order_rng.permutation(len(blocks))
    pos = 0

    def advance_order(order, pos):
        if pos + batch_size > len(blocks):
            order, pos = order_rng.permutation(len(blocks)), 0
        return order, pos

    if is_primary():
        os.makedirs(args.save_dir, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(args.save_dir, "ckpt"),
                             keep_last=args.keep_interval_updates,
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
        model.load_state_dict(maybe_prune_for_keep(
            fparams, parse_layers_to_keep(args.decoder_layers_to_keep), "decoder"))
        if state.ema_params is not None:
            state.ema_params = {n: p.detach().clone()
                                for n, p in model.named_parameters()}
        print(f"| finetuning from {args.finetune_from_model} (step {fstep}); "
              "optimizer and schedule reset")
    last = ckpt.latest_step()
    if last:
        # the whole state and the step's generator; the batch order is a
        # function of (seed, step), so it is replayed
        saved = ckpt.load(last)
        state.load_state_dict(saved)
        restore_generator(generator, saved["rng"], mesh)
        for _ in range(last):
            order, pos = advance_order(order, pos)
            pos += batch_size
        print(f"| resumed from checkpoint step {last}")
    logger = MetricLogger()
    t0 = time.time()
    stats: dict = {}
    consec_skips = 0
    best_valid, bad_valids = float("inf"), 0
    validated_at = -1
    prof = None
    while state.step < args.max_update:
        order, pos = advance_order(order, pos)
        idx = order[pos:pos + batch_size]
        pos += batch_size
        batch = local_rows(torch.from_numpy(np.stack(
            [blocks[int(i)] for i in idx])), mesh, accum).to(device)
        if args.profile is not None and state.step == 1 and prof is None:
            prof = _profiler(device)
            prof.start()
        metrics = train_step(state, batch[:, :-1], batch[:, 1:], generator)
        if prof is not None and state.step == 4:
            prof.stop()
            _print_profile(prof, device, args.profile)
            prof = None
        if metrics.skipped is not None and bool(metrics.skipped):
            consec_skips += 1
            print(f"| WARNING: non-finite loss/grad detected, skipping update "
                  f"({consec_skips} consecutive)")
            if consec_skips >= args.max_nonfinite_skips:
                raise FloatingPointError(
                    f"{consec_skips} consecutive non-finite updates; aborting")
            continue
        consec_skips = 0
        step = state.step
        loss = float(metrics.loss)
        logger.update(loss=loss, ppl=math.exp(min(loss, 20)),
                      gnorm=float(metrics.grad_norm))
        if step % args.log_interval == 0:
            wps = step * batch_size * args.tokens_per_sample / (time.time() - t0)
            print(f"| step {step} {logger} | wps {wps:.0f}")
        if not args.no_save and ckpt.should_save(step):
            ckpt.save(step, dict(state.state_dict(),
                                 rng=generator_states(generator)))
        stats = {"step": step, "loss": loss, "ppl": math.exp(min(loss, 20)),
                 "gnorm": float(metrics.grad_norm)}
        if (args.stop_time_hours > 0
                and time.time() - t0 > args.stop_time_hours * 3600):
            print(f"| stopping: --stop-time-hours {args.stop_time_hours} reached")
            break
        if (args.validate_interval_updates > 0
                and step % args.validate_interval_updates == 0):
            vm = validate()
            validated_at = step
            stats.update(vm)
            if args.patience > 0 and "valid_loss" in vm:
                if vm["valid_loss"] < best_valid - 1e-9:
                    best_valid, bad_valids = vm["valid_loss"], 0
                else:
                    bad_valids += 1
                    if bad_valids >= args.patience:
                        print(f"| early stop: valid loss has not improved for "
                              f"{bad_valids} validations (--patience "
                              f"{args.patience})")
                        stats["early_stop"] = True
                        break
    if prof is not None:  # training ended inside the traced steps
        prof.stop()
        _print_profile(prof, device, args.profile)
    if validated_at != state.step:
        stats.update(validate())
    print(json.dumps(stats))
    return stats


def cli_main(argv=None):
    return main(parse_args(argv))


if __name__ == "__main__":
    cli_main()

"""The multi-device dry run: gates 1 and 5 of the JAX package's
``__graft_entry__.py::dryrun_multichip`` over a ``torch.distributed``
process group.

* Gate 1: one ViT train step of the flagship (``evit_tiny_p16`` with 2-D
  EVA, window 2, 4 landmarks, 64 px, depth 2; AdamW behind the clip of 5.0,
  EMA, mixup) on the mesh ``data x fsdp x model``, with ``fsdp = 2`` and
  ``model = 2`` where 4 divides the world (``fsdp = 2`` where 2 does).
* Gate 5: beam search of an EVA / causal-EVA translation model with the
  sentence batch split over the batch axes, each rank decoding its rows
  and the rows gathered back in order (``sharded_generate``).

Gates 2-4 (sequence parallelism, the pipeline, the BASE experts) are slice
B of ROADMAP.md Queue 1, item 7, and are not run here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from efficient_attention_torch.parallel.distributed import dp_coordinate, local_rows
from efficient_attention_torch.parallel.mesh import dp_mesh, make_mesh, shard_model


def gate1_vit_step(world: int, device_type: str = "cpu") -> Dict[str, object]:
    """One sharded ViT train step; returns its loss and the mesh's shape."""
    from efficient_attention_torch.data.mixup import MixupConfig
    from efficient_attention_torch.models.efficient_vit import evit_tiny_p16
    from efficient_attention_torch.models.layers import init_weights
    from efficient_attention_torch.parallel.distributed import rank_seed
    from efficient_attention_torch.training.optim import (
        cosine_schedule,
        make_optimizer,
    )
    from efficient_attention_torch.training.train_state import (
        TrainState,
        make_vit_train_step,
    )

    if world % 4 == 0:
        mesh = make_mesh(fsdp=2, model=2, device_type=device_type)
    elif world % 2 == 0:
        mesh = make_mesh(fsdp=2, device_type=device_type)
    else:
        mesh = make_mesh(device_type=device_type)
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    num_classes, img = 16, 64  # a 4x4 token grid: EVA window 2, 4 landmarks
    model = evit_tiny_p16(
        attn_name="eva", num_classes=num_classes, depth=2, img_size=img,
        attn_args={"window_size": 2, "num_landmarks": 4, "attn_2d": True,
                   "use_rpe": True, "adaptive_proj": "default"})
    init_weights(model, torch.Generator().manual_seed(0))
    sharding = shard_model(model.to(device), mesh)
    schedule = cosine_schedule(1e-3, warmup_steps=10, total_steps=100)
    opt = make_optimizer("adamw", model.named_parameters(), schedule,
                         weight_decay=0.05, clip_grad=5.0)
    state = TrainState(sharding.model, opt, ema_decay=0.999, sharding=sharding)
    step = make_vit_train_step(MixupConfig(num_classes=num_classes),
                               num_classes=num_classes)
    batch = 2 * world
    images = torch.zeros((batch, img, img, 3), device=device)
    labels = torch.zeros((batch,), dtype=torch.int64, device=device)
    generator = torch.Generator(device=device).manual_seed(rank_seed(1, mesh))
    metrics = step(state, local_rows(images, mesh), local_rows(labels, mesh),
                   generator)
    loss = float(metrics.loss)
    if loss != loss:
        raise FloatingPointError("NaN loss in the dry run's ViT step")
    shape = {name: mesh[name].size() for name in ("data", "fsdp", "model", "seq")}
    return {"loss": loss, "mesh": shape, "sharded": sharding.log}


def mt_gate_model():
    """Gate 5's translation model: a 2-layer EVA encoder (1-D windows of 4
    with a halo, T5 bias) and causal-EVA decoder, shared embeddings."""
    from efficient_attention_torch.models.transformer import (
        TransformerModel,
        init_weights,
    )

    model = TransformerModel(
        src_vocab_size=67, tgt_vocab_size=67, embed_dim=32, ffn_dim=64,
        num_layers=2, num_heads=2, attn_name_encoder="eva",
        attn_args_encoder={"window_size": 4, "num_landmarks": 4,
                           "overlap_window": True, "use_t5_rpe": True,
                           "adaptive_proj": "no-ln", "attn_2d": False,
                           "use_rpe": False},
        attn_name_decoder="causal_eva",
        attn_args_decoder={"window_size": 4, "chunk_size": 2,
                           "adaptive_proj": "qk", "use_t5_rpe": True,
                           "causal": True},
        dropout=0.0, max_len=128, share_all_embeddings=True)
    return init_weights(model, torch.Generator().manual_seed(0)).eval()


@torch.no_grad()
def beam_generate(model, src: torch.Tensor, vocab: int = 67, beam: int = 2,
                  max_len: int = 24, len_penalty: float = 0.6
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search of ``model`` over the sentences ``src`` ``[B, S]``:
    ``(tokens [B, K, L+1], scores [B, K])``, best first."""
    from efficient_attention_torch.generation.beam_search import SequenceGenerator

    enc_out, enc_pad = model.encode(src)
    enc_out_k = enc_out.repeat_interleave(beam, dim=0)
    enc_pad_k = enc_pad.repeat_interleave(beam, dim=0)

    def step_fn(states, tokens, step):
        logits, states = model.decode_step(states, tokens, step, None, enc_pad_k)
        return logits[:, 0], states

    def init_cache(bk, length):
        return model.init_decode_state(bk, length, torch.float32, src.device,
                                       enc_out=enc_out_k)

    gen = SequenceGenerator(step_fn, init_cache, vocab_size=vocab,
                            beam_size=beam, max_len=max_len,
                            len_penalty=len_penalty)
    return gen.generate(src.shape[0], device=src.device)


@torch.no_grad()
def sharded_generate(model, src: torch.Tensor, mesh, **kw
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`beam_generate` with the global sentence batch ``src`` split
    over the batch axes (``local_rows``): each rank decodes its rows, and
    the rows come back gathered in the global order on every rank."""
    tokens, scores = beam_generate(model, local_rows(src, mesh), **kw)
    _, size = dp_coordinate(mesh)
    if size == 1:
        return tokens, scores
    group = dp_mesh(mesh).get_group()
    out = []
    for t in (tokens, scores):
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t.contiguous(), group=group)
        out.append(torch.cat(parts))
    return tuple(out)


def gate5_generate(world: int, device_type: str = "cpu") -> Dict[str, object]:
    """Data-sharded beam search of one sentence a rank."""
    mesh = make_mesh(device_type=device_type)
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    model = mt_gate_model().to(device)
    src = torch.full((world, 16), 5, dtype=torch.int64, device=device)
    tokens, scores = sharded_generate(model, src, mesh)
    if tokens.shape[:2] != (world, 2):
        raise AssertionError(f"generated {tuple(tokens.shape)}")
    if not bool(torch.isfinite(scores).any()):
        raise AssertionError("no finished hypotheses")
    return {"tokens": tuple(tokens.shape)}


def dryrun_multichip(world: int = None, device_type: str = "cpu") -> Dict[str, object]:
    """Gates 1 and 5 over the default process group (which must exist), on
    ``world`` ranks (default: the group's size); every rank calls it."""
    world = dist.get_world_size() if world is None else world
    out = {"gate1": gate1_vit_step(world, device_type)}
    print(f"dryrun_multichip({world}) gate 1 OK: loss={out['gate1']['loss']:.4f}, "
          f"mesh={out['gate1']['mesh']}")
    out["gate5"] = gate5_generate(world, device_type)
    print(f"dryrun_multichip({world}) gate 5 OK: tokens={out['gate5']['tokens']}")
    return out

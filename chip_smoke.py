#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

Run from the root of a checkout:  python3 chip_smoke.py

The models, random weights from a seed:

* DeiT-tiny-p8 (``evit_tiny_p8``, 224 px, 28x28 tokens, dim 192, 3 heads,
  12 blocks) with 2-D EVA (window 7, 49 landmarks, learned RPE,
  ``adaptive_proj='default'``).  Its eval forward (serving) runs
  ``eva_single`` (K2) in every block; its training step runs
  ``eva_packed``'s forward and backward kernels (K1), and the end-of-epoch
  eval K2.  The same cell is also served through each of EVA's eval routes
  (the attention args ``use_single_kernel``, ``use_megakernel``,
  ``use_pallas_summaries``, ``fuse_output_proj``; ``EVA_ROUTES``): K1's
  forward, ``eva_summaries`` (K8) + K1, ``eva_packed_out`` (K9), K8 + K9,
  the two ``eva_mega`` kernels (K10), and K2 again where only the megakernel
  toggle is set (K2 is tried first); and through the JAX module's other
  ``impl`` routes: ``impl='pallas'`` runs ``eva_kernel`` (K11) on the
  partitioned windows, ``impl='rowmajor'`` ``eva_rowmajor`` (K12) on the
  token-order q, k, v, one launch a block, in eval and in training;
* PVTv2-B3 (``pvt_medium2``, 224 px, 4 stages of 3/4/18/3 blocks, dims
  64/128/320/512, heads 2/4/10/16) with the same 2-D EVA in its first three
  stages (56x56, 28x28 and 14x14 tokens, head dim 32) and exact softmax in
  the last, served at batch 128 in bf16 at ``impl`` ``auto`` (K2 in each of
  the 25 EVA blocks), ``pallas`` (K11) and ``rowmajor`` (K12);
* the same DeiT-tiny-p8 served with the zoo's other attentions that reach a
  kernel, each at batch 128 in bf16: LARA (mis-opt, ``pool-mixed``, alpha
  2.0, 49 landmarks) through ``lara_fused`` (K5), Performer (FAVOR+, 64
  features) through ``performer_fused`` (K6), exact 2-D local attention
  (window 7, learned RPE) through ``local_packed`` (K7), one launch a block;
* ``transformer_lm_wiki103`` (16 decoder layers, d=1024, ffn 4096, 8 heads
  of 128, adaptive input and tied adaptive softmax over 267,744 words) with
  causal EVA (window 128, chunk 8, ``adaptive_proj='qk'``, T5 bias), the
  WikiText-103 recipe at B = 18 x 512 tokens in bf16 with NAG, cosine and
  clip 0.1, on dummy tokens, dropout 0.  Its training step runs
  ``causal_packed``'s forward and backward kernels (K3) in every layer (on
  float32 activations: the adaptive input sums into float32, as in JAX),
  the forward and the backward on their split-TF32 tensor-core routes; its
  validation (on the float32 parameters) runs the K3 forward.  The same
  recipe also trains on a binarized corpus written from a seed, saves and
  resumes its checkpoints, and ``cli.eval_lm`` scores the test split from
  the checkpoint, eager (no kernel);
* ``transformer_wmt_en_de`` (6 + 6 layers, d=512, ffn 2048, 8 heads of 64,
  post-LN, shared embeddings over a joint vocabulary of 32,768 types) with
  1-D EVA in the encoder (window 8 with a halo of 4, 8 landmarks, T5 bias,
  ``adaptive_proj='no-ln'``) and causal EVA in the decoder (window 16,
  chunk 8, ``qk``), the WMT14 EN-DE recipe, served in f32 by
  ``cli.generate`` (beam 4, lenpen 0.6) on 256 dummy sentences in batches
  of 64.  Every encoder layer runs ``eva_1d`` (K4) on its f32 route
  (split-TF32 mma.sync strips); the decoder steps one token at a time with
  no kernel.  The same model is trained by ``cli.train_mt`` with the
  recipe's flags (``main.sh:103-110``: fairseq Adam (0.9, 0.98), lr 7e-4,
  inverse-sqrt warmup 6000, label smoothing 0.1, token budgets of 4096,
  f32 at dropout 0.1) for 8 updates on the 512 dummy pairs, validating and
  scoring in-train BLEU (beam 4, lenpen 0.6, 64 sentences in chunks of 8) at
  every epoch's end.  Training launches no kernel: the encoder's EVA trains
  eager, and the decoder's target padding mask and dropout keep causal EVA
  off K3, as in JAX; validation and BLEU run K4 in every encoder layer, on
  its f32 route.  The same recipe also runs from text to BLEU on a
  bilingual corpus written from a seed: preprocessed with a joined
  dictionary of 32,768 symbols, trained with checkpoints and resumed,
  translated by ``cli.generate`` from the average of the kept checkpoints
  into a fairseq gen.out, scored by ``scripts/torch_compound_split_bleu.sh``;
  ``cli.validate`` scores the LM's and MT's valid splits from their
  checkpoints;
* the same DeiT-tiny-p8 with the zoo's attentions that reach no kernel, RA
  and ScatterBrain, and the headline EVA with the ``conv`` and ``hmlp``
  patchify stems and with the JAX factory's other optimizers.

Phases, each raising on failure:

1. build: compile every kernel with nvcc (one process per source, all at
   once) and print the seconds, each kernel's registers and spills, and for
   ``eva_packed``'s tensor-core forward and backward, the tensor-core
   routes of ``eva_single``, ``eva_kernel`` and ``eva_rowmajor``,
   ``local_packed``'s tensor-core route and ``causal_packed``'s split-TF32
   forward and backward the blocks an SM (no spills allowed there), and
   for the tensor-core route of ``eva_packed_out`` and ``eva_mega``'s
   attention (``eva_out_mma_kernel``) the blocks an SM and the layout its
   plan picks, and for ``lara_fused``'s cluster route the clusters that fit
   the card at once (no spills allowed there), and for the persistent route
   of ``eva_summaries`` and ``eva_mega``'s summaries
   (``eva_summaries_mma_kernel``, ``eva_summaries_ws_kernel``) the
   registers (no spills allowed), the layout ``mma_plan`` picks at each
   ``SUM_CHECKS`` geometry and the blocks an SM that fit it, and for
   ``performer_fused``'s ring route (``performer_fused_ring_kernel``) the
   registers (at most 64 bytes of spills), the wrapper's copy of its
   layout and grid at several layouts and the blocks an SM of the layout
   ``plan`` picks at the Performer cell's shape;
   the wrappers' twins of the kernels' shared-memory layouts and route
   choices (``lara_fused``'s plan over a sweep of geometries);
2. kernels against their plain versions on the card: ``eva_single`` (its
   tensor-core route in bf16 at ``K2_CHECKS``, with and without its bias
   and LN, the CUDA-core kernel forced beside it, and both types at
   large-norm keys);
   ``eva_packed``'s forward and its four gradients; ``causal_packed``'s
   forward and its six gradients; ``lara_fused``, ``performer_fused`` and
   ``local_packed``; ``lara_fused``'s bf16 routes at ``K5_CHECKS`` (each
   asserted on its route); ``performer_fused`` at ``K6_CHECKS`` (the ring
   route where ``plan`` takes the geometry, the wmma or CUDA-core kernel
   where it does not, each launch asserted on its route, within one bf16
   rounding of each output's peak); ``eva_1d`` at non-pad rows of random-length
   sentences at ``K4_CHECKS``, f32 on the split-TF32 route and bf16 on the
   CUDA-core kernel (each launch asserted on its route), and f32 on the
   CUDA-core kernel too (``config=0``); ``eva_summaries``, ``eva_packed_out`` and ``eva_mega``'s two
   entry points, and the last two's attention on its bf16 tensor-core route
   at ``OUT_CHECKS``, with and without the bias (asserted on the route);
   ``eva_summaries`` and ``eva_mega``'s summaries in bf16 at ``SUM_CHECKS``,
   each output within 2**-7 of its peak, on the persistent route exactly
   where ``mma_plan`` takes the geometry (asserted); ``eva_kernel`` and
   ``eva_rowmajor`` (also at PVT-B3's three stages, at heads of 48, where
   S + C is too wide for one-pass strips, K11 in 1-D, and raising outside
   their gates; K11's output,
   merged to token order, equal to K12's bit for bit); at the main
   paths' shapes in bf16 and f32 and at small odd geometries (K3-K12 in
   both types), and K8 at large-norm keys; K1 also at PVT-B3's first stage,
   without a bias where S + C is not a multiple of 16, and where S + C is
   too wide for its one-pass strips (its forward and backward on the
   tensor-core routes in bf16 at head dims 16, 32 and 64, asserted), and
   its CUDA-core forward and backward in bf16 at the main shape; K3's
   f32 forward and backward on their split-TF32 routes (asserted) and,
   forced, on the CUDA-core kernels, bf16 on the CUDA-core kernels
   (asserted); ``local_packed`` also at ``K7_CHECKS``, with and without
   its bias, bf16 at head dims 16, 32 and 64 on its tensor-core route
   (ws 11: two passes), f32 and head dim 12 off it (asserted);
3. the LM training path: ``cli.train_lm`` for 8 steps with the recipe's
   flags, then its validation, counts set to 0 just before and read just
   after (16 x 8 launches of each K3 kernel in training, 16 a validation
   batch, every forward and backward on the split-TF32 routes), finite
   losses, the peak
   device memory; then the f32 gradients of a 2-layer full-width LM, kernel
   path against eager path; then the LM protocol from text to perplexity
   (``lm_protocol_phase``): a corpus written from a seed (``LM_DATA_TOKENS``,
   every one of the 267,740 word types in the train split) binarized by
   ``cli.preprocess`` (a dictionary of exactly 267,744 symbols),
   ``cli.train_lm --data`` for 8 updates with checkpoints every 4 (the K3
   launches predicted from the code: a forward and a backward a layer an
   update, a forward a layer a validation batch, all on the split-TF32
   routes; step 8 kept, its parameters restored bit for bit with the tied
   adaptive weights shared), resumed to 10 from step 8, ``cli.eval_lm``
   from the checkpoint at context windows 0, 256 and 480 (no kernel, as in
   JAX: its decoder takes the padding mask; the tokens scored as
   ``context_window_blocks`` predicts; tokens/s of the eval steps, wall
   time, peak memory), and the eval step's per-token NLL of a 2-layer
   full-width model on 4 x 513 tokens at window 256, card against CPU,
   within 1e-4 of the largest; a compact JSON line of its figures;
4. the ViT serving path: ``cli.train_vit --eval`` in-process at batch 128
   in bf16, with the kernels' launch counts set to 0 just before and read
   just after (all 48 K2 launches on its tensor-core route), the same for
   the tracked DeiT-tiny-p16 cell (``P16_ARGV``), then f32 logits of the
   kernel path against the eager path;
   the same for the LARA, Performer and local cells (12 launches of the
   cell's kernel a batch and none of any other; the LARA cell's all on K5's
   cluster route, the Performer cell's on K6's ring route, the local cell's
   on K7's tensor-core route), and for each
   of EVA's
   routes (12 launches of each of the route's kernels a batch and none of
   any other, K1's forward, K9 and K10's attention on their tensor-core
   routes, K8 and K10's summaries on their persistent route); K11 as EVA's
   ``auto`` fallback at a head dim (48) that K1
   and K2 are not built for, in eval and training, against the eager path
   in f32; then PVT-B3 served by ``cli.train_vit --eval`` on each of its
   three routes (25 launches of the route's kernel a batch, none of any
   other) and its f32 logits on each route against the eager path;
5. the MT serving path: ``cli.generate`` in-process with the recipe's
   flags, counts set to 0 just before and read just after (6 K4 launches a
   batch, 4 batches, all on the f32 route, none of any other kernel), a
   finite BLEU; then f32
   encoder states of the kernel path against the eager path at non-pad
   positions, and the share of identical 1-best hypotheses of the two;
6. the MT training path: ``cli.train_mt`` in-process with the recipe's
   flags for 8 updates, every kernel's count set to 0 just before and read
   just after (none in training; 6 K4 launches a validation batch and 6 a
   BLEU chunk, all on the f32 route, as many as the epochs that the 8
   updates take, the validation batches and the chunks predict), finite
   losses, validation loss and BLEU, the updates/s and target tokens/s of
   steps 2-8 (CUDA events around each step) and the peak device memory;
   then the f32 validation sums and the encoder states (at non-pad
   positions) of every validation batch and BLEU chunk, kernel path against
   eager path, and one step's f32 gradients of a 2-layer full-width model (eval mode,
   eager encoder), the card against the CPU; then the MT protocol from text
   to BLEU (``mt_protocol_phase``): a bilingual corpus written from a seed
   (``MT_DATA_PAIRS``, 32,764 word types, some ``@@`` pieces and
   hyphenated compounds) binarized by ``cli.preprocess -s en -t de
   --joined-dictionary`` (32,768 symbols), ``cli.train_mt --data`` for 8
   updates with checkpoints every 2 (written at 1, 2, 4, 6, 8; the newest 3
   kept; step 8's whole state restored bit for bit, the shared embedding
   one tensor) and validation with BLEU over words every 4, resumed to 10,
   ``cli.generate --path --num-avg-checkpoints 3 --remove-bpe
   --results-path`` over the first ``MT_GEN_SENTENCES`` test sentences (the
   average equal to the CPU average of the three bit for bit, one ``H-``
   line a sentence and the BLEU line last) and the compound-split script
   over its gen.out; K4's launches in each call predicted from the code,
   all on the f32 route; the averaged model's encoder states, K4 route
   against the eager path; a compact JSON line of its figures;
7. the ViT training path: ``cli.train_vit`` for 8 steps at batch 128 with
   ``--bf16`` and the DeiT recipe, counts set to 0 just before and read
   just after (12 x 8 launches of each K1 kernel, every forward and
   backward on the tensor-core routes, 12 x 4 of K2), finite
   losses; then f32 gradients, kernel path against eager path; the same
   with ``impl='pallas'`` and ``impl='rowmajor'`` (12 x 8 + 12 x 4
   launches of K11 or K12, none of any other);
7b. the ImageNet recipe from an image folder (``vit_protocol_phase``): a
   folder written from a seed (1000 classes, 2 train JPEGs and 1 val JPEG
   a class, 500x375 and 375x500), ``cli.train_vit`` with ``main.sh -d
   imagenet``'s flags (``--repeated-aug --model-ema --clip-grad 5.0``) in
   bf16 for 2 epochs of 4 steps (K1's forward and backward 12 x 8 on the
   tensor-core routes, K2 12 x 8 val batches x 2 epochs on the f32 route,
   every val image scored, checkpoints at 4 and 8), resumed to epoch 3
   (the restored state, generator included, equal to the file bit for bit;
   steps [4, 8, 12] kept), ``--eval --resume`` (all 1000 val images, K2
   12 x 8 on its tensor-core route); 8 steps on each loader (synthetic,
   the folder on threads and on spawned processes, the uint8 cache, its
   build timed) with images/s and the host's gap between steps; PVTv2-B3
   4 steps at batch 128 with and without ``--checkpoint-activations`` (K1's
   forward 25 x 4 x 2 or x 1, its backward 25 x 4), peak memory and
   images/s; a compact JSON line of its figures;
7c. the rest of the zoo (``zoo_phase``) at the headline's width and depth:
   RA (one key drawn a query), ScatterBrain (window 7 with RPE, 64
   features) and the headline EVA with the ``conv`` and ``hmlp`` stems
   served at B=128 bf16 (finite logits, K2 12 launches a forward on its
   tensor-core route with a stem, none of any kernel for RA and
   ScatterBrain; images/s by ``compute_throughput`` and the peak memory),
   the same f32 models at B=2 on the card and on the CPU (RA with the same
   key indices) within 1e-4; 4 CLI steps at B=128 ``--bf16`` of each and
   of the headline EVA with each of the JAX factory's ``sgd``,
   ``adafactor``, ``adagrad``, ``adadelta``, ``adamax`` and ``lamb`` (K1
   48 + 48 on the tensor-core routes and K2 48 in the f32 eval of every EVA
   run; updates/s from CUDA events around each step, the peak memory); one
   optimizer step of the headline's parameters for each and AdamW;
   ``cli.validate --task mt`` over the MT protocol's 3,000 valid pairs
   from its newest checkpoint (K4 6 launches a batch of 16, on the f32
   route) and ``--task lm`` over the LM protocol's valid split (no
   kernel), from the directories phases 3b and 6b leave for it; a compact
   JSON line of its figures;
7d. the mesh on ``torch.distributed`` with the one card
   (``scaleout_phase``): ``cli.train_mt --distributed --num-processes 1``
   on its own NCCL group for 8 updates (K4 as its validations predict, on
   the f32 route; updates/s); on an in-process NCCL group of one rank the
   headline train step at B=128 bf16 unwrapped and through DDP, FSDP2, TP
   and FSDP2 + TP (``parallel.shard_model`` on a mesh of ones), each 2
   checked steps at the recipe's rate after warmup (losses within 2**-7
   and gradient norms within 1e-3 relative of the unwrapped step's, the
   parameters' change within ``SCALEOUT_UPDATE_TOL`` of its change; K1 12
   + 12 a step) and 10 timed ones (images/s, the unwrapped step timed
   first and last, peak memory); two planted faults the check must refuse
   (rank 0's rows alone, DDP summing); the LM cell's step under DDP (K3 16
   + 16, tokens/s); two gloo ranks on the card (``--scaleout-rank``), the
   headline step under DDP at 64 rows a rank, held to the unwrapped step
   by the same check, the ranks' parameters equal; rates that need two
   cards are not measured; a compact JSON line of its figures;
8. timings with CUDA events (kernels, plain versions, bounds, SDPA
   yardsticks; K2 at ``K2_SHAPES`` on both routes and K8 + K1 on the same
   inputs in turns; one headline forward by op
   with K2's share and the idle share; the DeiT-tiny-p16 cell's images/s
   with the eager path in turns; K1's forward and backward on both routes, K3 in bf16 and in
   the f32 the LM step runs, its f32 forward and backward on both routes
   in turns; forward and
   train-step rates of both models, the forward
   rates of the three serving cells, K6 in turns with the kernel its ring
   route replaced (``config=0``), K6 against the eager Performer at 784
   and 3136 tokens, K8-K10 (K9 and K10's attention in turns with their
   yardsticks: K1's forward and an addmm, an addmm and K9; K8 and K10's
   summaries in turns with the first kernel forced, K10's also with an
   addmm and K8) and the forward
   rates of EVA's eval routes in
   turns with the default route and the eager path, K4 (in f32 in turns
   with the CUDA-core kernel it replaced, ``config=0``) and the MT encoder,
   the MT cell's sentences/s and hypothesis tokens/s with the kernel and the
   eager encoder in turns, K11 and K12 at the headline and PVT-B3 stage
   shapes, the headline train step on K11 against K1, PVT-B3's forward
   images/s on its routes and the eager path in turns; K7 and SDPA in
   turns, with K7's device time) and profiles of 3 train steps of each
   model, of one LARA-cell, one Performer-cell and one local-cell forward,
   one
   ``two-kernel``-route forward (K1's forward alone), one megakernel-route
   forward (with K10's summaries' share), one PVT-B3 forward on K11 and one
   MT batch by op;
9. the kernels line, the script's wall time, the card line, and the result
   line, last.

It exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
import copy
import json
import math
import re
import shutil
import subprocess
import sys
import time
from unittest import mock

MAIN_ARGV = [
    "--model", "evit_tiny_p8", "--attn-name", "eva",
    "--attn-window-size", "7", "--attn-num-landmarks", "49",
    "--attn-attn-2d", "--attn-use-rpe", "--attn-adaptive-proj", "default",
    "--input-size", "224", "--batch-size", "128", "--seed", "0",
    "--device", "cuda",
]
HBM_BYTES_PER_S = 3.35e12          # H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# tolerances of kernel vs plain version on the same card inputs: f32 differs
# only in summation order; bf16 also by one rounding of outputs below 4,
# whose bf16 spacing is at most 2**-6
TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2 ** -6}
# f32 logits, kernel path vs eager path, through 12 blocks
LOGITS_TOL = 1e-4
# eva_packed vs its plain version, relative to the largest |value| of each
# output (at least 1): f32 differs in summation order (and, in the
# backward's drf/dbeta/dbias sums, the order of f32 atomics); bf16 also by
# one rounding of each output, one bf16 spacing (2**-7 relative) at most
K1_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2 ** -7}
# f32 parameter gradients, kernel path vs eager path, through 12 blocks,
# relative to the largest |gradient| (at least 1)
GRAD_TOL = 1e-4
# the three shapes every kernel is checked at: (B, grid side, window,
# chunk side, heads, head dim) and the dtype
CHECKS = (("main bf16", (128, 28, 7, 4, 3, 64), "bfloat16"),
          ("main f32", (128, 28, 7, 4, 3, 64), "float32"),
          ("golden f32", (2, 14, 7, 2, 4, 12), "float32"))
# K1 is also checked, with its bias or without, at PVT-B3's first stage
# (heads of 32), where S + C (16 + 4) is not a multiple of 16, and where
# S + C (49 + 196) is too wide for a strip to stay in registers (its strips
# then take two passes), all on the forward's and backward's tensor-core
# routes
K1_CHECKS = tuple((label, geo, dtype, True) for label, geo, dtype in CHECKS) + (
    ("pvt stage 1 bf16", (128, 56, 7, 8, 2, 32), "bfloat16", True),
    ("odd no-bias bf16", (3, 8, 4, 4, 3, 16), "bfloat16", False),
    ("two-pass bf16", (8, 28, 7, 2, 2, 16), "bfloat16", True))
# K9 and K10's attention on their bf16 tensor-core route, each with its bias
# and without: the headline shape, K1's other bf16 geometries (PVT-B3's
# first stage, the odd one, strips of two passes), PVT-B3's third stage,
# whose ten heads are staged a few at a time with Wo streamed, and the small
# and base EVA ViTs (6 and 12 heads of 64), whose window rows are staged a
# few heads at a time beside a buffer of attention rows
OUT_CHECKS = (("main bf16", CHECKS[0][1]),) + tuple(
    (label, geo) for label, geo, _, _ in K1_CHECKS[len(CHECKS):]) + (
    ("pvt stage 3 bf16", (16, 14, 7, 2, 10, 32)),
    ("evit_small p8 bf16", (16, 28, 7, 4, 6, 64)),
    ("evit_base p16 bf16", (16, 14, 7, 2, 12, 64)))
TRAIN_ARGV = ["--bf16", "--epochs", "1", "--max-steps-per-epoch", "8",
              "--warmup-epochs", "0", "--output-dir", "build/smoke_train"]
# the WikiText-103 recipe (configs/wikitext103_causal_eva.yaml's attention
# flags, spelled out) on dummy tokens of the real vocabulary, 8 updates
LM_VOCAB = 267744
LM_ARGV = [
    "--arch", "transformer_lm_wiki103", "--attn-name-decoder", "causal_eva",
    "--decoder-attn-window-size", "128", "--decoder-attn-chunk-size", "8",
    "--decoder-attn-adaptive-proj", "qk", "--decoder-attn-use-t5-rpe",
    "--decoder-attn-causal", "--tokens-per-sample", "512",
    "--max-tokens", "9216", "--optimizer", "nag", "--lr-scheduler", "cosine",
    "--clip-norm", "0.1", "--criterion", "adaptive_loss", "--bf16",
    "--dummy-data", "--dummy-vocab", str(LM_VOCAB), "--dropout", "0",
    "--seed", "0", "--device", "cuda", "--save-dir", "build/smoke_lm",
]
LM_TRAIN_ARGV = ["--max-update", "8", "--log-interval", "1", "--no-save"]
# the same recipe on a corpus written from a seed and binarized by
# cli.preprocess: 267,740 word types (with the 4 specials, the recipe's
# vocabulary), each once in the train split, then Zipf(1.1) draws over the
# types, in lines of 8-64 words; 800,000 / 65,536 / 16,384 tokens (each
# line's end of sentence included) in the train / valid / test splits
LM_DATA_DIR = "build/smoke_lm_data"
LM_DATA_TOKENS = {"train": 800_000, "valid": 65_536, "test": 16_384}
LM_DATA_ARGV = [a for a in LM_ARGV if a not in (
    "--dummy-data", "--dummy-vocab", str(LM_VOCAB), "--save-dir", "build/smoke_lm")] + [
    "--data", f"{LM_DATA_DIR}/bin", "--save-dir", f"{LM_DATA_DIR}/save"]
LM_DATA_TRAIN_ARGV = ["--log-interval", "1", "--save-interval-updates", "4",
                      "--keep-interval-updates", "1"]
LM_EVAL_WINDOWS = (0, 256, 480)
LM_EVAL_CHECK_WINDOW = 256
# per-token NLL of eval_lm's step, the card against the CPU, relative to
# the largest |NLL|
LM_EVAL_TOL = 1e-4
# the LARA, Performer and local serving cells: the ViT flags with each
# attention's recipe flags (LARA: SURVEY.md:419, reference README.md:104-145)
CELL_ARGV = [
    "--model", "evit_tiny_p8", "--input-size", "224", "--batch-size", "128",
    "--seed", "0", "--device", "cuda",
]
CELLS = {
    "lara": ["--attn-name", "lara", "--attn-num-landmarks", "49",
             "--attn-proposal-gen", "pool-mixed", "--attn-mis-type", "mis-opt",
             "--attn-alpha-coeff", "2.0"],
    "performer": ["--attn-name", "performer", "--attn-approx-attn-dim", "64",
                  "--attn-proj-method", "favorp"],
    "local": ["--attn-name", "local", "--attn-window-size", "7",
              "--attn-attn-2d", "--attn-use-rpe"],
}
# EVA's eval routes on the serving cell (JAX attention/eva.py:567-585): the
# attention args that select each, the others at their defaults, and the
# kernels each launches in every block.  K2 is tried before K10, so the
# megakernel toggle alone still runs K2.
EVA_ROUTES = {
    "megakernel alone": ({"use_megakernel": True}, ("eva_single",)),
    "two-kernel": ({"use_single_kernel": False}, ("eva_packed_fwd",)),
    "summaries": ({"use_single_kernel": False, "use_pallas_summaries": True},
                  ("eva_summaries", "eva_packed_fwd")),
    "fused-out": ({"use_single_kernel": False, "fuse_output_proj": True},
                  ("eva_packed_out",)),
    "summaries+fused-out": ({"use_single_kernel": False,
                             "use_pallas_summaries": True,
                             "fuse_output_proj": True},
                            ("eva_summaries", "eva_packed_out")),
    "megakernel": ({"use_single_kernel": False, "use_megakernel": True},
                   ("eva_summaries_from_x", "eva_attention_from_x")),
    # JAX's other impl routes (attention/eva.py:595-793)
    "pallas": ({"impl": "pallas"}, ("eva_kernel",)),
    "rowmajor": ({"impl": "rowmajor"}, ("eva_rowmajor",)),
}
# K11/K12 geometries (B, heads, grid rows, grid width, window, chunks, head
# dim) and whether a bias is given: the headline cell, PVT-B3's three EVA
# stages, the auto fallback's heads of 48, a geometry whose strips take two
# passes (S + C = 64 + 64 > 112) and a small rectangular grid
WIN_CHECKS = (("main bf16", (128, 3, 28, 28, 7, 49, 64), "bfloat16", True),
              ("main f32", (128, 3, 28, 28, 7, 49, 64), "float32", True),
              ("pvt stage 1 bf16", (128, 2, 56, 56, 7, 49, 32), "bfloat16", True),
              ("pvt stage 2 bf16", (128, 4, 28, 28, 7, 49, 32), "bfloat16", True),
              ("pvt stage 3 bf16", (128, 10, 14, 14, 7, 49, 32), "bfloat16", True),
              ("heads of 48 bf16", (16, 2, 28, 28, 7, 49, 48), "bfloat16", True),
              ("two-pass bf16", (8, 2, 32, 32, 8, 64, 64), "bfloat16", True),
              ("small f32", (3, 3, 8, 12, 4, 6, 16), "float32", False),
              ("small bf16", (3, 3, 8, 12, 4, 6, 16), "bfloat16", False))
# PVTv2-B3 (the reference's second ImageNet recipe, main.sh -m pvt_medium2
# -a eva) with the headline cell's EVA flags, served by cli.train_vit
PVT_ARGV = [
    "--model", "pvt_medium2", "--attn-name", "eva",
    "--attn-window-size", "7", "--attn-num-landmarks", "49",
    "--attn-attn-2d", "--attn-use-rpe", "--attn-adaptive-proj", "default",
    "--input-size", "224", "--batch-size", "128", "--seed", "0",
    "--device", "cuda",
]
PVT_EVA_BLOCKS = 3 + 4 + 18
# its routes: the impl on the attention args and the kernel of each EVA block
PVT_ROUTES = {"auto": "eva_single", "pallas": "eva_kernel",
              "rowmajor": "eva_rowmajor"}
# its EVA stages at 224 px (B, heads, grid side, head dim)
PVT_STAGES = (("pvt stage 1", (128, 2, 56, 32)), ("pvt stage 2", (128, 4, 28, 32)),
              ("pvt stage 3", (128, 10, 14, 32)))
# the ImageNet recipe from an image folder (main.sh -d imagenet -p DIR,
# main.sh:30-48): a folder written from a seed with ImageNet's 1000 classes
# (wnid-like names), smooth random JPEGs (quality 90) of 500x375 and
# 375x500 pixels, 2 train images and 1 val image a class (1000 val images
# at batch 128: a partial last batch of 104)
VIT_DATA_DIR = "build/smoke_imagenet"
VIT_DATA_PER_CLASS = {"train": 2, "val": 1}
VIT_RECIPE_ARGV = MAIN_ARGV + [
    "--epochs", "300", "--lr", "5e-4", "--warmup-epochs", "10",
    "--clip-grad", "5.0", "--repeated-aug", "--model-ema",
    "--data-set", "IMAGENET", "--data-path", VIT_DATA_DIR,
    "--bf16", "--max-steps-per-epoch", "4", "--num-workers", "8"]
VIT_OUT_DIR = "build/smoke_vit_protocol"
# the rest of the attention zoo at the headline's width and depth (zoo_phase):
# RA (one key drawn a query) and ScatterBrain (the local cell's window 7
# with RPE and the Performer cell's 64 features), and the headline EVA with
# the conv and hmlp patchify stems, served at B=128 bf16 and trained 4 CLI
# steps; the headline EVA trained with each optimizer of the JAX factory
# that the earlier phases do not run
ZOO_CELLS = {
    "ra": CELL_ARGV + ["--attn-name", "ra", "--attn-num-samples", "1"],
    "scatterbrain": CELL_ARGV + ["--attn-name", "scatterbrain", "--attn-window-size", "7",
                                 "--attn-attn-2d", "--attn-use-rpe",
                                 "--attn-approx-attn-dim", "64"],
    "conv stem": MAIN_ARGV + ["--patchify-stem", "conv"],
    "hmlp stem": MAIN_ARGV + ["--patchify-stem", "hmlp"],
}
# the zoo's other paths, held card against CPU only (f32, B=2): the
# headline EVA with a halo (eager) and with T5 RPE (K2 takes its bias at
# eval), and ScatterBrain with a halo
ZOO_CHECK_CELLS = {
    "eva halo": MAIN_ARGV + ["--attn-overlap-window"],
    "eva t5 rpe": [a for a in MAIN_ARGV if a != "--attn-use-rpe"] + ["--attn-use-t5-rpe"],
    "scatterbrain halo": ZOO_CELLS["scatterbrain"] + ["--attn-overlap-window"],
}
# attention modules alone at the headline's width (dim 192, 3 heads), f32
# B=2, card against CPU: (factory name, arguments, token shape, with a
# key-padding mask); 1000 tokens are no multiple of the 1-D window
ZOO_EVA_ARGS = dict(dim=192, num_heads=3, window_size=7, num_landmarks=49,
                    attn_2d=True)
ZOO_LOCAL_ARGS = dict(dim=192, num_heads=3, use_rpe=True)
ZOO_MODULE_CELLS = {
    "eva mask": ("eva", dict(ZOO_EVA_ARGS, use_rpe=True), (2, 28, 28, 192), True),
    "eva halo t5 mask": ("eva", dict(ZOO_EVA_ARGS, overlap_window=True, use_t5_rpe=True),
                         (2, 28, 28, 192), True),
    "local 2-d halo mask": ("local", dict(ZOO_LOCAL_ARGS, window_size=7, attn_2d=True,
                                          overlap_window=True), (2, 28, 28, 192), True),
    "local 1-d": ("local", dict(ZOO_LOCAL_ARGS, window_size=64), (2, 1000, 192), False),
    "local 1-d halo mask": ("local", dict(ZOO_LOCAL_ARGS, window_size=64,
                                          overlap_window=True), (2, 1000, 192), True),
}
ZOO_OPTIMIZERS = ("sgd", "adafactor", "adagrad", "adadelta", "adamax", "lamb")
ZOO_OUT_DIR = "build/smoke_zoo"
ZOO_TRAIN_ARGV = ["--bf16", "--epochs", "1", "--max-steps-per-epoch", "4",
                  "--warmup-epochs", "0", "--output-dir", ZOO_OUT_DIR]
# K8's and K2's check at large-norm keys (keys x40, zero queries): the
# geometry of
# tests/test_torch_eva_single.py::test_large_norm_keys_stay_finite_and_match_eager
LARGE_KEYS = (1, 8, 4, 4, 2, 16)
# K8 and K10a's persistent tensor-core route (bf16, head dims 16/32/64) at
# (B, grid side, chunk side, heads, head dim), with LN or without (no-ln),
# keys x40 with zero queries or not, each held to 2**-7 of each output's
# peak on the route mma_plan picks (asserted): the headline with LN and
# without, PVT-B3's three EVA stages at K2_CHECKS' shapes (x of width 64,
# 128 and 320), DeiT-tiny-p16, head dim 16 (the cell's width in 12 heads),
# a batch of 1 (fewer items than SMs), large-norm keys at the headline's
# strips and at LARGE_KEYS; and where mma_plan leaves a launch to the first
# kernel: K8 at strips of fewer than 56 rows (PVT-B3's third stage,
# DeiT-tiny-p16, LARGE_KEYS), K10a at the base ViT's x of width 768 and
# both at head dim 12
SUM_CHECKS = (("headline ln", (128, 28, 4, 3, 64), True, False),
              ("headline no-ln", (128, 28, 4, 3, 64), False, False),
              ("pvt stage 1", (16, 56, 8, 2, 32), True, False),
              ("pvt stage 2", (16, 28, 4, 4, 32), True, False),
              ("pvt stage 3", (16, 14, 2, 10, 32), True, False),
              ("p16", (16, 14, 2, 3, 64), True, False),
              ("d16", (16, 28, 4, 12, 16), True, False),
              ("B=1", (1, 28, 4, 3, 64), True, False),
              ("large-norm keys headline", (8, 28, 4, 3, 64), True, True),
              ("large-norm keys", tuple(LARGE_KEYS[i] for i in (0, 1, 3, 4, 5)), True, True),
              ("evit_base p16 xdim 768", (2, 14, 2, 12, 64), True, False),
              ("d12", (2, 14, 2, 4, 12), True, False))
SUM_TOL = 2 ** -7
# K2's tensor-core route (bf16, head dims 16/32/64) checked at (B, grid side,
# window, chunk side, heads, head dim), with its bias and LN or without: the
# headline, PVT-B3's three stages, DeiT-tiny-p16, chunks straddling blocks
# (12x12, window 3, chunk 4) and a small one
K2_CHECKS = (("main bias ln", (128, 28, 7, 4, 3, 64), True, True),
             ("main no-bias no-ln", (8, 28, 7, 4, 3, 64), False, False),
             ("pvt stage 1", (16, 56, 7, 8, 2, 32), True, True),
             ("pvt stage 2", (16, 28, 7, 4, 4, 32), True, True),
             ("pvt stage 3", (16, 14, 7, 2, 10, 32), True, True),
             ("p16", (16, 14, 7, 2, 3, 64), True, True),
             ("straddling d16", (4, 12, 3, 4, 2, 16), True, False),
             ("small d16 no-bias", (2, 8, 4, 4, 3, 16), False, True))
# K2 timed at (B, grid side, chunk side, heads, head dim), window 7: the
# headline, PVT-B3's EVA stages and DeiT-tiny-p16
K2_SHAPES = (("headline", (128, 28, 4, 3, 64)), ("pvt stage 1", (128, 56, 8, 2, 32)),
             ("pvt stage 2", (128, 28, 4, 4, 32)), ("pvt stage 3", (128, 14, 2, 10, 32)),
             ("p16", (128, 14, 2, 3, 64)))
# the tracked DeiT-tiny-p16 cell (BASELINE.md "Tracked configs"): 14x14
# tokens, the headline's EVA flags (49 landmarks: chunks of 2x2)
P16_ARGV = [
    "--model", "evit_tiny_p16", "--attn-name", "eva",
    "--attn-window-size", "7", "--attn-num-landmarks", "49",
    "--attn-attn-2d", "--attn-use-rpe", "--attn-adaptive-proj", "default",
    "--input-size", "224", "--batch-size", "128", "--seed", "0",
    "--device", "cuda",
]
# K5-K7 geometries (B, grid side, heads, head dim, landmarks, features,
# window): the cells' main shape and a small odd one
LIN_CHECKS = (("main bf16", (128, 28, 3, 64, 49, 64, 7), "bfloat16"),
              ("main f32", (128, 28, 3, 64, 49, 64, 7), "float32"),
              ("small bf16", (2, 14, 3, 64, 4, 16, 7), "bfloat16"),
              ("small f32", (2, 14, 3, 64, 4, 16, 7), "float32"))
# K5's bf16 routes (B, tokens, heads, head dim, landmarks, key scale, the
# route plan picks).  The cluster route: the LARA cell's headline,
# DeiT-tiny-p16's 196 tokens, PVT-B3 stage 1's 3136 with one head of 64 (a
# cluster of 8), head dims 16 and 32 (the cell's width in 12 and 6 heads),
# 1 and 64 landmarks, an odd 1-D length with an odd landmark count, and
# keys scaled x30 (far from every landmark).  The wmma kernel at what the
# cluster route leaves it: head dims 512 and 128, 100 landmarks, more
# tokens than 16 blocks hold; the CUDA-core kernel at head dim 12
K5_CHECKS = (("headline", (128, 784, 3, 64, 49), 1.0, "cluster"),
             ("p16", (128, 196, 3, 64, 49), 1.0, "cluster"),
             ("pvt stage 1", (128, 3136, 1, 64, 49), 1.0, "cluster"),
             ("d16", (16, 784, 12, 16, 49), 1.0, "cluster"),
             ("d32", (16, 784, 6, 32, 49), 1.0, "cluster"),
             ("C=1", (16, 784, 3, 64, 1), 1.0, "cluster"),
             ("C=64", (16, 784, 3, 64, 64), 1.0, "cluster"),
             ("1-D N=37 C=17", (8, 37, 2, 64, 17), 1.0, "cluster"),
             ("keys x30", (128, 784, 3, 64, 49), 30.0, "cluster"),
             ("d512 C=16", (2, 784, 1, 512, 16), 1.0, "wmma"),
             ("d128", (16, 784, 2, 128, 49), 1.0, "wmma"),
             ("C=100", (16, 196, 3, 64, 100), 1.0, "wmma"),
             ("N=20000", (2, 20000, 1, 64, 49), 1.0, "wmma"),
             ("d12", (16, 784, 4, 12, 49), 1.0, "cuda-cores"))
# K6's bf16 geometries (B, tokens, heads, head dim, features, key scale,
# the route plan picks).  The ring route: the Performer cell's headline,
# DeiT-tiny-p16's 196 tokens, 3136 tokens, head dims 16 and 32 (the cell's
# width in 12 and 6 heads), 16 and 128 features, one image (fewer items
# than SMs), 49 tokens (a ragged last tile), keys x30 (every k' near 1e-4).
# The wmma kernel at head dim 48 and the CUDA-core kernel at head dim 12,
# which the ring route leaves them
K6_CHECKS = (("headline", (128, 784, 3, 64, 64), 1.0, "ring"),
             ("p16", (128, 196, 3, 64, 64), 1.0, "ring"),
             ("3136 tokens", (128, 3136, 3, 64, 64), 1.0, "ring"),
             ("d16", (128, 784, 12, 16, 64), 1.0, "ring"),
             ("d32", (128, 784, 6, 32, 64), 1.0, "ring"),
             ("m=16", (16, 784, 3, 64, 16), 1.0, "ring"),
             ("m=128", (16, 784, 3, 64, 128), 1.0, "ring"),
             ("B=1", (1, 784, 3, 64, 64), 1.0, "ring"),
             ("N=49", (8, 49, 3, 64, 64), 1.0, "ring"),
             ("keys x30", (128, 784, 3, 64, 64), 30.0, "ring"),
             ("d48", (16, 784, 2, 48, 64), 1.0, "wmma"),
             ("d12", (16, 784, 4, 12, 16), 1.0, "cuda-cores"))
# K7's own geometries (B, grid side, heads, head dim, window), each with its
# bias and without: bf16 at head dims 16, 32 and 64 on the tensor-core
# route (ws 11: S = 121 > 112, two passes), head dim 12 and f32 off it
K7_CHECKS = (("d16 ws4 bf16", (2, 8, 3, 16, 4), "bfloat16"),
             ("d32 ws3 bf16", (2, 9, 2, 32, 3), "bfloat16"),
             ("main bf16", (128, 28, 3, 64, 7), "bfloat16"),
             ("two-pass ws11 bf16", (8, 22, 2, 64, 11), "bfloat16"),
             ("d12 bf16", (2, 14, 4, 12, 7), "bfloat16"),
             ("main f32", (128, 28, 3, 64, 7), "float32"))
# the WMT14 EN-DE recipe (reference main.sh:87-123) served by cli.generate
# on 256 dummy sentences over the BPE-32k joint vocabulary's size
MT_VOCAB = 32768
MT_ARGV = [
    "--dummy-data", "--dummy-vocab", str(MT_VOCAB), "--attn-name-encoder", "eva",
    "--encoder-attn-window-size", "8", "--encoder-attn-num-landmarks", "8",
    "--encoder-attn-overlap-window", "--encoder-attn-use-t5-rpe",
    "--encoder-attn-adaptive-proj", "no-ln", "--attn-name-decoder", "causal_eva",
    "--decoder-attn-window-size", "16", "--decoder-attn-chunk-size", "8",
    "--decoder-attn-adaptive-proj", "qk", "--decoder-attn-causal",
    "--share-all-embeddings", "--beam", "4", "--lenpen", "0.6",
    "--gen-batch", "64", "--gen-subset-size", "256", "--device", "cuda",
]
# the WMT14 EN-DE recipe trained by cli.train_mt (reference main.sh:103-110:
# f32, dropout 0.1) for 8 updates on the dummy pairs, validating with BLEU
MT_TRAIN_ARGV = MT_ARGV[:MT_ARGV.index("--beam")] + [
    "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--lr", "7e-4",
    "--warmup-updates", "6000", "--max-tokens", "4096", "--max-update", "8",
    "--log-interval", "1", "--eval-bleu", "--eval-bleu-args",
    '{"beam": 4, "lenpen": 0.6}', "--device", "cuda",
]
# f32 gradients of one MT step, the card against the CPU, relative to each
# gradient's peak
MT_GRAD_TOL = 1e-4
# the WMT14 EN-DE protocol from text to BLEU (reference main.sh:87-123) on a
# bilingual corpus written from a seed: WMT14's joint BPE vocabulary's size,
# newstest2013's and newstest2014's sentence counts, sentence lengths about
# WMT14's in BPE tokens; the recipe's model and training flags, checkpoints
# every 2 updates with the newest 3 kept, validation every 4 with BLEU over
# the dictionary's words, then generate from the average of the kept three.
# Cut to the script's time: 20,000 train pairs, the first 1,024 test
# sentences generated
MT_DATA_DIR = "build/smoke_mt_data"
MT_DATA_PAIRS = {"train": 20_000, "valid": 3_000, "test": 3_003}
MT_GEN_SENTENCES = 1024
MT_MODEL_ARGV = MT_ARGV[3:MT_ARGV.index("--beam")]
MT_DATA_ARGV = ["--data", f"{MT_DATA_DIR}/bin", "-s", "en", "-t", "de"] + MT_MODEL_ARGV
MT_DATA_TRAIN_ARGV = MT_DATA_ARGV + MT_TRAIN_ARGV[MT_TRAIN_ARGV.index("--optimizer"):] + [
    "--save-dir", f"{MT_DATA_DIR}/save", "--save-interval-updates", "2",
    "--keep-last-epochs", "3", "--validate-interval-updates", "4",
    "--eval-bleu-remove-bpe", "--eval-bleu-subset-size", "64"]
MT_GEN_ARGV = MT_DATA_ARGV + [
    "--path", f"{MT_DATA_DIR}/save/ckpt", "--num-avg-checkpoints", "3",
    "--beam", "4", "--lenpen", "0.6", "--remove-bpe", "--results-path",
    f"{MT_DATA_DIR}/gen.out", "--gen-subset-size", str(MT_GEN_SENTENCES),
    "--gen-batch", "64",
    "--device", "cuda"]
# eva_1d geometries (B, N, heads, head dim, window, halo, chunks, bias):
# the WMT encoder's batch, long sentences (8 chunks of 32), a small odd one
# (a ragged last 16-row strip), a window of 16 with a halo of 8 at head dim
# 128, and a window of 4 without a halo at head dim 32 (four windows a
# strip)
K4_CHECKS = (("recipe", (64, 32, 8, 64, 8, 4, 8, "t5")),
             ("long", (16, 256, 8, 64, 8, 4, 8, "t5")),
             ("small", (3, 40, 3, 16, 8, 4, 5, "learned")),
             ("ws16 ext8", (8, 64, 4, 128, 16, 8, 8, "t5")),
             ("ws4 ext0", (6, 40, 4, 32, 4, 0, 5, "learned")))
# eva_1d vs its plain version at non-pad rows, relative to the largest
# |value| (at least 1): f32 to summation order, bf16 to one rounding
K4_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2 ** -7}
# f32 encoder states, kernel path vs eager path, through 6 layers
ENC_TOL = 1e-4
# causal_packed's main shape (B, T, heads, head dim, window, chunk) and the
# small odd ones: T = w (window 0 alone) and T = 2w, each in bf16 and f32;
# for the f32 forward's split-TF32 route also window 48 (a block of one
# 16-row strip, 12 chunks: a partial chunk tile) and chunks of 16
K3_CHECKS = (("main bf16", (18, 512, 8, 128, 128, 8), "bfloat16"),
             ("main f32", (18, 512, 8, 128, 128, 8), "float32"),
             ("T=w bf16", (2, 16, 2, 64, 16, 4), "bfloat16"),
             ("T=w f32", (2, 16, 2, 64, 16, 4), "float32"),
             ("T=2w bf16", (2, 32, 2, 64, 16, 4), "bfloat16"),
             ("T=2w f32", (2, 32, 2, 64, 16, 4), "float32"),
             ("w=48 f32", (2, 96, 2, 64, 48, 8), "float32"),
             ("cs=16 f32", (1, 256, 3, 128, 64, 16), "float32"))


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k2_inputs(B, g, ws, j, nh, d, dtype, seed, use_ln=True):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    qkv = r(B, g * g, 3 * nh * d).to(dtype)
    weights = [0.2 * r(d, d), 0.1 * r(d), 0.2 * r(d, d), 0.1 * r(d),
               1 + 0.1 * r(d), 0.1 * r(d), 1 + 0.1 * r(d), 0.1 * r(d)]
    if not use_ln:
        weights[4:] = [None] * 4
    bias = 0.5 * r(nh, ws * ws, ws * ws)
    return (qkv, *weights, d ** -0.5, nh, g, ws, j, use_ln), bias


def k2_bound(args, bias, out):
    """Least time for the function at these inputs: every input byte read
    once and the output written once over HBM, or its operations at the peak
    of the inputs' type, whichever is larger."""
    qkv, *weights = args[:9]
    nh, gw, ws, j = args[10:14]
    B, N, three_hd = qkv.shape
    d = three_hd // (3 * nh)
    S, C = ws * ws, (N // gw // j) * (gw // j)
    moved = (qkv.numel() * qkv.element_size() + out.numel() * out.element_size()
             + sum(w.numel() * 4 for w in weights if w is not None) + bias.numel() * 4)
    flops = B * nh * (4 * N * (S + C) * d      # q.k and p.v over S + C columns
                      + 4 * N * d               # chunk sums of q and k
                      + 4 * C * d * d           # the two adaptive Dense
                      + 6 * N * d)              # <mu,k>, |k|^2, p.v in chunks
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(qkv.dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k1_inputs(B, g, ws, j, nh, d, dtype, seed):
    """qkv, rf_k_bar, beta, bias, output gradient at one geometry."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    C = (g // j) ** 2
    return (r(B, g * g, 3 * nh * d).to(dtype), r(B, C, nh * d).to(dtype),
            r(B, C, nh * d).to(dtype), 0.5 * r(nh, ws * ws, ws * ws),
            r(B, g * g, nh * d).to(dtype))


def k1_bound(qkv, rf, beta, bias, nh, ws, backward):
    """Least time of eva_packed's forward or backward at these inputs:
    every input byte read once and every output written once over HBM
    (drf/dbeta in the summaries' dtype, as the function returns them), or
    its operations at the peak of the inputs' type (2 N (S+C) d per image
    and head for each of the forward's two products, five such in the
    backward), whichever is larger."""
    B, N, three_hd = qkv.shape
    d = three_hd // (3 * nh)
    S, C = ws * ws, rf.shape[1]
    t = qkv.element_size()
    moved = (qkv.numel() + rf.numel() + beta.numel()) * t + bias.numel() * 4
    out = B * N * nh * d * t
    if backward:
        moved += out + qkv.numel() * t + 2 * rf.numel() * t + bias.numel() * 4
    else:
        moved += out
    flops = (5 if backward else 2) * 2 * B * nh * N * (S + C) * d
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(qkv.dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def sdpa_yardstick(qkv, rf, beta, bias, nh, W, ws, grad):
    """One torch.nn.functional.scaled_dot_product_attention call for the
    same joint softmax on pre-partitioned windows: q [B*G, H, S, D], keys
    and values [window | chunk] of length S+C, additive mask [H, S, S+C]
    holding the RPE and 0 on chunk columns.  Returns (forward ms, backward
    ms, forward+backward ms); the partition, the broadcast of the chunks to
    every window and the sum of their gradients back are excluded, and the
    mask takes no gradient (no dbias)."""
    import torch
    import torch.nn.functional as F

    B, N, three_hd = qkv.shape
    d = three_hd // (3 * nh)
    S, C = ws * ws, rf.shape[1]

    def windows(t):  # [B, N, H*D] -> [B*G, H, S, D]
        return (t.reshape(B, N // W // ws, ws, W // ws, ws, nh, d)
                .permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, nh, S, d))

    G = N // (ws * ws)

    def chunks(t):  # [B, C, H*D] -> [B*G, H, C, D]
        return (t.reshape(B, 1, C, nh, d).permute(0, 1, 3, 2, 4)
                .expand(B, G, nh, C, d).reshape(-1, nh, C, d))

    q, k, v = (windows(t).contiguous() for t in qkv.chunk(3, dim=-1))
    k = torch.cat([k, chunks(rf)], dim=2).requires_grad_()
    v = torch.cat([v, chunks(beta)], dim=2).requires_grad_()
    q = q.requires_grad_()
    mask = torch.cat([bias, bias.new_zeros(nh, S, C)], dim=-1).to(qkv.dtype)
    g = windows(grad).contiguous()
    scale = d ** -0.5
    fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, scale=scale)
    out = fwd()
    fwd_ms = cuda_ms(fwd, 20)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g,
                                                 retain_graph=True), 20)
    both_ms = cuda_ms(lambda: torch.autograd.grad(fwd(), (q, k, v), g), 20)
    return fwd_ms, bwd_ms, both_ms


def k3_inputs(B, T, nh, d, w, cs, dtype, seed):
    """q, k, v, rf_k_bar, beta, the [w, w] table (causal triangle plus a
    bias) and an output gradient at one geometry."""
    import torch
    from efficient_attention_torch.ops.kernels import causal_packed as k3

    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    C = T // cs
    ops = [r(B, T, nh * d).to(dtype) for _ in range(3)]
    ops += [r(B, C, nh * d).to(dtype), r(B, C, nh * d).to(dtype),
            k3.causal_table(w, 0.3 * r(w, w), device="cuda")]
    return ops, r(B, T, nh * d).to(dtype)


def k3_bound(q, rf, w, cs, nh, backward):
    """Least time of causal_packed's forward or backward at these inputs:
    every input byte read once and every output written once over HBM
    (drf/dbeta in the summaries' dtype, as the function returns them; the
    kernel's f32 accumulation buffers are its own choice), or its operations
    at the peak of the inputs' type, whichever is larger.  The operations
    count the columns a query can see, (i + 1) local ones for window row i
    and min(C, p // cs) chunks at position p, at 2 d multiply-adds per
    product and column: two products in the forward, five in the
    backward."""
    B, T, hd = q.shape
    C, t = rf.shape[1], q.element_size()
    tok, cd, tab = B * T * hd * t, 2 * rf.numel() * t, w * w * 4
    if backward:
        moved = 4 * tok + cd + tab + 3 * tok + cd + tab
    else:
        moved = 3 * tok + cd + tab + tok
    pos = range(T)
    cols = sum(p % w + 1 + min(C, p // cs) for p in pos)
    flops = (5 if backward else 2) * 2 * B * (hd // nh) * nh * cols
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(q.dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k3_sdpa(ops, grad, nh, w, cs):
    """One scaled_dot_product_attention call for the same joint softmax on
    pre-partitioned windows: q [B*G, H, w, D], keys and values [window |
    C chunks] of w + C, and an additive [B*G, 1, w, w+C] mask holding the
    table and the chunk mask.  Returns (forward ms, backward ms,
    forward+backward ms); the partition, the broadcast of the chunks to every
    window and the sum of their gradients back are excluded, and the mask
    takes no gradient (no dbias)."""
    import torch
    import torch.nn.functional as F
    from efficient_attention_torch.ops.kernels import causal_packed as k3

    q, k, v, rf, beta, tab = ops
    B, T, hd = q.shape
    d, G, C = hd // nh, T // w, rf.shape[1]

    def windows(t):  # [B, T, H*D] -> [B*G, H, w, D]
        return t.reshape(B, G, w, nh, d).permute(0, 1, 3, 2, 4).reshape(-1, nh, w, d)

    def chunks(t):  # [B, C, H*D] -> [B*G, H, C, D]
        return (t.reshape(B, 1, C, nh, d).permute(0, 1, 3, 2, 4)
                .expand(B, G, nh, C, d).reshape(-1, nh, C, d))

    qq = windows(q).contiguous().requires_grad_()
    kk = torch.cat([windows(k), chunks(rf)], dim=2).requires_grad_()
    vv = torch.cat([windows(v), chunks(beta)], dim=2).requires_grad_()
    mask = k3._joint_add(tab, G, w, cs, C)[:, None].repeat(B, 1, 1, 1).to(q.dtype)
    g = windows(grad).contiguous()
    fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qq, kk, vv, attn_mask=mask, scale=d ** -0.5)
    out = fwd()
    fwd_ms = cuda_ms(fwd, 20)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), g,
                                                 retain_graph=True), 20)
    both_ms = cuda_ms(lambda: torch.autograd.grad(fwd(), (qq, kk, vv), g), 20)
    return fwd_ms, bwd_ms, both_ms


def lin_inputs(B, g, nh, d, C, m, ws, dtype, seed):
    """qkv and the operands of K5 (landmarks, balance, log proposal), K6
    (projection) and K7 (RPE bias) at one geometry."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    return {"qkv": r(B, g * g, 3 * nh * d).to(dtype),
            "k5": (0.5 * r(B, nh, C, d), 0.5 * r(B, nh, C, d),
                   torch.softmax(r(B, nh, C), -1), r(B, nh, C)),
            "proj": r(nh, m, d), "bias": 0.5 * r(nh, ws * ws, ws * ws)}


def k5_inputs(B, N, nh, d, C, key_scale, seed):
    """bf16 qkv (keys times ``key_scale``) and K5's landmark operands."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    qkv = r(B, N, 3 * nh * d)
    qkv[..., nh * d:2 * nh * d] *= key_scale
    return (qkv.to(torch.bfloat16), 0.5 * r(B, nh, C, d), 0.5 * r(B, nh, C, d),
            torch.softmax(r(B, nh, C), -1), r(B, nh, C))


def k6_inputs(B, N, nh, d, m, key_scale, seed):
    """bf16 qkv (keys times ``key_scale``) and K6's projection."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, N, 3 * nh * d, generator=gen, device="cuda")
    qkv[..., nh * d:2 * nh * d] *= key_scale
    return qkv.to(torch.bfloat16), torch.randn(nh, m, d, generator=gen, device="cuda")


def k6_route(k6, B, N, nh, d, m):
    """The bf16 route K6 takes: its ring route where ``plan`` names a
    layout, else the kernel that took the geometry before."""
    if k6.plan(B, N, nh, d, m, 2) is not None:
        return "ring"
    return "wmma" if k6.uses_mma(d, m, 2) else "cuda-cores"


def lin_calls(k5, k6, k7, a, nh, g, ws):
    """{name: (kernel call, plain call)} of K5, K6 and K7 on inputs ``a``."""
    qkv = a["qkv"]
    d = qkv.shape[-1] // (3 * nh)
    scale = d ** -0.5
    return {
        k5.NAME: (lambda: k5.lara_attention_fused(qkv, *a["k5"], scale, nh, 2.0),
                  lambda: k5.lara_fused_ref(qkv, *a["k5"], scale, nh, 2.0)),
        k6.NAME: (lambda: k6.performer_attention_fused(qkv, a["proj"], nh),
                  lambda: k6.performer_fused_ref(qkv, a["proj"], nh)),
        k7.NAME: (lambda: k7.local_attention_packed(qkv, scale, nh, g, ws,
                                                    bias=a["bias"]),
                  lambda: k7.local_packed_ref(qkv, scale, nh, g, ws, a["bias"])),
    }


def lin_bound(name, a, nh, ws):
    """Least time of K5, K6 or K7 at inputs ``a``: qkv and every other
    operand read once (the landmark operands, projection and bias in f32, as
    the kernels take them) and the output written once over HBM, or the
    products at the peak of qkv's type: K5 five of N x C x d per image and
    head (k.w, q.q_bar, P.v, q.w, the SNIS weights against kv), K6 three of
    N x m x d (k.w, q.w, k'.v with q'.kv), K7 two of N x S x d."""
    qkv = a["qkv"]
    B, N, three_hd = qkv.shape
    t = qkv.element_size()
    moved = qkv.numel() * t + B * N * (three_hd // 3) * t
    d = three_hd // (3 * nh)
    if name == "lara_fused":
        moved += sum(x.numel() * 4 for x in a["k5"])
        flops = 5 * 2 * B * nh * N * a["k5"][0].shape[2] * d
    elif name == "performer_fused":
        moved += a["proj"].numel() * 4
        flops = 3 * 2 * B * nh * N * a["proj"].shape[1] * d
    else:
        moved += a["bias"].numel() * 4
        flops = 2 * 2 * B * nh * N * ws * ws * d
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(qkv.dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k7_sdpa(a, nh, g, ws):
    """One scaled_dot_product_attention call for K7's function on
    pre-partitioned windows: q, k, v ``[B*G, H, S, D]`` and the RPE as an
    additive ``[H, S, S]`` mask; the partition and the merge are excluded."""
    import torch.nn.functional as F

    qkv = a["qkv"]
    B, N, three_hd = qkv.shape
    d = three_hd // (3 * nh)
    S = ws * ws

    def windows(t):  # [B, N, H*D] -> [B*G, H, S, D]
        return (t.reshape(B, g // ws, ws, g // ws, ws, nh, d)
                .permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, nh, S, d).contiguous())

    q, k, v = (windows(t) for t in qkv.chunk(3, dim=-1))
    mask = a["bias"].to(qkv.dtype)
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=d ** -0.5), 20)


def k4_inputs(B, N, nh, d, ws, ext, C, bias_kind, dtype, seed):
    """qkv, rf_k_bar, beta, a key-padding mask of random sentence lengths
    (the first sentence full) and the [H, ws, ws + 2 ext] bias (a T5 table
    gathered by the bidirectional buckets times the scale, or a learned
    one) at one geometry."""
    import torch
    from efficient_attention_torch.ops.rpe import t5_bucket_table

    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    lens = torch.randint(1, N + 1, (B,), generator=gen, device="cuda")
    lens[0] = N
    mask = torch.arange(N, device="cuda")[None] >= lens[:, None]
    L = ws + 2 * ext
    if bias_kind == "t5":
        nb = max(min((ws + ext) // 2, 64), 16)
        buckets = torch.from_numpy(t5_bucket_table(
            ws, L, causal=False, num_buckets=nb, max_distance=ws + ext)).cuda()
        bias = r(nb, nh)[buckets].permute(2, 0, 1) * d ** -0.5
    else:
        bias = 0.5 * r(nh, ws, L)
    return (r(B, N, 3 * nh * d).to(dtype), r(B, C, nh * d).to(dtype),
            r(B, C, nh * d).to(dtype), mask, bias.contiguous())


def k4_bound(qkv, rf, beta, mask, bias, nh, ws, ext):
    """Least time of eva_1d at these inputs: qkv, the chunk keys and values,
    the mask (a byte a token) and the bias (f32) read once and the output
    written once over HBM, or its two products (q.k and p.v, 2 d operations
    a column each) over the columns this run's data needs, the in-range
    local keys that are not padding and the C chunks, at the peak of the
    inputs' type; whichever is larger."""
    import torch

    B, N, three_hd = qkv.shape
    d = three_hd // (3 * nh)
    t = qkv.element_size()
    moved = ((qkv.numel() + rf.numel() + beta.numel() + B * N * nh * d) * t
             + mask.numel() + bias.numel() * 4)
    L = ws + 2 * ext
    pos = (torch.arange(N, device=qkv.device)[:, None] // ws * ws - ext
           + torch.arange(L, device=qkv.device)[None])  # [N, L]
    inside = (pos >= 0) & (pos < N)
    keep = inside[None] & ~mask[:, pos.clamp(0, N - 1)]  # [B, N, L]
    cols = keep.sum().item() + B * N * rf.shape[1]
    flops = 2 * 2 * nh * d * cols
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(qkv.dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k4_sdpa(qkv, rf, beta, mask, bias, nh, ws, ext):
    """One scaled_dot_product_attention call for eva_1d's function on
    pre-partitioned halo'd windows: q [B*G, H, ws, D], keys and values
    [halo'd window | C chunks] of ws + 2 ext + C, and an additive
    [B*G, H, ws, ws + 2 ext + C] mask holding the bias, the padding and the
    out-of-range halo; the partition is excluded.  Returns (ms, its output
    merged back to [B, N, H*D])."""
    import torch
    import torch.nn.functional as F
    from efficient_attention_torch.ops import windows as W

    B, N, three_hd = qkv.shape
    d, G, C, L = three_hd // (3 * nh), N // ws, rf.shape[1], ws + 2 * ext

    def heads(t):  # [B, n, H*D] -> [B, H, n, D]
        return t.reshape(B, -1, nh, d).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.chunk(3, dim=-1))
    wq = q.reshape(B, nh, G, ws, d).transpose(1, 2).reshape(B * G, nh, ws, d)

    def with_chunks(t, c):  # halo'd windows then the chunks
        w = W.window_1d_partition(t, ws, ext).transpose(1, 2)  # [B, G, H, L, D]
        c = heads(c)[:, None].expand(B, G, nh, C, d)
        return torch.cat([w, c], dim=3).reshape(B * G, nh, L + C, d).contiguous()

    wk, wv = with_chunks(k, rf), with_chunks(v, beta)
    pad = W.window_1d_partition(mask.float()[:, :, None], ws, ext, pad_val=1.0)
    add = torch.cat([bias[None, None].expand(B, G, nh, ws, L)
                     + -5e4 * pad[..., 0][:, :, None, None, :],
                     torch.zeros(B, G, nh, ws, C, device=qkv.device)], dim=-1)
    add = add.reshape(B * G, nh, ws, L + C).to(qkv.dtype)
    wq = wq.contiguous()
    fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
        wq, wk, wv, attn_mask=add, scale=d ** -0.5)
    out = fwd().reshape(B, G, nh, ws, d).permute(0, 1, 3, 2, 4).reshape(B, N, nh * d)
    return cuda_ms(fwd, 20), out


def device_ms(torch, call, n=20):
    """Mean device time of a call over ``n`` calls run back to back: one
    pair of CUDA events around the ``n`` calls while a sleep kernel holds
    the stream until all of them are queued, so that the device runs them
    without waiting on the host and the host's time is not in the reading.
    (torch.profiler kept ever fewer of a session's launches the longer the
    process had run, and some of those it kept read short, so it is not
    used here.)  Raises where the host did not get ahead of the device."""
    call()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    held = torch.cuda.Event()
    for cycles in (4 * 10 ** 7, 4 * 10 ** 8):  # ~20 and ~200 ms at 1.98 GHz
        torch.cuda._sleep(cycles)
        held.record()
        start.record()
        for _ in range(n):
            call()
        end.record()
        ahead = not held.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / n
    raise AssertionError(f"device_ms: the host did not queue {n} calls within the sleep")


def eval_inputs(B, g, ws, j, nh, d, dtype, seed):
    """qkv, the tokens x and the other operands of K8-K10 at one geometry:
    Wqkv and Wo at 1/sqrt(fan-in), the adaptive Dense and LN as k2_inputs
    draws them, chunk summaries and an RPE bias."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    dim, C = nh * d, (g // j) ** 2
    return {"qkv": r(B, g * g, 3 * dim).to(dtype), "x": r(B, g * g, dim).to(dtype),
            "wqkv": r(dim, 3 * dim) / dim ** 0.5, "bqkv": 0.1 * r(3 * dim),
            "adaptive": [0.2 * r(d, d), 0.1 * r(d), 0.2 * r(d, d), 0.1 * r(d),
                         1 + 0.1 * r(d), 0.1 * r(d), 1 + 0.1 * r(d), 0.1 * r(d)],
            "rf": r(B, C, dim).to(dtype), "beta": r(B, C, dim).to(dtype),
            "wo": r(dim, dim) / dim ** 0.5, "bo": 0.1 * r(dim),
            "bias": 0.5 * r(nh, ws * ws, ws * ws)}


def eval_calls(k8, k9, k10, a, nh, g, ws, j):
    """{name: (kernel call, plain call)} of K8, K9 and K10's two entry points
    on inputs ``a``; K8 and K10's summaries return (rf_k_bar, beta)."""
    d = a["qkv"].shape[-1] // (3 * nh)
    att = (a["rf"], a["beta"], a["wo"], a["bo"], d ** -0.5, nh, g, ws, a["bias"])
    summ = (*a["adaptive"], nh, g, j, True)
    tok = (a["x"], a["wqkv"], a["bqkv"])
    return {
        k8.NAME: (lambda: k8.eva_summaries_packed(a["qkv"], *summ),
                  lambda: k8.eva_summaries_packed_ref(a["qkv"], *summ)),
        k9.NAME_OUT: (lambda: k9.eva_attention_packed_out(a["qkv"], *att),
                      lambda: k9.eva_packed_out_ref(a["qkv"], *att)),
        k10.NAME_SUMMARIES: (lambda: k10.eva_summaries_from_x(*tok, *summ),
                             lambda: k10.eva_summaries_from_x_ref(*tok, *summ)),
        k10.NAME_ATTENTION: (lambda: k10.eva_attention_from_x(*tok, *att),
                             lambda: k10.eva_attention_from_x_ref(*tok, *att)),
    }


def eval_bound(name, a, nh, ws):
    """Least time of K8, K9 or a K10 entry point at inputs ``a``: every input
    read once (the adaptive weights, the biases and the RPE in f32, Wqkv and
    Wo in the inputs' type, as the kernels take them) and every output
    written once over HBM, or the operations at the peak of the inputs'
    type: K8 the chunk sums of q and k, the two adaptive Dense and <mu,k>,
    |k|^2 and p.v over the members; K9 the two products over S + C columns
    and the output projection; K10 adds the qkv projection to K8's or
    K9's."""
    qkv, x = a["qkv"], a["x"]
    B, N, three_hd = qkv.shape
    hd, t, xd = three_hd // 3, qkv.element_size(), x.shape[-1]
    d, S, C = hd // nh, ws * ws, a["rf"].shape[1]
    summaries = 2 * B * C * hd * t
    adaptive = sum(w.numel() for w in a["adaptive"]) * 4 + summaries
    attention = (summaries + a["bias"].numel() * 4 + hd * hd * t + hd * 4
                 + B * N * hd * t)
    tokens = B * N * xd * t + xd * three_hd * t + three_hd * 4
    ops_sum = B * nh * (4 * N * d + 4 * C * d * d + 6 * N * d)
    ops_att = 2 * 2 * B * nh * N * (S + C) * d + 2 * B * N * hd * hd
    ops_proj = 2 * B * N * xd * three_hd
    moved, flops = {
        "eva_summaries": (qkv.numel() * t + adaptive, ops_sum),
        "eva_packed_out": (qkv.numel() * t + attention, ops_att),
        "eva_summaries_from_x": (tokens + adaptive, ops_proj + ops_sum),
        "eva_attention_from_x": (tokens + attention, ops_proj + ops_att),
    }[name]
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(qkv.dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def win_inputs(B, H, gh, gw, ws, C, d, dtype, seed, with_bias=True):
    """(windows [3 x B, H, G, S, d], the same q, k, v in token order
    [3 x B, H, N, d], summaries [2 x B, H, C, d], an RPE bias or None) of K11
    and K12 at one geometry."""
    import torch
    from efficient_attention_torch.ops import windows

    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    rows = [r(B, H, gh * gw, d).to(dtype) for _ in range(3)]
    wins = [windows.window_2d_partition(t.reshape(B, H, gh, gw, d), ws).contiguous()
            for t in rows]
    summ = [r(B, H, C, d).to(dtype), r(B, H, C, d).to(dtype)]
    return wins, rows, summ, (0.5 * r(H, ws * ws, ws * ws) if with_bias else None)


def win_calls(k11, k12, a, gw, ws):
    """{name: (kernel call, plain call)} of K11 and K12 on inputs ``a``."""
    wins, rows, summ, bias = a
    scale = wins[0].shape[-1] ** -0.5
    return {
        k11.NAME: (lambda: k11.eva_attention_fused(*wins, *summ, scale, bias),
                   lambda: k11.eva_fused_ref(*wins, *summ, scale, bias)),
        k12.NAME: (lambda: k12.eva_attention_rowmajor(*rows, *summ, scale, gw, ws,
                                                      bias),
                   lambda: k12.eva_rowmajor_ref(*rows, *summ, scale, gw, ws, bias)),
    }


def win_bound(a, ws):
    """Least time of K11 or K12 at inputs ``a``: q, k, v, the summaries and
    the bias (f32) read once and the output written once over HBM, or its
    two products (q.k and p.v over S + C columns, 2 d operations a column
    each) at the peak of the inputs' type, whichever is larger."""
    wins, _, summ, bias = a
    q = wins[0]
    t, d = q.element_size(), q.shape[-1]
    moved = (4 * q.numel() + 2 * summ[0].numel()) * t
    if bias is not None:
        moved += bias.numel() * 4
    flops = 2 * 2 * (q.numel() // d) * (ws * ws + summ[0].shape[2]) * d
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(q.dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def win_sdpa(a):
    """One scaled_dot_product_attention call for K11's function on the
    windows: q [B*G, H, S, D], keys and values [window | C chunks] of S + C,
    the bias as an additive [H, S, S + C] mask (0 on the chunk columns); the
    layout copies are excluded.  Returns (ms, its output as [B, H, G, S, D])."""
    import torch
    import torch.nn.functional as F

    wins, _, summ, bias = a
    B, H, G, S, d = wins[0].shape
    C = summ[0].shape[2]

    def lay(t):  # [B, H, G, n, d] -> [B*G, H, n, d]
        return t.transpose(1, 2).reshape(B * G, H, -1, d)

    def chunks(t):  # [B, H, C, d] -> [B, H, G, C, d]
        return t[:, :, None].expand(B, H, G, C, d)

    q = lay(wins[0]).contiguous()
    k = lay(torch.cat([wins[1], chunks(summ[0])], dim=3)).contiguous()
    v = lay(torch.cat([wins[2], chunks(summ[1])], dim=3)).contiguous()
    mask = torch.cat([bias, bias.new_zeros(H, S, C)], dim=-1).to(q.dtype)
    fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, scale=d ** -0.5)
    out = fwd().reshape(B, G, H, S, d).transpose(1, 2)
    return cuda_ms(fwd, 20), out


def set_impl(model, eva_cls, impl):
    """Every EVA module of ``model`` on route ``impl``."""
    for module in model.modules():
        if isinstance(module, eva_cls):
            module.impl = impl
    return model


def mma_kernel_report(log_path, tag, split_last=False, names=None):
    """What ``nvcc -Xptxas -v`` said of each instantiation of the kernel
    named ``tag`` (registers, stack, spills), by its template arguments;
    with ``split_last`` the last bool is the layout's split (named
    "split"), the pass the one before it; ``names(D, bools, ints)`` names
    the instantiation instead where given."""
    report, name = {}, None
    for line in log_path.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if tag in line else None
            if name is not None:
                # the template arguments of the mangled name, e.g.
                # ...kernelILi64ELb1EEE...: D = 64, one pass (Lb0: two);
                # ...kernelILi64EEv...: D = 64 (no pass argument); where
                # there are several bools, the pass is the last
                args = re.match(r"ILi(\d+)E((?:Lb[01]E)*)((?:Li\d+E)*)",
                                name[name.index(tag) + len(tag):])
                bools = re.findall(r"Lb([01])E", args[2])
                if names is not None:
                    name = names(args[1], bools, re.findall(r"Li(\d+)E", args[3]))
                else:
                    split = split_last and bools.pop() == "1"
                    name = f"D={args[1]}" + (
                        "" if not bools
                        else f" {'one' if bools[-1] == '1' else 'two'}-pass") + (
                        " split" if split else "")
                report[name] = []
        elif name is not None and ("registers" in line or "spill" in line):
            report[name].append(line.replace("ptxas info    :", "").strip())
    if not report:
        raise AssertionError(f"no ptxas report of {tag} in {log_path}")
    return {k: "; ".join(v) for k, v in report.items()}


def profile_steps(torch, prof_factory, run, kernel_tag):
    """Device busy time, its share in kernels named ``kernel_tag`` (a tuple
    of tags: a tuple of shares), and the op table of ``run()`` (3 train
    steps) under ``torch.profiler``."""
    prof = prof_factory(torch.device("cuda"))
    with prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels_only = [e for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA]
    self_ms = lambda e: getattr(  # noqa: E731
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3
    busy = sum(self_ms(e) for e in kernels_only)
    tags = kernel_tag if isinstance(kernel_tag, tuple) else (kernel_tag,)
    tagged = tuple(sum(self_ms(e) for e in kernels_only if tag in e.key) for tag in tags)
    tagged = tagged if isinstance(kernel_tag, tuple) else tagged[0]
    return busy, tagged, wall_ms, events.table(sort_by="self_device_time_total",
                                               row_limit=20)


def mt_k4_prediction(args):
    """The K4 launches that ``cli.train_mt`` with ``args`` makes, as the
    code predicts them: the epochs its updates take (each ends with a
    validation), the validation batches and the BLEU chunks, 6 encoder
    layers each.  Returns ``(epochs, first batch, pairs, valid pairs, valid
    batches, BLEU chunks, launches)``."""
    import numpy as np

    from efficient_attention_torch.cli import train_mt
    from efficient_attention_torch.data.text_data import LanguagePairDataset

    src, tgt, _, _ = train_mt.load_pairs(args)
    pairs = LanguagePairDataset(src, tgt)
    sizes = np.maximum(pairs.src_sizes, pairs.tgt_sizes)
    order_rng = np.random.default_rng(args.seed)
    epochs, steps, first = 0, 0, None
    while steps < args.max_update:
        epochs += 1
        batches = train_mt.epoch_batches(order_rng, sizes, sizes <= args.max_len,
                                         args.max_tokens, args.batch_size,
                                         args.update_freq)
        first = batches[0] if first is None else first
        steps += min(len(batches), args.max_update - steps)
    vsrc, vtgt, _, _ = train_mt.load_pairs(args, split="valid")
    vpairs = LanguagePairDataset(vsrc, vtgt)
    vbatches = train_mt.valid_batches(vpairs, args.max_len, args.max_tokens)
    vsizes = np.maximum(vpairs.src_sizes, vpairs.tgt_sizes)
    chunks = -(-min(int((vsizes <= args.max_len).sum()),
                    args.eval_bleu_subset_size) // 8)
    return (epochs, first, pairs, vpairs, vbatches, chunks,
            6 * epochs * (len(vbatches) + chunks))


def mt_train_phase(torch, card, counters, k4):
    """The MT training path: ``cli.train_mt`` with the recipe's flags, every
    kernel's count set to 0 just before and read just after (K4 only, 6
    launches a validation batch and 6 a BLEU chunk, all on its f32 route;
    nothing in training); the rate of steps 2-8 and the peak memory; then
    the validation sums and the encoder states of every validation batch
    and BLEU chunk, kernel path against eager path, and one step's f32
    gradients of a 2-layer full-width model, card against CPU.
    ``counters`` maps (module, attribute) of every launch count."""
    import numpy as np

    from efficient_attention_torch.cli import train_mt
    from efficient_attention_torch.training import lm_steps
    from efficient_attention_torch.training.criterions import label_smoothed_nll_loss

    real_step = lm_steps.make_mt_train_step
    timed = []  # (start event, end event, target tokens) a step

    def make_timed_step(*a, **kw):
        step = real_step(*a, **kw)

        def run(state, src, prev, tgt, generator):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step(state, src, prev, tgt, generator)
            end.record()
            timed.append((start, end, int((tgt != 1).sum())))
            return metrics

        return run

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for mod, attr in counters:
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    with mock.patch.object(lm_steps, "make_mt_train_step", make_timed_step):
        stats = train_mt.cli_main(MT_TRAIN_ARGV + ["--no-save"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}": getattr(mod, attr)
                for mod, attr in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    k4_launches, k4_tf32 = k4.LAUNCHES, k4.LAUNCHES_TF32
    others = {k: v for k, v in launches.items()
              if v and not k.startswith("eva_1d.")}

    args = train_mt.parse_args(MT_TRAIN_ARGV)
    epochs, first, pairs, vpairs, vbatches, chunks, want_k4 = mt_k4_prediction(args)
    vsizes = np.maximum(vpairs.src_sizes, vpairs.tgt_sizes)

    step_ms = [a.elapsed_time(b) for a, b, _ in timed]
    rate_s = sum(step_ms[1:8]) / 1e3
    tgt_tokens = sum(n for _, _, n in timed[1:8])
    log(f"[mt-train] 8 updates + {epochs} validations with BLEU "
        f"{json.dumps(stats)} in {wall:.2f} s; eva_1d launches {k4_launches} "
        f"({k4_tf32} on the f32 route; {epochs} validations x ({len(vbatches)} "
        f"batches + {chunks} BLEU chunks) x 6 layers = {want_k4}), other kernels "
        f"{json.dumps(others)}")
    log(f"[mt-train] {card}: steps 2-8 {7 / rate_s:.3f} updates/s, "
        f"{tgt_tokens / rate_s:.1f} target tokens/s ({tgt_tokens} tokens in "
        f"{rate_s * 1e3:.3f} ms; CUDA events around each step; step ms "
        f"{json.dumps([round(t, 3) for t in step_ms])})")
    log(f"[mt-train] {card}: peak device memory {peak_gb:.3f} GiB "
        f"(torch.cuda.max_memory_allocated, train steps, validation and BLEU)")
    for key in ("loss", "valid_loss", "valid_nll_loss", "valid_ppl", "valid_bleu"):
        if not math.isfinite(stats[key]):
            raise AssertionError(f"non-finite {key} in {stats}")
    if stats["step"] != 8 or len(timed) != 8:
        raise AssertionError(f"{len(timed)} steps run for step {stats['step']}")
    if others or k4_launches != want_k4 or k4_tf32 != k4_launches:
        raise AssertionError(f"MT training launched eva_1d {k4_launches} times "
                             f"({k4_tf32} on the f32 route; {want_k4} expected) "
                             f"and other kernels {others}")

    # the validation sums, kernel path against eager path (K4's launches
    # here only compare, and are not the path's)
    model = train_mt.build_model(args, MT_VOCAB, MT_VOCAB).cuda().eval()
    eager = copy.deepcopy(model)
    for layer in eager.encoder.layers:
        layer.self_attn.attn.impl = "xla"
    eval_step = lm_steps.make_mt_eval_step(pad_idx=1, label_smoothing=0.1)
    before = k4.LAUNCHES
    sums = [train_mt.valid_sums(m, eval_step, vpairs, vbatches, "cuda")
            for m in (model, eager)]
    if k4.LAUNCHES - before != 6 * len(vbatches):
        raise AssertionError("the kernel path's validation did not run eva_1d")
    verr = max(abs(a - b) / abs(b) for a, b in zip(sums[0][:2], sums[1][:2]))
    log(f"[mt-train] f32 validation sums kernel path vs eager path "
        f"(loss, nll, tokens) {sums[0]} vs {sums[1]}: max rel err {verr:.3e} "
        f"(tol {ENC_TOL:.0e})")
    if not verr <= ENC_TOL or sums[0][2] != sums[1][2]:
        raise AssertionError(f"validation sums differ by {verr}")
    # the encoder states of every validation batch and BLEU chunk at their
    # non-pad positions, kernel path against eager path: the sums above
    # hardly see the encoder, for random weights leave the logits near
    # uniform
    bleu_ids = np.flatnonzero(vsizes <= args.max_len)[:args.eval_bleu_subset_size]
    srcs = [train_mt.collate_pairs(vpairs, b, "cuda")[0] for b in vbatches]
    srcs += [train_mt.collate_pairs(vpairs, bleu_ids[i:i + 8], "cuda")[0]
             for i in range(0, len(bleu_ids), 8)]
    before = k4.LAUNCHES
    eerr, top, shapes = 0.0, 0.0, []
    with torch.no_grad():
        for src_b in srcs:
            (enc, pad), (enc_eager, _) = model.encode(src_b), eager.encode(src_b)
            keep = ~pad
            eerr = max(eerr, (enc - enc_eager)[keep].abs().max().item())
            top = max(top, enc_eager[keep].abs().max().item())
            shapes.append(tuple(src_b.shape))
    torch.cuda.synchronize()
    if k4.LAUNCHES - before != 6 * len(srcs):
        raise AssertionError("the kernel path's encoder did not run eva_1d")
    log(f"[mt-train] f32 encoder states kernel path vs eager path at the "
        f"non-pad positions of the {len(vbatches)} validation batches and "
        f"{len(srcs) - len(vbatches)} BLEU chunks (B x N {sorted(set(shapes))}): "
        f"max abs err {eerr:.3e} (tol {ENC_TOL:.0e}), max |value| {top:.3e}")
    if not eerr <= ENC_TOL:
        raise AssertionError(f"f32 encoder states of validation differ by {eerr}")
    del model, eager

    # one step's f32 gradients of a 2-layer full-width model, card against
    # CPU, eval mode and the eager encoder: nothing drawn at random
    small = train_mt.build_model(train_mt.parse_args(
        MT_TRAIN_ARGV + ["--encoder-layers", "2"]), MT_VOCAB, MT_VOCAB).eval()
    for layer in small.encoder.layers:
        layer.self_attn.attn.impl = "xla"
    on_card = copy.deepcopy(small).cuda()
    batch = train_mt.collate_pairs(pairs, first, "cpu")
    for m, dev in ((small, "cpu"), (on_card, "cuda")):
        s, p, t = (x.to(dev) for x in batch)
        loss_sum, _, ntok = label_smoothed_nll_loss(m(s, p), t, epsilon=0.1,
                                                    pad_idx=1)
        (loss_sum / ntok).backward()
    torch.cuda.synchronize()
    top = max(p.grad.abs().max().item() for p in small.parameters())
    worst, worst_name = 0.0, None
    for (name, p), pc in zip(small.named_parameters(), on_card.parameters()):
        err = (pc.grad.cpu() - p.grad).abs().max().item()
        # softmax is invariant to a shift of a row's logits: the cross
        # attention's key bias has no gradient in exact arithmetic, only
        # rounding, so it is held to the largest gradient of the model
        peak = top if name.endswith("encoder_attn.k_proj.bias") else \
            p.grad.abs().max().item()
        if err / peak > worst:
            worst, worst_name = err / peak, name
    log(f"[mt-train] f32 gradients card vs CPU, 2 + 2 layers at full width, "
        f"batch {tuple(batch[0].shape)} / {tuple(batch[2].shape)}, all "
        f"{len(list(small.parameters()))} parameters: max err / peak "
        f"{worst:.3e} at {worst_name} (tol {MT_GRAD_TOL:.0e})")
    if not worst <= MT_GRAD_TOL:
        raise AssertionError(f"f32 MT gradients differ by {worst} of the peak "
                             f"at {worst_name}")
    del small, on_card
    torch.cuda.empty_cache()


def write_lm_corpus(directory, seed=0):
    """``LM_DATA_TOKENS`` of text in ``directory/{train,valid,test}.txt``:
    lines of 8-64 words (the last line of a split fills its count); the
    train split holds every one of the ``LM_VOCAB - 4`` word types once, in
    a random order, then Zipf(1.1) draws over the types, as do the other
    splits."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_types = LM_VOCAB - 4
    types = np.array([f"w{i}" for i in range(n_types)])
    zipf = 1.0 / np.arange(1, n_types + 1) ** 1.1
    zipf /= zipf.sum()
    for split, total in LM_DATA_TOKENS.items():
        lengths, left = [], total
        while left > 0:  # words a line; each line adds its end of sentence
            k = left - 1 if left <= 65 else min(int(rng.integers(8, 65)), left - 10)
            lengths.append(k)
            left -= k + 1
        n_words = sum(lengths)
        first = rng.permutation(n_types) if split == "train" else np.zeros(0, np.int64)
        ids = np.concatenate([first, rng.choice(n_types, n_words - len(first), p=zipf)])
        words = types[ids]
        with open(f"{directory}/{split}.txt", "w", encoding="utf-8") as f:
            start = 0
            for k in lengths:
                f.write(" ".join(words[start:start + k]) + "\n")
                start += k


def lm_protocol_phase(torch, card, counters):
    """The LM protocol on binarized data at the recipe's full width: write a
    corpus, ``cli.preprocess`` it, ``cli.train_lm --data`` 8 updates with
    checkpoints (K3 counts predicted from the code, the checkpoint kept,
    the parameters restored bit for bit with the tied adaptive weights
    shared), resume to 10, ``cli.eval_lm`` from the checkpoint at context
    windows 0, 256 and 480 (no kernel; the scored tokens predicted by
    ``context_window_blocks``), then the eval step's per-token NLL of a
    2-layer model, card against CPU.  ``counters`` maps (module, attribute)
    of every launch count.  The data directory stays for ``zoo_phase``'s
    ``validate``, which removes it.  Returns the phase's figures."""
    import os
    import shutil

    import numpy as np

    from efficient_attention_torch.cli import eval_lm, preprocess, train_lm
    from efficient_attention_torch.data.dictionary import Dictionary
    from efficient_attention_torch.data.indexed_dataset import MMapIndexedDataset
    from efficient_attention_torch.data.lm_context_window import context_window_blocks
    from efficient_attention_torch.data.text_data import TokenBlockDataset
    from efficient_attention_torch.training import checkpoint, lm_steps

    def zero_counts():
        for mod, attr in counters:
            setattr(mod, attr, 0)

    def counts():
        return {f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}": getattr(mod, attr)
                for mod, attr in counters if getattr(mod, attr)}

    out = {}
    shutil.rmtree(LM_DATA_DIR, ignore_errors=True)
    os.makedirs(f"{LM_DATA_DIR}/text")
    t0 = time.perf_counter()
    write_lm_corpus(f"{LM_DATA_DIR}/text")
    out["corpus_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    preprocess.cli_main(["--only-source", "--destdir", f"{LM_DATA_DIR}/bin"] + [
        a for split in LM_DATA_TOKENS
        for a in (f"--{split}pref", f"{LM_DATA_DIR}/text/{split}.txt")])
    out["preprocess_s"] = time.perf_counter() - t0
    vocab = len(Dictionary.load(f"{LM_DATA_DIR}/bin/dict.txt"))
    sizes = {split: len(MMapIndexedDataset(f"{LM_DATA_DIR}/bin/{split}").flat_tokens())
             for split in LM_DATA_TOKENS}
    log(f"[lm-data] corpus {out['corpus_s']:.2f} s, preprocess "
        f"{out['preprocess_s']:.2f} s: dictionary {vocab} symbols, tokens {sizes}")
    if vocab != LM_VOCAB or sizes != LM_DATA_TOKENS:
        raise AssertionError(f"dictionary of {vocab} (want {LM_VOCAB}), tokens {sizes}")

    # the K3 launches the code predicts: a forward and a backward a layer an
    # update, and a forward a layer a batch of the closing validation
    # (--max-tokens // --tokens-per-sample blocks a batch)
    args = train_lm.parse_args(LM_DATA_ARGV)
    layers = args.decoder_layers
    vb = args.max_tokens // args.tokens_per_sample
    valid_batches = len(TokenBlockDataset(np.zeros(sizes["valid"]),
                                          args.tokens_per_sample + 1)) // vb
    real_save = checkpoint.CheckpointManager.save
    writes = []  # (step, seconds, bytes)
    kept = {}

    def timed_save(self, step, state, metrics=None):
        t = time.perf_counter()
        wrote = real_save(self, step, state, metrics)
        if wrote:
            writes.append((step, time.perf_counter() - t, os.path.getsize(
                os.path.join(self.directory, str(step), checkpoint.STATE_FILE))))
            kept["params"] = {k: v.detach().cpu().clone()
                              for k, v in state["params"].items()}
        return wrote

    ckpt_dir = f"{LM_DATA_DIR}/save/ckpt"
    for run, updates, argv in (("train", 8, ["--max-update", "8"]),
                               ("resume", 2, ["--max-update", "10"])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        with mock.patch.object(checkpoint.CheckpointManager, "save", timed_save):
            stats = train_lm.cli_main(LM_DATA_ARGV + LM_DATA_TRAIN_ARGV + argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        want = {"causal_packed.LAUNCHES_FWD": layers * (updates + valid_batches),
                "causal_packed.LAUNCHES_BWD": layers * updates,
                "causal_packed.LAUNCHES_FWD_TF32": layers * (updates + valid_batches),
                "causal_packed.LAUNCHES_BWD_TF32": layers * updates}
        steps = checkpoint.CheckpointManager(ckpt_dir).all_steps()
        log(f"[lm-data] {run}: {json.dumps(stats)} in {wall:.2f} s; launches "
            f"{json.dumps(got)} (predicted {json.dumps(want)}: {layers} layers x "
            f"({updates} updates + {valid_batches} validation batches)); "
            f"checkpoints kept {steps}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        for key in ("loss", "gnorm", "valid_loss"):
            if not math.isfinite(stats[key]):
                raise AssertionError(f"non-finite {key} in {stats}")
        if stats["step"] != 8 + (run == "resume") * 2 or got != want \
                or stats["valid_batches"] != valid_batches:
            raise AssertionError(f"{run}: step {stats['step']}, launches {got}, "
                                 f"want {want}")
        if steps != [8]:
            raise AssertionError(f"{run}: checkpoints {steps}, want [8]")
        out[f"{run}_s"] = wall
        if run == "train":
            # the saved parameters come back bit for bit, into a model whose
            # tied adaptive softmax still reads the adaptive input's tensors
            if [w[0] for w in writes] != [1, 4, 8]:
                raise AssertionError(f"checkpoints written at {writes}")
            step, params = checkpoint.CheckpointManager(ckpt_dir).restore_params()
            same = step == 8 and params.keys() == kept["params"].keys() and all(
                torch.equal(params[k], kept["params"][k]) for k in params)
            model = train_lm.build_model(args, vocab, dense_tokens=True)
            model.load_state_dict(params, strict=True)
            model = model.cuda()
            emb = model.decoder.embed_tokens
            embs, projs = emb.band_weights()
            tied = all(embs[i] is band[0].weight and projs[i] is band[1].weight
                       and embs[i].data_ptr() == band[0].weight.data_ptr()
                       for i, band in enumerate(emb.embeddings))
            tied = tied and not any(".adaptive_softmax.tail" in k for k in params) and all(
                torch.equal(band[0].weight.cpu(),
                            params[f"decoder.embed_tokens.embeddings.{i}.0.weight"])
                for i, band in enumerate(emb.embeddings))
            out["checkpoint"] = {"bytes": writes[-1][2],
                                 "write_s": [round(w[1], 3) for w in writes]}
            log(f"[lm-data] checkpoint writes (step, s, bytes) {writes}; step 8 "
                f"restored bit for bit: {same}; tied adaptive weights shared: {tied}")
            if not (same and tied):
                raise AssertionError("the checkpoint's round trip failed")
            del model, emb, embs, projs, params
            kept.clear()
    torch.cuda.empty_cache()

    # eval_lm from the checkpoint at each window: no kernel launched (the
    # decoder takes its padding mask, as in JAX), the tokens that
    # context_window_blocks scores; the rate of the eval steps alone
    test_tokens = MMapIndexedDataset(f"{LM_DATA_DIR}/bin/test").flat_tokens()
    real_eval_step = lm_steps.make_lm_eval_step
    step_events = []

    def make_timed_eval_step(*a, **kw):
        step = real_eval_step(*a, **kw)

        def run(*xs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = step(*xs)
            end.record()
            step_events.append((start, end))
            return res

        return run

    out["eval"] = {}
    for window in LM_EVAL_WINDOWS:
        blocks = list(context_window_blocks(test_tokens, args.tokens_per_sample + 1,
                                            window, pad_idx=1))
        want_tokens = sum(int(m[1:].sum()) for _, m in blocks)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        step_events.clear()
        t0 = time.perf_counter()
        with mock.patch.object(lm_steps, "make_lm_eval_step", make_timed_eval_step):
            res = eval_lm.cli_main(LM_DATA_ARGV + ["--checkpoint", ckpt_dir,
                                                   "--context-window", str(window)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        step_s = sum(a.elapsed_time(b) for a, b in step_events) / 1e3
        got = counts()
        row = {"ppl": res["ppl"], "tokens": res["tokens"], "blocks": len(blocks),
               "wall_s": wall, "eval_steps_s": step_s,
               "tokens_per_s": res["tokens"] / step_s,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        out["eval"][window] = row
        log(f"[lm-data] eval_lm context window {window}: {json.dumps(res)}; "
            f"{len(blocks)} blocks, {len(step_events)} eval steps of "
            f"{step_s:.3f} s (CUDA events around each), {row['tokens_per_s']:.1f} "
            f"tokens scored/s; the call {wall:.2f} s (model, checkpoint and "
            f"blocks included); peak device memory {row['peak_gib']:.3f} GiB; "
            f"launches {json.dumps(got)}; {card}")
        if not math.isfinite(res["ppl"]) or got or res["tokens"] != want_tokens:
            raise AssertionError(f"window {window}: {res}, launches {got}, "
                                 f"{want_tokens} tokens predicted")

    # the eval step's per-token NLL of a 2-layer full-width model on one
    # batch of 4 blocks at window LM_EVAL_CHECK_WINDOW, card against CPU
    small = train_lm.build_model(eval_lm.parse_args(LM_DATA_ARGV + ["--decoder-layers", "2"]),
                                 vocab).eval()
    on_card = copy.deepcopy(small).cuda()
    blocks = list(context_window_blocks(test_tokens, args.tokens_per_sample + 1,
                                        LM_EVAL_CHECK_WINDOW, pad_idx=1))[:4]
    a = torch.from_numpy(np.stack([b for b, _ in blocks]))
    sm = torch.from_numpy(np.stack([m for _, m in blocks])[:, 1:])
    token_step = lm_steps.make_lm_token_nll_step(use_adaptive=True)
    zero_counts()
    nll_cpu, mask_cpu = token_step(small, a[:, :-1], a[:, 1:], sm)
    nll_card, mask_card = token_step(on_card, *(x.cuda() for x in (a[:, :-1], a[:, 1:], sm)))
    torch.cuda.synchronize()
    peak = nll_cpu.abs().max().item()
    err = (nll_card.cpu() - nll_cpu).abs().max().item() / peak
    out["card_vs_cpu"] = err
    log(f"[lm-data] per-token NLL card vs CPU, 2 layers at full width, batch "
        f"{tuple(a.shape)} at window {LM_EVAL_CHECK_WINDOW}: max err / peak {err:.3e} (tol "
        f"{LM_EVAL_TOL:.0e}), peak {peak:.3f}; launches {json.dumps(counts())}")
    if not err <= LM_EVAL_TOL or not torch.equal(mask_card.cpu(), mask_cpu):
        raise AssertionError(f"eval NLL card vs CPU differs by {err} of the peak")
    del small, on_card
    torch.cuda.empty_cache()
    return out


def write_mt_corpus(directory, seed=0):
    """``MT_DATA_PAIRS`` sentence pairs in ``directory/{split}.{en,de}``:
    ``MT_VOCAB - 4`` word types, every tenth a ``@@`` continuation piece
    (joined by ``--remove-bpe``) and every tenth a hyphenated compound
    (split by the compound-split script); source lines of 1-128 words
    (lognormal, mean about 28, WMT14's length in BPE tokens), the train
    split's first words every type once in a random order, then Zipf(1.1)
    draws over the types, as are the other splits; the target the source
    mapped by one fixed permutation of the types, in reversed order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_types = MT_VOCAB - 4
    types = np.array([f"w{i}@@" if i % 10 == 3 else f"w{i}-c" if i % 10 == 7
                      else f"w{i}" for i in range(n_types)])
    to_target = rng.permutation(n_types)
    zipf = 1.0 / np.arange(1, n_types + 1) ** 1.1
    zipf /= zipf.sum()
    for split, n in MT_DATA_PAIRS.items():
        lengths = np.clip(np.rint(rng.lognormal(np.log(28) - 0.18, 0.6, n)),
                          1, 128).astype(np.int64)
        first = rng.permutation(n_types) if split == "train" else np.zeros(0, np.int64)
        ids = np.concatenate([first, rng.choice(n_types, lengths.sum() - len(first),
                                                p=zipf)])
        ends = np.cumsum(lengths)
        with open(f"{directory}/{split}.en", "w", encoding="utf-8") as fs, \
                open(f"{directory}/{split}.de", "w", encoding="utf-8") as ft:
            for start, end in zip(ends - lengths, ends):
                sent = ids[start:end]
                fs.write(" ".join(types[sent]) + "\n")
                ft.write(" ".join(types[to_target[sent[::-1]]]) + "\n")


def same_tree(a, b) -> bool:
    """Whether two saved states are equal, tensors bit for bit."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same_tree(x, y) for x, y in zip(a, b)))
    if hasattr(a, "dtype") and hasattr(a, "shape"):
        import torch

        return (torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    return a == b


def mt_protocol_phase(torch, card, counters, k4):
    """The WMT14 EN-DE protocol from text to BLEU at the recipe's full
    width: write a bilingual corpus, ``cli.preprocess -s en -t de
    --joined-dictionary`` it (exactly ``MT_VOCAB`` symbols), ``cli.train_mt
    --data`` 8 updates with checkpoints every 2 (the newest 3 kept) and
    validation with BLEU every 4, resume to 10 (the saved state restored bit
    for bit, the shared embedding still one tensor), ``cli.generate`` from
    the average of the 3 kept checkpoints (equal to their CPU average bit
    for bit) over the first ``MT_GEN_SENTENCES`` test sentences into
    gen.out, and
    ``scripts/torch_compound_split_bleu.sh`` over it; K4's launches in each
    call predicted from the code, all on its f32 route; then the averaged
    model's encoder states, K4 route against the eager path.  ``counters``
    maps (module, attribute) of every launch count.  The data directory
    stays for ``zoo_phase``'s ``validate``, which removes it.  Returns the
    phase's figures."""
    import os

    import numpy as np

    from efficient_attention_torch.cli import generate, preprocess, train_mt
    from efficient_attention_torch.data.dictionary import Dictionary
    from efficient_attention_torch.data.text_data import LanguagePairDataset
    from efficient_attention_torch.training import checkpoint, lm_steps

    def zero_counts():
        for mod, attr in counters:
            setattr(mod, attr, 0)

    def counts():
        return {f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}": getattr(mod, attr)
                for mod, attr in counters if getattr(mod, attr)}

    out = {}
    shutil.rmtree(MT_DATA_DIR, ignore_errors=True)
    os.makedirs(f"{MT_DATA_DIR}/text")
    t0 = time.perf_counter()
    write_mt_corpus(f"{MT_DATA_DIR}/text")
    out["corpus_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    preprocess.cli_main(["-s", "en", "-t", "de", "--joined-dictionary",
                         "--destdir", f"{MT_DATA_DIR}/bin"] + [
        a for split in MT_DATA_PAIRS
        for a in (f"--{split}pref", f"{MT_DATA_DIR}/text/{split}")])
    out["preprocess_s"] = time.perf_counter() - t0
    vocab = {lang: len(Dictionary.load(f"{MT_DATA_DIR}/bin/dict.{lang}.txt"))
             for lang in ("en", "de")}
    args = train_mt.parse_args(MT_DATA_TRAIN_ARGV)
    src, tgt, _, _ = train_mt.load_pairs(args)
    pairs = LanguagePairDataset(src, tgt)
    counts_read = {split: len(train_mt.load_pairs(args, split)[0]) for split in MT_DATA_PAIRS}
    src_tokens = int(src.sizes.sum())
    log(f"[mt-data] corpus {out['corpus_s']:.2f} s, preprocess "
        f"{out['preprocess_s']:.2f} s: dictionaries {vocab} symbols, pairs "
        f"{counts_read}, train {src_tokens} source tokens with eos (mean "
        f"{src_tokens / len(src):.2f} a sentence, longest {int(src.sizes.max())})")
    if set(vocab.values()) != {MT_VOCAB} or counts_read != MT_DATA_PAIRS:
        raise AssertionError(f"dictionaries {vocab} (want {MT_VOCAB}), pairs {counts_read}")

    # the K4 launches the code predicts: 6 layers x (the validation batches
    # + 8 BLEU chunks of 8) a validation; validations at updates 4 and 8 and
    # at the end of the run (the epoch loop's boundary, as in JAX): 3 in the
    # first run, 1 in the resumed one (update 8's are passed over); so the
    # first epoch must outlast both runs
    layers = args.encoder_layers
    sizes = np.maximum(pairs.src_sizes, pairs.tgt_sizes)
    epoch1 = train_mt.epoch_batches(np.random.default_rng(args.seed), sizes,
                                    sizes <= args.max_len, args.max_tokens,
                                    args.batch_size, args.update_freq)
    vsrc, vtgt, _, _ = train_mt.load_pairs(args, split="valid")
    vpairs = LanguagePairDataset(vsrc, vtgt)
    vbatches = train_mt.valid_batches(vpairs, args.max_len, args.max_tokens)
    vsizes = np.maximum(vpairs.src_sizes, vpairs.tgt_sizes)
    chunks = -(-min(int((vsizes <= args.max_len).sum()),
                    args.eval_bleu_subset_size) // 8)
    if len(epoch1) <= 10:
        raise AssertionError(f"the first epoch has {len(epoch1)} batches")

    real_save = checkpoint.CheckpointManager.save
    writes = []  # (step, seconds, bytes)
    kept = {}

    def timed_save(self, step, state, metrics=None):
        t = time.perf_counter()
        wrote = real_save(self, step, state, metrics)
        if wrote:
            writes.append((step, time.perf_counter() - t, os.path.getsize(
                os.path.join(self.directory, str(step), checkpoint.STATE_FILE))))
            kept["state"] = copy.deepcopy({k: v for k, v in state.items()})
        return wrote

    real_step = lm_steps.make_mt_train_step
    timed = []  # (start event, end event, target tokens) a step

    def make_timed_step(*a, **kw):
        step = real_step(*a, **kw)

        def run(state, src_b, prev, tgt_b, generator):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step(state, src_b, prev, tgt_b, generator)
            end.record()
            timed.append((start, end, int((tgt_b != 1).sum())))
            return metrics

        return run

    ckpt_dir = f"{MT_DATA_DIR}/save/ckpt"
    for run, updates, validations, argv, want_written, want_kept in (
            ("train", 8, 3, ["--max-update", "8"], [1, 2, 4, 6, 8], [4, 6, 8]),
            ("resume", 2, 1, ["--max-update", "10"], [10], [6, 8, 10])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        writes.clear()
        timed.clear()
        zero_counts()
        t0 = time.perf_counter()
        with mock.patch.object(checkpoint.CheckpointManager, "save", timed_save), \
                mock.patch.object(lm_steps, "make_mt_train_step", make_timed_step):
            stats = train_mt.cli_main(MT_DATA_TRAIN_ARGV + argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        want_k4 = layers * validations * (len(vbatches) + chunks)
        want = {"eva_1d.LAUNCHES": want_k4, "eva_1d.LAUNCHES_TF32": want_k4}
        steps = checkpoint.CheckpointManager(ckpt_dir).all_steps()
        step_ms = [a.elapsed_time(b) for a, b, _ in timed]
        # the rate of the steps after the first (CUDA events around each)
        rate_s = sum(step_ms[1:]) / 1e3
        tgt_tokens = sum(n for _, _, n in timed[1:])
        row = {"wall_s": wall, "updates_per_s": (len(timed) - 1) / rate_s,
               "target_tokens_per_s": tgt_tokens / rate_s,
               "target_tokens_a_step": tgt_tokens / (len(timed) - 1),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "writes": [(w[0], round(w[1], 3), w[2]) for w in writes]}
        out[run] = row
        log(f"[mt-data] {run}: {json.dumps(stats)} in {wall:.2f} s; launches "
            f"{json.dumps(got)} (predicted {json.dumps(want)}: {layers} layers x "
            f"{validations} validations x ({len(vbatches)} batches + {chunks} BLEU "
            f"chunks)); checkpoint writes (step, s, bytes) {row['writes']}, kept "
            f"{steps}; steps after the first {row['updates_per_s']:.3f} updates/s, "
            f"{row['target_tokens_per_s']:.1f} target tokens/s ({tgt_tokens} tokens "
            f"in {rate_s * 1e3:.3f} ms; step ms "
            f"{json.dumps([round(t, 3) for t in step_ms])}); peak device memory "
            f"{row['peak_gib']:.3f} GiB; {card}")
        for key in ("loss", "valid_loss", "valid_bleu"):
            if not math.isfinite(stats[key]):
                raise AssertionError(f"non-finite {key} in {stats}")
        if stats["step"] != 8 + (run == "resume") * 2 or len(timed) != updates \
                or got != want:
            raise AssertionError(f"{run}: step {stats['step']} after {len(timed)} "
                                 f"updates, launches {got}, want {want}")
        if [w[0] for w in writes] != want_written or steps != want_kept:
            raise AssertionError(f"{run}: checkpoints written {writes}, kept {steps}; "
                                 f"want {want_written} and {want_kept}")
        if run == "train":
            # the state saved at step 8 comes back bit for bit (parameters,
            # Adam's moments, the generator), into a model whose encoder and
            # decoder still share one embedding
            saved = checkpoint.CheckpointManager(ckpt_dir).load(8)
            same = same_tree(saved, kept["state"])
            model = train_mt.build_model(args, MT_VOCAB, MT_VOCAB)
            model.load_state_dict(saved["params"], strict=True)
            model = model.cuda()
            tied = (model.encoder.embed_tokens is model.decoder.embed_tokens
                    and torch.equal(model.decoder.embed_tokens.weight.cpu(),
                                    saved["params"]["encoder.embed_tokens.weight"]))
            n_params = sum(p.numel() for p in model.parameters())
            out["checkpoint"] = {"bytes": writes[-1][2], "parameters": n_params,
                                 "write_s": [w[1] for w in row["writes"]]}
            log(f"[mt-data] step 8 restored bit for bit (parameters, optimizer, "
                f"generator): {same}; shared embedding one tensor: {tied}; "
                f"{n_params} parameters")
            if not (same and tied):
                raise AssertionError("the checkpoint's round trip failed")
            del model, saved
            kept.clear()
    torch.cuda.empty_cache()

    # generate from the average of the kept three over the test split's
    # first MT_GEN_SENTENCES: 6 K4 launches a batch of 64
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = generate.cli_main(MT_GEN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    batches = -(-MT_GEN_SENTENCES // 64)
    want = {"eva_1d.LAUNCHES": layers * batches, "eva_1d.LAUNCHES_TF32": layers * batches}
    mgr = checkpoint.CheckpointManager(ckpt_dir)
    states = [mgr.restore_params(step)[1] for step in mgr.all_steps()]
    average = {k: (sum(s[k].double() for s in states) / len(states)).to(v.dtype)
               for k, v in states[0].items()}
    same = (res["params"].keys() == average.keys()
            and all(torch.equal(res["params"][k], average[k]) for k in average))
    with open(f"{MT_DATA_DIR}/gen.out", encoding="utf-8") as f:
        gen_lines = f.read().splitlines()
    n_h = sum(line.startswith("H-") for line in gen_lines)
    env = dict(os.environ, PATH=os.path.dirname(sys.executable) + os.pathsep
               + os.environ.get("PATH", ""))
    t1 = time.perf_counter()
    split_bleu = subprocess.run(
        ["bash", "scripts/torch_compound_split_bleu.sh", f"{MT_DATA_DIR}/gen.out"],
        env=env, capture_output=True, text=True, check=True).stdout.strip()
    score_s = time.perf_counter() - t1
    gen_s = res["encode_s"] + res["beam_s"]
    out["generate"] = {
        "wall_s": wall, "load_s": res["load_s"], "encode_s": res["encode_s"],
        "beam_s": res["beam_s"], "sentences_per_s": res["sentences"] / gen_s,
        "hypothesis_tokens": res["hypothesis_tokens"],
        "decode_steps": res["decode_steps"], "bleu": res["bleu"],
        "compound_split_bleu": split_bleu, "score_s": score_s,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"[mt-data] generate {res['sentences']} test sentences in {wall:.2f} s: "
        f"restore and average of steps {mgr.all_steps()} {res['load_s']:.2f} s, "
        f"encode {res['encode_s']:.3f} s, beam loop {res['beam_s']:.3f} s "
        f"({res['decode_steps']} decode steps), "
        f"{out['generate']['sentences_per_s']:.1f} sentences/s, "
        f"{res['hypothesis_tokens']} hypothesis tokens; {res['detail']}; launches "
        f"{json.dumps(got)} (predicted {json.dumps(want)}: {layers} layers x "
        f"{batches} batches); averaged parameters equal the CPU average bit for "
        f"bit: {same}; gen.out {len(gen_lines)} lines, {n_h} H-; compound-split "
        f"{split_bleu!r} in {score_s:.2f} s; peak device memory "
        f"{out['generate']['peak_gib']:.3f} GiB; {card}")
    if not math.isfinite(res["bleu"]) or res["sentences"] != MT_GEN_SENTENCES \
            or got != want or not same:
        raise AssertionError(f"generate: {res['sentences']} sentences, BLEU "
                             f"{res['bleu']}, launches {got} (want {want}), "
                             f"average equal {same}")
    if n_h != MT_GEN_SENTENCES or not gen_lines[-1].startswith(
            "Generate test with beam=4: BLEU4 = ") or not split_bleu.startswith("BLEU4 = "):
        raise AssertionError(f"gen.out: {n_h} H- lines, last {gen_lines[-1]!r}; "
                             f"compound-split {split_bleu!r}")

    # the averaged model's encoder states on the first test batch at its
    # non-pad positions, K4 route against the eager path
    model = train_mt.build_model(args, MT_VOCAB, MT_VOCAB)
    model.load_state_dict(res["params"])
    model = model.cuda().eval()
    eager = copy.deepcopy(model)
    for layer in eager.encoder.layers:
        layer.self_attn.attn.impl = "xla"
    gargs = generate.parse_args(MT_GEN_ARGV)
    test_src = train_mt.load_pairs(gargs, "test")[0]
    _, src_b, _, _, _ = next(generate.generation_batches(gargs, test_src))
    src_t = torch.from_numpy(src_b).cuda()
    before = k4.LAUNCHES_TF32
    with torch.no_grad():
        (enc, pad), (enc_eager, _) = model.encode(src_t), eager.encode(src_t)
    torch.cuda.synchronize()
    keep = ~pad
    eerr = (enc - enc_eager)[keep].abs().max().item()
    out["encoder_err"] = eerr
    log(f"[mt-data] averaged model's f32 encoder states K4 route vs eager path, "
        f"test batch {tuple(src_b.shape)}, {int(keep.sum())} non-pad positions: max "
        f"abs err {eerr:.3e} (tol {ENC_TOL:.0e}), max |value| "
        f"{enc_eager[keep].abs().max().item():.3e}")
    if k4.LAUNCHES_TF32 - before != layers or not eerr <= ENC_TOL:
        raise AssertionError(f"averaged encoder: {k4.LAUNCHES_TF32 - before} f32-route "
                             f"launches, error {eerr}")
    del model, eager, res
    torch.cuda.empty_cache()
    return out


def _write_jpeg(job):
    """One smooth random JPEG (a 25x-upsampled random image): a pool task of
    ``write_imagenet_folder``; returns its bytes."""
    import os

    import numpy as np
    from PIL import Image

    path, seed, landscape = job
    w, h = (500, 375) if landscape else (375, 500)
    small = np.random.default_rng(seed).integers(0, 256, (h // 25, w // 25, 3),
                                                 np.uint8)
    Image.fromarray(small).resize((w, h), Image.BICUBIC).save(path, quality=90)
    return os.path.getsize(path)


def write_imagenet_folder(directory, classes=1000, seed=0):
    """``directory/{train,val}/n<8 digits>/`` with ``VIT_DATA_PER_CLASS``
    JPEGs a class, written by a spawned pool of one process a core.
    Returns (images, bytes)."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    jobs = []
    for split, per_class in VIT_DATA_PER_CLASS.items():
        for c in range(classes):
            d = f"{directory}/{split}/n{1440764 + 7919 * c:08d}"
            os.makedirs(d)
            for i in range(per_class):
                jobs.append((f"{d}/{split}_{c}_{i}.JPEG", seed * 10 ** 6 + len(jobs),
                             (c + i) % 2 == 0))
    with ProcessPoolExecutor(os.cpu_count(),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        return len(jobs), sum(pool.map(_write_jpeg, jobs, chunksize=32))


def vit_protocol_phase(torch, card, counters):
    """The ImageNet recipe from an image folder to a top-1 on the card
    (``main.sh -d imagenet -p DIR`` at DeiT-tiny-p8 + EVA's full width,
    ``--bf16``): write the folder; train 2 epochs of 4 steps (K1's forward
    and backward a block a step on the tensor-core routes, K2 a block a val
    batch on the f32 route for the EMA; checkpoints at 4 and 8); resume to
    epoch 3 (the restored state, generator included, equal to the file bit
    for bit; steps [4, 8, 12] kept); ``--eval --resume`` (every val image, K2
    on its tensor-core route); 8 steps on each loader (synthetic, the folder
    on threads and on processes, the uint8 cache) with the host's gap
    between steps; PVTv2-B3 4 steps with and without
    ``--checkpoint-activations`` (K1's forward twice a block and step under
    remat), peak memory and images/s.  ``counters`` lists (module,
    attribute) of every launch count.  Returns the phase's figures."""
    import os

    from efficient_attention_torch.cli import train_vit
    from efficient_attention_torch.data.imagenet import (
        CachedUint8Dataset,
        PrefetchLoader,
    )
    from efficient_attention_torch.training import checkpoint, train_state

    def zero_counts():
        for mod, attr in counters:
            setattr(mod, attr, 0)

    def counts():
        return {f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}": getattr(mod, attr)
                for mod, attr in counters if getattr(mod, attr)}

    def launches(k1_fwd, k1_bwd, k2_f32, k2_mma):
        want = {"eva_packed.LAUNCHES_FWD": k1_fwd, "eva_packed.LAUNCHES_FWD_MMA": k1_fwd,
                "eva_packed.LAUNCHES_BWD": k1_bwd, "eva_packed.LAUNCHES_BWD_MMA": k1_bwd,
                "eva_single.LAUNCHES": k2_f32 + k2_mma, "eva_single.LAUNCHES_MMA": k2_mma}
        return {k: v for k, v in want.items() if v}

    t_phase = time.perf_counter()
    out = {"cpus": os.cpu_count()}
    shutil.rmtree(VIT_DATA_DIR, ignore_errors=True)
    shutil.rmtree(VIT_OUT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    n_images, n_bytes = write_imagenet_folder(VIT_DATA_DIR)
    out["folder"] = {"images": n_images, "bytes": n_bytes,
                     "s": time.perf_counter() - t0}
    log(f"[vit-data] image folder: {n_images} JPEGs (1000 classes x "
        f"{VIT_DATA_PER_CLASS}), {n_bytes} bytes in {out['folder']['s']:.2f} s "
        f"on {out['cpus']} processes")
    blocks, val_batches = 12, math.ceil(1000 / 128)

    def records():
        with open(f"{VIT_OUT_DIR}/log.txt", encoding="utf-8") as f:
            return [json.loads(line) for line in f]

    # 2 epochs of 4 steps: K1 a block a step, K2 (f32, the EMA) a block a
    # val batch, checkpoints at the epochs' ends
    zero_counts()
    t0 = time.perf_counter()
    train_vit.cli_main(VIT_RECIPE_ARGV + ["--epochs", "2", "--output-dir", VIT_OUT_DIR])
    torch.cuda.synchronize()
    wall, got = time.perf_counter() - t0, counts()
    want = launches(blocks * 8, blocks * 8, blocks * val_batches * 2, 0)
    steps = checkpoint.CheckpointManager(f"{VIT_OUT_DIR}/ckpt").all_steps()
    recs = records()
    log(f"[vit-data] train 2 epochs x 4 steps in {wall:.2f} s: {json.dumps(recs)}; "
        f"launches {json.dumps(got)} (predicted {json.dumps(want)}); checkpoints "
        f"{steps}")
    if got != want or steps != [4, 8] or len(recs) != 2 or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["val_loss"])
            and r["val_images"] == 1000 for r in recs):
        raise AssertionError(f"train: launches {got}, steps {steps}, records {recs}")
    out["train"] = {"s": wall, "val_acc1": [r["val_acc1"] for r in recs],
                    "loss": [r["loss"] for r in recs]}

    # resume to epoch 3: the restored state against the file, bit for bit
    real_restore, restored = train_vit.restore, {}

    def checked_restore(ckpt, state, generator, mesh=None):
        found = real_restore(ckpt, state, generator, mesh)
        now = dict(state.state_dict(), rng={"generator": generator.get_state()})
        restored.update(step=state.step, same=same_tree(now, ckpt.load()))
        return found

    zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(train_vit, "restore", checked_restore):
        train_vit.cli_main(VIT_RECIPE_ARGV + [
            "--epochs", "3", "--output-dir", VIT_OUT_DIR, "--resume",
            f"{VIT_OUT_DIR}/ckpt"])
    torch.cuda.synchronize()
    wall, got = time.perf_counter() - t0, counts()
    want = launches(blocks * 4, blocks * 4, blocks * val_batches, 0)
    steps = checkpoint.CheckpointManager(f"{VIT_OUT_DIR}/ckpt").all_steps()
    log(f"[vit-data] resume to epoch 3 in {wall:.2f} s: restored step "
        f"{restored.get('step')}, equal to the file bit for bit (parameters, EMA, "
        f"optimizer, generator): {restored.get('same')}; {json.dumps(records()[-1])}; "
        f"launches {json.dumps(got)} (predicted {json.dumps(want)}); checkpoints {steps}")
    if restored != {"step": 8, "same": True} or got != want or steps != [4, 8, 12] \
            or len(records()) != 3:
        raise AssertionError(f"resume: {restored}, launches {got}, steps {steps}")
    out["resume_s"] = wall

    # --eval --bf16 --resume: every val image, K2 on its tensor-core route
    zero_counts()
    t0 = time.perf_counter()
    stats = train_vit.cli_main(VIT_RECIPE_ARGV + ["--eval", "--output-dir", VIT_OUT_DIR,
                                                  "--resume", f"{VIT_OUT_DIR}/ckpt"])
    torch.cuda.synchronize()
    wall, got = time.perf_counter() - t0, counts()
    want = launches(0, 0, 0, blocks * val_batches)
    log(f"[vit-data] --eval --bf16 --resume (the EMA of step 12) in {wall:.2f} s: "
        f"{json.dumps(stats)}; launches {json.dumps(got)} (predicted {json.dumps(want)})")
    if got != want or stats["images"] != 1000 or not math.isfinite(stats["loss"]):
        raise AssertionError(f"eval: {stats}, launches {got}")
    out["eval"] = {"s": wall, "acc1": stats["acc1"], "images": stats["images"]}

    # the loader's cost: 8 steps on each loader (no eval, no checkpoint),
    # CUDA-synchronised host times around each step
    times = []
    real_make = train_state.make_vit_train_step

    def make_timed_step(*a, **kw):
        step = real_make(*a, **kw)

        def run(*xs):
            t = time.perf_counter()
            res = step(*xs)
            torch.cuda.synchronize()
            times.append((t, time.perf_counter()))
            return res

        return run

    def no_eval(*a, **kw):
        return {"acc1": 0.0, "acc5": 0.0, "loss": 0.0, "batches": 0, "images": 0}

    real_build = CachedUint8Dataset.build
    builds = []

    def timed_build(*a, **kw):
        t = time.perf_counter()
        real_build(*a, **kw)
        builds.append(time.perf_counter() - t)

    real_iter = PrefetchLoader.__iter__
    starts = []

    def timed_iter(self):
        starts.append(time.perf_counter())
        yield from real_iter(self)

    def rate(steps_done, batch):
        """(images/s from the train loader's start to the last step's end,
        images/s after the first step (the window filled during the first
        step flatters it), mean host gap between steps in ms: the wait on
        the loader and the batch's copy to the card)."""
        run = steps_done * batch / (times[-1][1] - starts[0])
        ips = (steps_done - 1) * batch / (times[-1][1] - times[0][1])
        gaps = [times[i][0] - times[i - 1][1] for i in range(1, len(times))]
        return run, ips, 1e3 * sum(gaps) / len(gaps)

    loaders = {"synthetic": ["--data-set", "SYNTHETIC"], "folder threads": [],
               "folder processes": ["--decode-backend", "process"],
               "uint8 cache": ["--uint8-cache", f"{VIT_DATA_DIR}/cache"]}
    out["loaders"] = {}
    quiet = (mock.patch.object(train_state, "make_vit_train_step", make_timed_step),
             mock.patch.object(train_vit, "evaluate", no_eval),
             mock.patch.object(checkpoint.CheckpointManager, "save",
                               lambda *a, **kw: False),
             mock.patch.object(PrefetchLoader, "__iter__", timed_iter),
             mock.patch.object(CachedUint8Dataset, "build", timed_build))
    for name, extra in loaders.items():
        times.clear()
        starts.clear()
        t0 = time.perf_counter()
        with quiet[0], quiet[1], quiet[2], quiet[3], quiet[4]:
            train_vit.cli_main(VIT_RECIPE_ARGV + extra + [
                "--epochs", "1", "--max-steps-per-epoch", "8", "--output-dir",
                f"{VIT_OUT_DIR}_loader"])
        wall = time.perf_counter() - t0
        run, ips, gap = rate(8, 128)
        row = {"images_per_s": run, "after_first_step": ips, "gap_ms": gap, "s": wall}
        if name == "uint8 cache":
            row["build_s"] = builds
        out["loaders"][name] = row
        log(f"[vit-data] loader {name}: {len(times)} steps, {run:.1f} images/s from "
            f"the loader's start ({ips:.1f} after the first step), {gap:.1f} ms a "
            f"step between steps (loader wait and the copy to the card); the call "
            f"{wall:.2f} s"
            + (f" (cache builds, train and val, {builds} s)" if builds else "")
            + f"; {out['cpus']} CPUs; {card}")
        if len(times) != 8:
            raise AssertionError(f"loader {name}: {len(times)} steps")
    shutil.rmtree(f"{VIT_OUT_DIR}_loader", ignore_errors=True)

    # PVTv2-B3: 4 steps with and without --checkpoint-activations
    out["pvt"] = {}
    pvt_argv = PVT_ARGV + ["--bf16", "--repeated-aug", "--model-ema", "--clip-grad",
                           "5.0", "--epochs", "1", "--max-steps-per-epoch", "4",
                           "--num-workers", "8", "--output-dir", f"{VIT_OUT_DIR}_pvt"]
    for remat in (True, False):
        argv = pvt_argv + (["--checkpoint-activations"] if remat else [])
        for batch in (128, 64):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            times.clear()
            starts.clear()
            try:
                with quiet[0], quiet[1], quiet[2], quiet[3]:
                    train_vit.cli_main(argv + ["--batch-size", str(batch)])
                break
            except torch.cuda.OutOfMemoryError as err:
                log(f"[vit-data] PVT-B3 remat={remat} at batch {batch}: out of "
                    f"memory ({str(err)[:120]}); cut to 64")
                if batch == 64:
                    raise
        torch.cuda.synchronize()
        got = counts()
        want = launches(PVT_EVA_BLOCKS * 4 * (2 if remat else 1),
                        PVT_EVA_BLOCKS * 4, 0, 0)
        run, ips, gap = rate(4, batch)
        row = {"batch": batch, "images_per_s": ips, "from_start": run, "gap_ms": gap,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        out["pvt"]["remat" if remat else "plain"] = row
        log(f"[vit-data] PVT-B3 4 steps at batch {batch}, --checkpoint-activations "
            f"{remat}: {ips:.1f} images/s after the first step ({run:.1f} from the "
            f"loader's start), gap {gap:.1f} ms a step; peak device memory "
            f"{row['peak_gib']:.3f} GiB; launches {json.dumps(got)} (predicted "
            f"{json.dumps(want)}); {card}")
        if got != want:
            raise AssertionError(f"PVT-B3 remat={remat}: launches {got}, want {want}")
    shutil.rmtree(f"{VIT_OUT_DIR}_pvt", ignore_errors=True)
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_phase
    log(f"[vit-data] phase 7b in {out['s']:.2f} s")
    return out


def zoo_phase(torch, card, counters):
    """The rest of the attention zoo, the ViT stems, the JAX factory's other
    optimizers and ``cli.validate``, at the headline's full width and depth
    (``evit_tiny_p8``, 784 tokens, dim 192, 3 heads, 12 blocks):

    * serve each of ``ZOO_CELLS`` at B=128 bf16: one forward of 128
      synthetic images (finite logits; K2 12 launches on its tensor-core
      route with a stem, no kernel for RA and ScatterBrain), then
      ``cli/train_vit.py::compute_throughput`` (33 forwards) for images/s
      and the peak memory;
    * the same f32 model at B=2 on the card and on the CPU in this process,
      RA with the same key indices on both, logits within ``LOGITS_TOL``,
      for each of ``ZOO_CELLS`` and ``ZOO_CHECK_CELLS`` (K2 12 launches on
      the EVA cells without a halo, T5 RPE's bias included), then each of
      ``ZOO_MODULE_CELLS``'s attention modules alone (halos, key-padding
      masks, T5 RPE, the 1-D local forward; no kernel);
    * 4 CLI steps at B=128 ``--bf16`` of each cell and of the headline EVA
      with each of ``ZOO_OPTIMIZERS`` (CUDA events around each step; K1 48
      forward and 48 backward launches on the tensor-core routes and K2 48
      in the f32 end-of-epoch eval with EVA, none with RA and ScatterBrain),
      finite losses, updates/s over steps 2-4, peak memory;
    * one optimizer step of the headline's parameters, each optimizer and
      AdamW, timed with CUDA events;
    * ``validate --task mt`` over the MT protocol's valid split from its
      newest checkpoint (K4 6 launches a batch of 16, all on the f32
      route) and ``validate --task lm`` from the LM protocol's (no kernel,
      the valid split's tokens), then both protocols' directories removed.

    ``counters`` maps (module, attribute) of every launch count.  Returns
    the phase's figures."""
    import numpy as np

    from efficient_attention_torch import AttentionFactory
    from efficient_attention_torch.attention.randomized import RandomizedAttention
    from efficient_attention_torch.cli import train_lm, train_vit, validate
    from efficient_attention_torch.data.imagenet import SyntheticImageDataset
    from efficient_attention_torch.data.indexed_dataset import MMapIndexedDataset
    from efficient_attention_torch.data.lm_context_window import context_window_blocks
    from efficient_attention_torch.training import optim, train_state

    def zero_counts():
        for mod, attr in counters:
            setattr(mod, attr, 0)

    def counts():
        return {f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}": getattr(mod, attr)
                for mod, attr in counters if getattr(mod, attr)}

    def k2_bf16(n):
        return {"eva_single.LAUNCHES": n, "eva_single.LAUNCHES_MMA": n}

    t_phase = time.perf_counter()
    out = {"serve": {}, "card_vs_cpu": {}, "train": {}, "optimizer_step_ms": {},
           "validate": {}}
    ds = SyntheticImageDataset(128, 224, 1000, train=False)
    images = torch.stack([torch.from_numpy(ds.load(i, None)[0]) for i in range(128)])

    # serving at B=128 bf16
    for cell, argv in ZOO_CELLS.items():
        stem = cell.endswith("stem")
        args = train_vit.parse_args(argv + ["--throughput", "--bf16"])
        train_vit.check_ported(args)
        model = train_vit.build_model(args).to(device="cuda", dtype=torch.bfloat16)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with torch.no_grad():
            logits = model(images.to(device="cuda", dtype=torch.bfloat16))
        torch.cuda.synchronize()
        got = counts()
        if (logits.shape != (128, 1000) or not torch.isfinite(logits).all()
                or got != (k2_bf16(12) if stem else {})):
            raise AssertionError(f"[zoo serve] {cell}: logits {tuple(logits.shape)}, "
                                 f"finite {bool(torch.isfinite(logits).all())}, "
                                 f"launches {got}")
        zero_counts()
        res = train_vit.compute_throughput(model, args, torch.device("cuda"),
                                           torch.bfloat16)
        torch.cuda.synchronize()
        got = counts()
        row = {"images_per_s": res["images_per_sec"],
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        out["serve"][cell] = row
        log(f"[zoo serve] {cell}, B=128 bf16: {row['images_per_s']:.1f} images/s "
            f"(compute_throughput, 30 forwards after 3), peak device memory "
            f"{row['peak_gib']:.3f} GiB; launches {json.dumps(got)}; {card}")
        if got != (k2_bf16(12 * 33) if stem else {}):
            raise AssertionError(f"[zoo serve] {cell}: launches {got} in 33 forwards")
        del model, logits

    # card against CPU, f32 at B=2 (RA with the same key indices); K2 on
    # the EVA cells without a halo, no kernel on the others
    idx = torch.from_numpy(np.random.default_rng(7).integers(0, 784, (2, 3, 784)))
    x2 = images[:2].float()
    for cell, argv in {**ZOO_CELLS, **ZOO_CHECK_CELLS}.items():
        model = train_vit.build_model(train_vit.parse_args(argv + ["--eval"]))
        on_card = copy.deepcopy(model).cuda()
        with torch.no_grad(), mock.patch.object(
                RandomizedAttention, "_sample_key_indices",
                lambda self, pi: idx.to(pi.device)):
            want = model(x2)
            zero_counts()
            got_logits = on_card(x2.cuda()).cpu()
        got = counts()
        err = (got_logits - want).abs().max().item()
        out["card_vs_cpu"][cell] = err
        log(f"[zoo card-vs-cpu] {cell}, f32 B=2: max abs err {err:.3e} (tol "
            f"{LOGITS_TOL:.0e}), max |logit| {want.abs().max().item():.3e}; "
            f"launches {json.dumps(got)}")
        if not err <= LOGITS_TOL:
            raise AssertionError(f"[zoo] {cell}: f32 logits card vs CPU differ by {err}")
        k2 = (argv[argv.index("--attn-name") + 1] == "eva"
              and "--attn-overlap-window" not in argv)
        if k2 != (got.get("eva_single.LAUNCHES") == 12) or not set(got) <= (
                {"eva_single.LAUNCHES", "eva_single.LAUNCHES_MMA"} if k2 else set()):
            raise AssertionError(f"[zoo] {cell}: launches {got} (K2 12 wanted: {k2})")
        del model, on_card

    # attention modules alone, card against CPU, f32 at B=2, the parameters
    # moved off their initial values by a seeded draw (the RPE tables start
    # at 0); no kernel
    for cell, (name, args, shape, masked) in ZOO_MODULE_CELLS.items():
        torch.manual_seed(0)
        module = AttentionFactory.build_attention(name, args).eval()
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in module.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        n = int(np.prod(shape[1:-1]))
        mask = None
        if masked:  # a fifth of the keys padded, each row's first kept
            mask = torch.from_numpy(rng.random((shape[0], n)) < 0.2)
            mask[:, 0] = False
        on_card = copy.deepcopy(module).cuda()
        with torch.no_grad():
            want = module(x, mask)
            zero_counts()
            got_out = on_card(x.cuda(), None if mask is None else mask.cuda()).cpu()
        got = counts()
        err = (got_out - want).abs().max().item()
        out["card_vs_cpu"][cell] = err
        log(f"[zoo card-vs-cpu] {cell} module, f32 {tuple(shape)}: max abs err "
            f"{err:.3e} (tol {LOGITS_TOL:.0e}), max |out| {want.abs().max().item():.3e}; "
            f"launches {json.dumps(got)}")
        if (not err <= LOGITS_TOL or got or tuple(got_out.shape) != tuple(shape)
                or not torch.isfinite(want).all()):
            raise AssertionError(f"[zoo] {cell}: module output card vs CPU differs by "
                                 f"{err}, launches {got}")
        del module, on_card

    # 4 CLI training steps at B=128 --bf16, CUDA events around each step
    events = []
    real_step = train_state.make_vit_train_step

    def make_timed_step(*a, **kw):
        step = real_step(*a, **kw)

        def run(*xs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = step(*xs)
            end.record()
            events.append((start, end))
            return res

        return run

    eva_train = {"eva_packed.LAUNCHES_FWD": 48, "eva_packed.LAUNCHES_BWD": 48,
                 "eva_packed.LAUNCHES_FWD_MMA": 48, "eva_packed.LAUNCHES_BWD_MMA": 48,
                 "eva_single.LAUNCHES": 48}
    runs = [(cell, argv) for cell, argv in ZOO_CELLS.items()] + [
        (f"eva {name}", MAIN_ARGV + ["--opt", name]) for name in ZOO_OPTIMIZERS]
    for run_name, argv in runs:
        shutil.rmtree(ZOO_OUT_DIR, ignore_errors=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        events.clear()
        t0 = time.perf_counter()
        with mock.patch.object(train_state, "make_vit_train_step", make_timed_step):
            record = train_vit.cli_main(argv + ZOO_TRAIN_ARGV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        step_ms = [a.elapsed_time(b) for a, b in events]
        row = {"loss": record["loss"], "val_loss": record["val_loss"],
               "step_ms": step_ms, "updates_per_s": 1e3 / (sum(step_ms[1:]) / 3),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "wall_s": wall}
        out["train"][run_name] = row
        log(f"[zoo train] {run_name}, 4 steps at B=128 --bf16 + the eval: loss "
            f"{record['loss']:.4f}, grad norm {record['grad_norm']:.4f}, val loss "
            f"{record['val_loss']:.4f}; steps {', '.join(f'{t:.2f}' for t in step_ms)} "
            f"ms (CUDA events), {row['updates_per_s']:.3f} updates/s over steps 2-4; "
            f"peak device memory {row['peak_gib']:.3f} GiB; the call {wall:.2f} s; "
            f"launches {json.dumps(got)}; {card}")
        for key in ("loss", "grad_norm", "val_loss", "val_acc1"):
            if not math.isfinite(record[key]):
                raise AssertionError(f"[zoo train] {run_name}: non-finite {key} {record}")
        want = {} if run_name in ("ra", "scatterbrain") else eva_train
        if len(step_ms) != 4 or got != want:
            raise AssertionError(f"[zoo train] {run_name}: {len(step_ms)} steps, "
                                 f"launches {got} (want {want})")
    shutil.rmtree(ZOO_OUT_DIR, ignore_errors=True)

    # one optimizer step of the headline's parameters, each optimizer
    model = train_vit.build_model(train_vit.parse_args(MAIN_ARGV)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = [p for p in model.parameters()]
    grads = [1e-3 * torch.randn(p.shape, generator=gen, device="cuda") for p in params]
    for name in ("adamw",) + ZOO_OPTIMIZERS:
        opt = optim.make_optimizer(name, model.named_parameters(), lambda step: 1e-4,
                                   weight_decay=0.05, clip_grad=5.0, momentum=0.9)

        def step():
            for p, g in zip(params, grads):
                p.grad = g
            opt.step()

        out["optimizer_step_ms"][name] = cuda_ms(step, 20)
    n_params = sum(p.numel() for p in params)
    log(f"[zoo optim] one step of {n_params} f32 parameters (clip 5.0, the "
        f"headline's weight-decay mask), ms (CUDA events, 20 steps): "
        f"{json.dumps(out['optimizer_step_ms'])}; {card}")
    del model, params, grads, opt

    # validate --task mt from the MT protocol's checkpoints, --task lm from
    # the LM protocol's
    pairs = MT_DATA_PAIRS["valid"]
    zero_counts()
    t0 = time.perf_counter()
    res = validate.cli_main(["--task", "mt"] + MT_DATA_ARGV + [
        "--path", f"{MT_DATA_DIR}/save/ckpt", "--valid-subset-size", str(pairs),
        "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = counts()
    batches = -(-pairs // validate.BATCH)
    want = {"eva_1d.LAUNCHES": 6 * batches, "eva_1d.LAUNCHES_TF32": 6 * batches}
    out["validate"]["mt"] = dict(res, seconds=secs)
    log(f"[zoo validate] --task mt, {pairs} valid pairs in {batches} batches: "
        f"{json.dumps(res)} in {secs:.2f} s (model and checkpoint included); "
        f"launches {json.dumps(got)}; {card}")
    if (got != want or not all(math.isfinite(res[k]) for k in ("valid_loss", "valid_ppl"))
            or res["tokens"] <= 0):
        raise AssertionError(f"[zoo validate] mt: {res}, launches {got} (want {want})")
    valid = MMapIndexedDataset(f"{LM_DATA_DIR}/bin/valid").flat_tokens()
    lm_args = train_lm.parse_args(LM_DATA_ARGV)
    want_tokens = sum(int(m[1:].sum()) for _, m in context_window_blocks(
        valid, lm_args.tokens_per_sample + 1, 0, pad_idx=1))
    zero_counts()
    t0 = time.perf_counter()
    res = validate.cli_main(["--task", "lm"] + LM_DATA_ARGV + [
        "--checkpoint", f"{LM_DATA_DIR}/save/ckpt"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = counts()
    out["validate"]["lm"] = dict(res, seconds=secs)
    log(f"[zoo validate] --task lm, the valid split: {json.dumps(res)} in "
        f"{secs:.2f} s (model and checkpoint included); launches {json.dumps(got)}; "
        f"{card}")
    if got or not math.isfinite(res["ppl"]) or res["tokens"] != want_tokens:
        raise AssertionError(f"[zoo validate] lm: {res}, launches {got}, "
                             f"{want_tokens} tokens predicted")
    shutil.rmtree(LM_DATA_DIR, ignore_errors=True)
    shutil.rmtree(MT_DATA_DIR, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[zoo] the phase took {out['phase_s']:.2f} s")
    return out


# ---- the scale-out phase: the mesh on torch.distributed with one card

SCALEOUT_OUT_DIR = "build/smoke_scaleout"
# the headline train step's routes: (use_fsdp, use_tp) of shard_model, None
# for the unwrapped step
SCALEOUT_ROUTES = {"unwrapped": None, "ddp": (False, False),
                   "fsdp2": (True, False), "tp": (False, True),
                   "fsdp2+tp": (True, True)}
# The checked steps run at the DeiT recipe's rate after its warmup (5e-4 x
# 128 / 512), where 2 AdamW steps move a weight by up to 2.5e-4.  A route
# is held to the unwrapped step's losses within one bf16 rounding, its
# gradient norms within 1e-3 relative, and the change of its parameters
# over the steps to the unwrapped step's change: the norm of their
# difference over the norm of that change.  On the H100 the routes at
# world 1 differ from it by 0.012-0.014 of that change and up to 8e-5 of
# the norms, as the unwrapped step does from itself; rank 0's rows alone
# by 0.97 and 0.32.
SCALEOUT_LOSS_TOL = 2 ** -7
SCALEOUT_NORM_TOL = 1e-3
SCALEOUT_UPDATE_TOL = 0.1
SCALEOUT_CHECK_STEPS = 2
SCALEOUT_TIMED_STEPS = 10


def scaleout_batch(torch, batch, seed=70):
    """The headline's images and labels of a global batch, made on the CPU
    from a seed (so every process makes the same)."""
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn(batch, 224, 224, 3, generator=gen)
    labels = torch.randint(0, 1000, (batch,), generator=gen)
    return images, labels


def scaleout_state(torch, model, sharding):
    """AdamW of the DeiT recipe (clip 5.0, weight decay 0.05, the EMA) at
    its rate after the warmup, on ``model`` (or its shards)."""
    from efficient_attention_torch.training.optim import (
        cosine_schedule,
        make_optimizer,
    )
    from efficient_attention_torch.training.train_state import TrainState

    schedule = cosine_schedule(5e-4 * 128 / 512, warmup_steps=0,
                               total_steps=1000)
    opt = make_optimizer("adamw", model.named_parameters(), schedule,
                         weight_decay=0.05, clip_grad=5.0)
    return TrainState(model if sharding is None else sharding.model, opt,
                      ema_decay=0.99996, sharding=sharding)


def scaleout_steps(torch, state, sharding, images, labels, n):
    """``n`` headline train steps (bf16, no mixup or erasing, drop path 0,
    zero RF noise) on this rank's rows; their losses and gradient norms."""
    from efficient_attention_torch.attention.eva import EVA
    from efficient_attention_torch.parallel import local_rows
    from efficient_attention_torch.training.train_state import make_vit_train_step

    step = make_vit_train_step(None, 1000, 0.1, compute_dtype=torch.bfloat16)
    mesh = None if sharding is None else sharding.mesh
    x = local_rows(images, mesh).cuda()
    y = local_rows(labels, mesh).cuda()
    metrics = []
    with mock.patch.object(EVA, "_sample_weights", lambda self, mu: mu):
        for _ in range(n):
            metrics.append(step(state, x, y, None))
    torch.cuda.synchronize()
    return ([float(m.loss) for m in metrics],
            [float(m.grad_norm) for m in metrics])


def scaleout_params(model, sharding):
    """The whole float parameters and buffers, float32 on the CPU."""
    params = model.state_dict() if sharding is None else sharding.state_dict()
    return {k: v.detach().float().cpu() for k, v in params.items()
            if v.is_floating_point()}


def scaleout_checked(torch, model, sharding, images, labels):
    """The checked steps from the model's present weights: losses,
    gradient norms and the parameters after them."""
    state = scaleout_state(torch, model, sharding)
    losses, norms = scaleout_steps(torch, state, sharding, images, labels,
                                   SCALEOUT_CHECK_STEPS)
    return state, {"losses": losses, "norms": norms,
                   "params": scaleout_params(model, sharding)}


def scaleout_errors(torch, got, ref, init):
    """A run's losses, gradient norms and parameters after the checked steps
    (``got``) against the unwrapped step's (``ref``); both started from
    ``init``.  AdamW moves a weight by about its rate whatever the size of
    its gradient, so the parameters' change over the steps is compared as
    a whole."""
    d_ref = torch.cat([(ref["params"][k] - v).flatten() for k, v in init.items()])
    d_got = torch.cat([(got["params"][k] - v).flatten() for k, v in init.items()])

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    return {"loss_rel_err": rel(got["losses"], ref["losses"]),
            "grad_norm_rel_err": rel(got["norms"], ref["norms"]),
            "update_rel_err": float((d_got - d_ref).norm() / d_ref.norm()),
            "update_max_abs_err": float((d_got - d_ref).abs().max()),
            "update_max_abs": float(d_ref.abs().max())}


def scaleout_ok(err) -> bool:
    return (err["loss_rel_err"] <= SCALEOUT_LOSS_TOL
            and err["grad_norm_rel_err"] <= SCALEOUT_NORM_TOL
            and err["update_rel_err"] <= SCALEOUT_UPDATE_TOL)


def scaleout_model(torch):
    from efficient_attention_torch.cli import train_vit

    return train_vit.build_model(train_vit.parse_args(MAIN_ARGV + ["--drop-path", "0"]))


def scaleout_rank(argv) -> int:
    """One of the two gloo ranks on the one card (``chip_smoke.py
    --scaleout-rank RANK PORT``): the headline step under DDP on its 64 rows
    of the global batch of 128, 2 steps; each rank saves its losses,
    gradient norms, whole parameters and K1's launches for the parent."""
    import torch

    from efficient_attention_torch.ops.kernels import eva_packed as k1
    from efficient_attention_torch.parallel import init_distributed, make_mesh, shard_model

    rank, port = int(argv[0]), int(argv[1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"localhost:{port}", 2, rank, device_type="cuda",
                     backend="gloo")
    try:
        mesh = make_mesh(device_type="cuda")
        model = scaleout_model(torch).cuda()
        sharding = shard_model(model, mesh)
        images, labels = scaleout_batch(torch, 128)
        k1.LAUNCHES_FWD = k1.LAUNCHES_BWD = 0
        _, out = scaleout_checked(torch, model, sharding, images, labels)
        out.update(k1=(k1.LAUNCHES_FWD, k1.LAUNCHES_BWD),
                   backend=torch.distributed.get_backend())
        torch.save(out, f"{SCALEOUT_OUT_DIR}/rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
    return 0


def scaleout_phase(torch, card, counters, k1, k3, k4):
    """The mesh of ``parallel`` on the one card (``counters`` maps every
    launch count, each set to 0 just before a run and read just after):

    * ``train_mt --distributed --num-processes 1`` (NCCL, the CLI joining
      and leaving its own group) for 8 updates at the MT training cell's
      flags: updates/s, K4's launches in its validations as predicted;
    * an in-process NCCL group of one rank: the headline ViT train step
      (B=128, bf16) unwrapped and then through DDP, FSDP2 (an fsdp axis of
      1, ``fully_shard`` applied anyway), TP (a model axis of 1,
      ``parallelize_module`` applied anyway) and FSDP2 with TP, each 2
      checked steps at the recipe's rate after warmup (``scaleout_ok``
      against the unwrapped step; K1 12 + 12 a step) and 10 timed ones
      (images/s, peak memory); two planted faults that the check must
      refuse: the step on rank 0's 64 rows alone (what DDP without its
      all-reduce computes there) and DDP summing where it averages (a comm
      hook that doubles the gradients); the LM train cell's step (18 x 512,
      bf16) under DDP: tokens/s and K3 16 + 16 a step;
    * two gloo ranks on the same card (``scaleout_rank``): the headline step
      under DDP at 64 rows a rank, held to the unwrapped step by the same
      check, and the two ranks' parameters equal.

    Rates that need two cards are not measured: the card is one."""
    import os

    import torch.distributed as dist

    from efficient_attention_torch.cli import train_lm, train_mt
    from efficient_attention_torch.parallel import init_distributed, make_mesh, shard_model
    from efficient_attention_torch.parallel.distributed import free_port
    from efficient_attention_torch.training import lm_steps

    t_phase = time.perf_counter()
    shutil.rmtree(SCALEOUT_OUT_DIR, ignore_errors=True)
    os.makedirs(SCALEOUT_OUT_DIR)
    out = {"card": card, "two_cards": "not measured (one card)"}

    def zero_counts():
        for mod, attr in counters:
            setattr(mod, attr, 0)

    # -- train_mt joined to its own NCCL group of one process
    real_step = lm_steps.make_mt_train_step
    timed = []

    def make_timed_step(*a, **kw):
        step = real_step(*a, **kw)

        def run(*sa):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step(*sa)
            end.record()
            timed.append((start, end))
            return metrics

        return run

    argv = MT_TRAIN_ARGV + ["--distributed", "--num-processes", "1",
                            "--save-dir", f"{SCALEOUT_OUT_DIR}/mt", "--no-save"]
    zero_counts()
    with mock.patch.object(lm_steps, "make_mt_train_step", make_timed_step):
        stats = train_mt.cli_main(argv)
    torch.cuda.synchronize()
    if dist.is_initialized():
        raise AssertionError("train_mt left its process group behind")
    *_, want_k4 = mt_k4_prediction(train_mt.parse_args(argv))
    step_ms = [a.elapsed_time(b) for a, b in timed]
    out["mt"] = {"stats": stats, "updates_per_s_steps_2_8": 7e3 / sum(step_ms[1:8]),
                 "k4_validation": k4.LAUNCHES, "k4_predicted": want_k4,
                 "k4_f32_route": k4.LAUNCHES_TF32}
    log(f"[scaleout] train_mt --distributed --num-processes 1 (NCCL): "
        f"{json.dumps(out['mt'])}; {card}")
    if not all(math.isfinite(stats[k]) for k in ("loss", "valid_loss", "valid_bleu")):
        raise AssertionError(f"non-finite MT stats {stats}")
    if (stats["step"], len(timed)) != (8, 8) or k4.LAUNCHES != want_k4 \
            or k4.LAUNCHES_TF32 != want_k4:
        raise AssertionError(f"MT under one NCCL rank: {stats['step']} updates, "
                             f"{k4.LAUNCHES} K4 launches ({want_k4} predicted, "
                             f"{k4.LAUNCHES_TF32} on the f32 route)")

    # -- the headline step's routes on an in-process NCCL group of one rank
    init_distributed(f"localhost:{free_port()}", 1, 0, device_type="cuda")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()} on the card")
        images, labels = scaleout_batch(torch, 128)
        base = scaleout_model(torch)
        init = scaleout_params(base, None)
        routes, ref, unwrapped = {}, None, None

        def rate(state, sharding):
            scaleout_steps(torch, state, sharding, images, labels, 1)
            t0 = time.perf_counter()
            scaleout_steps(torch, state, sharding, images, labels,
                           SCALEOUT_TIMED_STEPS)
            return 128 * SCALEOUT_TIMED_STEPS / (time.perf_counter() - t0)

        for name, route in SCALEOUT_ROUTES.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model = copy.deepcopy(base).cuda()
            sharding = None
            if route is not None:
                sharding = shard_model(model, make_mesh(device_type="cuda"),
                                       use_fsdp=route[0], use_tp=route[1],
                                       compute_dtype=torch.bfloat16)
            zero_counts()
            state, got = scaleout_checked(torch, model, sharding, images, labels)
            k1_step = (k1.LAUNCHES_FWD / SCALEOUT_CHECK_STEPS,
                       k1.LAUNCHES_BWD / SCALEOUT_CHECK_STEPS)
            r = {"images_per_s": rate(state, sharding), "k1_a_step": k1_step,
                 "losses": got["losses"], "grad_norms": got["norms"],
                 "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                 "log": [] if sharding is None else sharding.log[-1:] + [
                     f"{len(sharding.log) - 1} more lines"]}
            if ref is None:
                ref, unwrapped = got, state
            else:
                r.update(scaleout_errors(torch, got, ref, init))
            routes[name] = r
            log(f"[scaleout] headline step B=128 bf16 {name}: {json.dumps(r)}; {card}")
            if k1_step != (12, 12):
                raise AssertionError(f"{name}: K1 {k1_step} launches a step (12 + 12)")
            if not all(math.isfinite(v) for v in got["losses"] + got["norms"]):
                raise AssertionError(f"{name}: losses {got['losses']}, "
                                     f"gradient norms {got['norms']}")
            if ref is not got and not scaleout_ok(r):
                raise AssertionError(f"{name} differs from the unwrapped step: {r}")
            if sharding is not None:
                del model, sharding, state
            del got
        # the unwrapped step once more, against itself: what the bf16
        # step's own run-to-run differences leave under the limits
        model = copy.deepcopy(base).cuda()
        _, got = scaleout_checked(torch, model, None, images, labels)
        out["unwrapped_twice"] = scaleout_errors(torch, got, ref, init)
        log(f"[scaleout] the unwrapped step twice: "
            f"{json.dumps(out['unwrapped_twice'])}; {card}")
        if not scaleout_ok(out["unwrapped_twice"]):
            raise AssertionError(f"the unwrapped step differs from itself: "
                                 f"{out['unwrapped_twice']}")
        # planted faults, which the check must refuse: rank 0 of two DDP
        # ranks without the all-reduce trains on its 64 rows alone; DDP
        # summing two ranks' equal gradients where it averages them
        faults = {}
        model = copy.deepcopy(base).cuda()
        _, got = scaleout_checked(torch, model, None, images[:64], labels[:64])
        faults["rank0_rows_alone"] = scaleout_errors(torch, got, ref, init)
        model = copy.deepcopy(base).cuda()
        sharding = shard_model(model, make_mesh(device_type="cuda"),
                               use_fsdp=False, use_tp=False,
                               compute_dtype=torch.bfloat16)

        def doubled(_, bucket):
            fut = torch.futures.Future()
            fut.set_result(bucket.buffer() * 2)
            return fut

        sharding.model.register_comm_hook(None, doubled)
        _, got = scaleout_checked(torch, model, sharding, images, labels)
        faults["ddp_sums"] = scaleout_errors(torch, got, ref, init)
        del model, sharding, got
        out["planted_faults"] = faults
        log(f"[scaleout] planted faults: {json.dumps(faults)}; {card}")
        for name, err in faults.items():
            if scaleout_ok(err):
                raise AssertionError(f"the check passed the planted fault {name}: {err}")
        # the unwrapped step timed again after the routes (turns: first and
        # last); each route's share is of the two readings' mean
        last = rate(unwrapped, None)
        first = routes["unwrapped"]["images_per_s"]
        routes["unwrapped"]["images_per_s_again"] = last
        for r in routes.values():
            r["share_of_unwrapped"] = r["images_per_s"] / ((first + last) / 2)
        log(f"[scaleout] the unwrapped step again: {last:.1f} images/s (first "
            f"{first:.1f}); shares {json.dumps({k: v['share_of_unwrapped'] for k, v in routes.items()})}; {card}")
        del unwrapped, base
        out["vit_routes"] = routes

        # the LM train cell's step under DDP
        from efficient_attention_torch.training.lm_steps import make_lm_train_step
        from efficient_attention_torch.training.optim import make_optimizer
        from efficient_attention_torch.training.train_state import TrainState

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lm_args = train_lm.parse_args(LM_ARGV)
        model = train_lm.build_model(lm_args, LM_VOCAB, dense_tokens=True).cuda()
        sharding = shard_model(model, make_mesh(device_type="cuda"))
        state = TrainState(sharding.model, make_optimizer(
            "nag", model.named_parameters(), lambda step: 1e-3,
            weight_decay=0.0, clip_grad=0.1), sharding=sharding)
        lm_step = make_lm_train_step(use_adaptive=True, compute_dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(71)
        batch = torch.randint(4, LM_VOCAB, (18, 513), generator=gen, device="cuda")
        zero_counts()
        lm_step(state, batch[:, :-1], batch[:, 1:], gen)
        torch.cuda.synchronize()
        k3_step = (k3.LAUNCHES_FWD, k3.LAUNCHES_BWD)
        t0 = time.perf_counter()
        for _ in range(3):
            m = lm_step(state, batch[:, :-1], batch[:, 1:], gen)
        torch.cuda.synchronize()
        out["lm_ddp"] = {"tokens_per_s": 18 * 512 * 3 / (time.perf_counter() - t0),
                         "k3_a_step": k3_step, "loss": float(m.loss),
                         "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        log(f"[scaleout] LM step 18x512 bf16 under DDP (NCCL, 1 rank): "
            f"{json.dumps(out['lm_ddp'])}; {card}")
        if k3_step != (16, 16) or not math.isfinite(out["lm_ddp"]["loss"]):
            raise AssertionError(f"LM under DDP: K3 {k3_step} a step (16 + 16), "
                                 f"loss {out['lm_ddp']['loss']}")
        del model, sharding, state, batch
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # -- two gloo ranks on the one card
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, "--scaleout-rank",
                               str(rank), str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            log(f"[scaleout] gloo rank {rank} on the card failed:\n{text[-4000:]}")
            raise AssertionError(f"gloo rank {rank} exited {p.returncode}")
    ranks = [torch.load(f"{SCALEOUT_OUT_DIR}/rank{r}.pt", weights_only=False)
             for r in range(2)]
    err = scaleout_errors(torch, ranks[0], ref, init)
    same = all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in init)
    out["gloo_2_ranks"] = dict(err, losses=ranks[0]["losses"],
                               grad_norms=ranks[0]["norms"],
                               ranks_params_equal=same,
                               k1=[r["k1"] for r in ranks],
                               backend=ranks[0]["backend"],
                               wall_s=time.perf_counter() - t0)
    log(f"[scaleout] 2 gloo ranks on one card, DDP, 64 rows a rank: "
        f"{json.dumps(out['gloo_2_ranks'])}; {card}")
    if (ranks[0]["losses"], ranks[0]["norms"]) != (ranks[1]["losses"], ranks[1]["norms"]) \
            or not same:
        raise AssertionError("the ranks' losses, gradient norms or parameters differ")
    if not scaleout_ok(err):
        raise AssertionError(f"2 gloo ranks differ from one process: {out['gloo_2_ranks']}")
    if any(tuple(r["k1"]) != (24, 24) for r in ranks):
        raise AssertionError(f"K1 launches on the ranks {[r['k1'] for r in ranks]}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[scaleout] the phase took {out['phase_s']:.2f} s")
    return out


def main() -> int:
    if sys.argv[1:2] == ["--scaleout-rank"]:
        return scaleout_rank(sys.argv[2:])
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from efficient_attention_torch.cli import train_vit
        from efficient_attention_torch.attention.eva import EVA
        from efficient_attention_torch.ops.kernels import _build
        from efficient_attention_torch.ops.kernels import eva_packed as k1
        from efficient_attention_torch.ops.kernels import eva_single as k2
        from efficient_attention_torch.ops.kernels import causal_packed as k3
        from efficient_attention_torch.ops.kernels import lara_fused as k5
        from efficient_attention_torch.ops.kernels import performer_fused as k6
        from efficient_attention_torch.ops.kernels import local_packed as k7
        from efficient_attention_torch.ops.kernels import eva_1d as k4
        from efficient_attention_torch.ops.kernels import eva_summaries as k8
        from efficient_attention_torch.ops.kernels import eva_mega as k10
        from efficient_attention_torch.ops.kernels import eva_kernel as k11
        from efficient_attention_torch.ops.kernels import eva_rowmajor as k12
        from efficient_attention_torch.cli import generate, train_lm
        from efficient_attention_torch.attention.causal_eva import (
            CausalEVAttention,
        )
        from efficient_attention_torch.ops import windows
    except ImportError as err:
        print(f"chip_smoke: run from the root of a checkout ({err})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    # every kernel's launch count, for the phases that assert which ran
    all_counters = (
        (k1, "LAUNCHES_FWD"), (k1, "LAUNCHES_BWD"), (k1, "LAUNCHES_OUT"),
        (k2, "LAUNCHES"), (k3, "LAUNCHES_FWD"), (k3, "LAUNCHES_BWD"),
        (k4, "LAUNCHES"), (k4, "LAUNCHES_TF32"), (k5, "LAUNCHES"),
        (k6, "LAUNCHES"), (k7, "LAUNCHES"), (k8, "LAUNCHES"),
        (k10, "LAUNCHES_SUMMARIES"), (k10, "LAUNCHES_ATTENTION"),
        (k11, "LAUNCHES"), (k12, "LAUNCHES"))

    # ---- 1. build
    t0 = time.perf_counter()
    all_kernels = (k2.NAME, k1.NAME, k3.NAME, k4.NAME, k5.NAME, k6.NAME, k7.NAME,
                   k8.NAME, k1.NAME_OUT, k10.NAME, k11.NAME, k12.NAME)
    built = _build.build(all_kernels)
    log(f"[build] {json.dumps(built)} in {time.perf_counter() - t0:.2f} s")
    for name in all_kernels:
        for line in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    lib_smem = k2._lib().eva_single_smem_bytes(98, 64, 2, 49, 7, 7)
    if lib_smem != k2.smem_bytes(98, 64, 2, 49, 7, 7):
        raise AssertionError(f"gate's smem layout {k2.smem_bytes(98, 64, 2, 49, 7, 7)}"
                             f" != kernel's {lib_smem}")
    # K2's tensor-core route: its gate and layout against the kernel's, its
    # registers and spills (none allowed), blocks an SM (at least 2 at the
    # headline) at the cluster size plan() picks for each timed shape
    for d in k2.HEAD_DIMS:
        for itemsize in (2, 4):
            if bool(k2._lib().eva_single_uses_mma(d, itemsize)) != k2.uses_mma(d, itemsize):
                raise AssertionError(f"eva_single uses_mma({d}, {itemsize}): the kernel's "
                                     f"and the wrapper's differ")
    k2_plans = {label: k2.plan(B, nh, g, g, 7, j, d, 2)
                for label, (B, g, j, nh, d) in K2_SHAPES}
    for geo in ([(28, 28, 7, 4, 64, cs) for cs in (4, 8, 16)]
                + [(56, 56, 7, 8, 32, 8), (56, 56, 7, 8, 32, 16), (28, 28, 7, 4, 32, 4),
                   (14, 14, 7, 2, 32, 1), (14, 14, 7, 2, 32, 2), (14, 14, 7, 2, 64, 2),
                   (14, 14, 7, 2, 64, 4), (12, 12, 3, 4, 16, 8), (8, 8, 4, 4, 16, 1)]):
        if k2._lib().eva_single_mma_smem_bytes(*geo) != k2.mma_smem_bytes(*geo):
            raise AssertionError(f"eva_single mma_smem_bytes{geo} {k2.mma_smem_bytes(*geo)}"
                                 f" != the kernel's "
                                 f"{k2._lib().eva_single_mma_smem_bytes(*geo)}")
    k2_ptxas = mma_kernel_report(_build.BUILD_DIR / f"{k2.NAME}.log", "eva_single_mma_kernel")
    k2_blocks = {label: k2._lib().eva_single_mma_blocks_per_sm(g, g, 7, j, d,
                                                               k2_plans[label][0])
                 for label, (B, g, j, nh, d) in K2_SHAPES}
    log(f"[build] eva_single tensor-core route, ptxas: {json.dumps(k2_ptxas)}; plan "
        f"(cluster, smem bytes, tensor cores) {json.dumps(k2_plans)}; blocks an SM "
        f"(occupancy calculator) {json.dumps(k2_blocks)}")
    if any("0 bytes spill stores" not in v for v in k2_ptxas.values()):
        raise AssertionError(f"eva_single tensor-core route spills: {k2_ptxas}")
    if k2_blocks["headline"] < 2:
        raise AssertionError(f"eva_single tensor-core route: {k2_blocks} blocks an SM")
    for backward, d, S, C, itemsize in (
            (0, 64, 49, 49, 2), (0, 64, 49, 49, 4), (0, 32, 49, 49, 2),
            (0, 16, 16, 4, 2), (0, 16, 49, 196, 2), (0, 12, 49, 49, 2),
            (1, 64, 49, 49, 2), (1, 64, 49, 49, 4), (1, 32, 49, 49, 2),
            (1, 16, 16, 4, 2), (1, 12, 49, 49, 2)):
        lib_smem = k1._lib().eva_packed_smem_bytes(backward, d, S, C, itemsize)
        if lib_smem != k1.smem_bytes(bool(backward), d, S, C, itemsize):
            raise AssertionError(f"eva_packed gate's smem layout != kernel's "
                                 f"{lib_smem} {(backward, d, S, C, itemsize)}")
    for gate in ("fwd_uses_mma", "bwd_uses_mma"):
        for d in k1.HEAD_DIMS:
            for itemsize in (2, 4):
                if (bool(getattr(k1._lib(), gate)(d, itemsize))
                        != getattr(k1, gate)(d, itemsize)):
                    raise AssertionError(f"eva_packed {gate}({d}, {itemsize}): "
                                         f"the kernel's and the wrapper's differ")
    # the tensor-core routes: registers and spills, blocks an SM (at least
    # 3 for the forward, 2 for the backward)
    for backward, part, least in ((0, "forward", 3), (1, "backward", 2)):
        tag = f"eva_packed_{'bwd' if backward else 'fwd'}_mma_kernel"
        k1_ptxas = mma_kernel_report(_build.BUILD_DIR / f"{k1.NAME}.log", tag)
        k1_blocks = {f"d{d}": k1._lib().eva_packed_mma_blocks_per_sm(backward, d, 49, 49)
                     for d in (64, 32)}
        log(f"[build] eva_packed tensor-core {part}, ptxas: {json.dumps(k1_ptxas)}; "
            f"blocks an SM at 49 + 49 keys (occupancy calculator): "
            f"{json.dumps(k1_blocks)}; {k1.smem_bytes(bool(backward), 64, 49, 49, 2)} "
            f"bytes of shared memory a block at head dim 64")
        if any("0 bytes spill stores" not in v for v in k1_ptxas.values()):
            raise AssertionError(f"eva_packed tensor-core {part} spills: {k1_ptxas}")
        if min(k1_blocks.values()) < least:
            raise AssertionError(f"eva_packed tensor-core {part}: {k1_blocks} blocks "
                                 f"an SM")
    for backward in (0, 1):
        qt = 32 if backward else 64
        lib_smem = k3._lib().causal_packed_smem_bytes(backward, 128, 128, 64, qt)
        if lib_smem != k3.smem_bytes(bool(backward), 128, 128, 64, qt):
            raise AssertionError(f"causal_packed gate's smem layout != kernel's "
                                 f"{lib_smem} (backward={backward})")
    # K3's split-TF32 forward: its gate and layout against the kernel's,
    # registers and spills (none allowed), blocks an SM (at least 3)
    for d in (48, 64, 128):
        for w in (8, 16, 48, 128):
            for itemsize in (2, 4):
                if (bool(k3._lib().causal_packed_fwd_uses_tf32x3(d, w, itemsize))
                        != k3.fwd_uses_tf32x3(d, w, itemsize)):
                    raise AssertionError(f"causal_packed fwd_uses_tf32x3{(d, w, itemsize)}:"
                                         f" the kernel's and the wrapper's differ")
    for d in k3.HEAD_DIMS:
        if k3._lib().causal_packed_tf32_smem_bytes(d) != k3.tf32_smem_bytes(d):
            raise AssertionError(f"causal_packed tf32_smem_bytes({d}) != the kernel's "
                                 f"{k3._lib().causal_packed_tf32_smem_bytes(d)}")
    k3_ptxas = mma_kernel_report(_build.BUILD_DIR / f"{k3.NAME}.log",
                                 "causal_packed_fwd_tf32x3_kernel")
    k3_blocks = {f"d{d}": k3._lib().causal_packed_tf32_blocks_per_sm(d)
                 for d in k3.HEAD_DIMS}
    log(f"[build] causal_packed split-TF32 forward, ptxas: {json.dumps(k3_ptxas)}; "
        f"blocks an SM (occupancy calculator): {json.dumps(k3_blocks)}; "
        f"{k3.tf32_smem_bytes(128)} bytes of shared memory a block at head dim 128")
    if any("0 bytes spill stores" not in v for v in k3_ptxas.values()):
        raise AssertionError(f"causal_packed split-TF32 forward spills: {k3_ptxas}")
    if min(k3_blocks.values()) < 3:
        raise AssertionError(f"causal_packed split-TF32 forward: {k3_blocks} blocks an SM")
    # and its split-TF32 backward: gate and layout, registers and spills
    # (none allowed), blocks an SM (one: a block holds a window's q and g)
    for d in (48, 64, 128):
        for w in (8, 16, 48, 128, 144):
            for itemsize in (2, 4):
                if (bool(k3._lib().causal_packed_bwd_uses_tf32x3(d, w, itemsize))
                        != k3.bwd_uses_tf32x3(d, w, itemsize)):
                    raise AssertionError(f"causal_packed bwd_uses_tf32x3{(d, w, itemsize)}:"
                                         f" the kernel's and the wrapper's differ")
            if (w % 16 == 0 and w <= k3.TF32_BWD_MAX_W and d in k3.HEAD_DIMS
                    and k3._lib().causal_packed_tf32_bwd_smem_bytes(d, w)
                    != k3.tf32_bwd_smem_bytes(d, w)):
                raise AssertionError(f"causal_packed tf32_bwd_smem_bytes({d}, {w}) != the "
                                     f"kernel's")
    k3b_ptxas = mma_kernel_report(_build.BUILD_DIR / f"{k3.NAME}.log",
                                  "causal_packed_bwd_tf32x3_kernel")
    k3b_blocks = {f"d{d}": k3._lib().causal_packed_tf32_bwd_blocks_per_sm(d)
                  for d in k3.HEAD_DIMS}
    log(f"[build] causal_packed split-TF32 backward, ptxas: {json.dumps(k3b_ptxas)}; "
        f"blocks an SM at windows of 128 (occupancy calculator): "
        f"{json.dumps(k3b_blocks)}; {k3.tf32_bwd_smem_bytes(128, 128)} bytes of shared "
        f"memory a block at head dim 128")
    if any("0 bytes spill stores" not in v for v in k3b_ptxas.values()):
        raise AssertionError(f"causal_packed split-TF32 backward spills: {k3b_ptxas}")
    if min(k3b_blocks.values()) < 1:
        raise AssertionError(f"causal_packed split-TF32 backward: {k3b_blocks} blocks an SM")
    for k, fn, args, lib_args in (
            (k5, "lara_fused_smem_bytes", (64, 49, 2, 392, 2), (64, 49, 1, 392, 2)),
            (k5, "lara_fused_smem_bytes", (64, 49, 2, 196, 1), (64, 49, 1, 196, 1)),
            (k5, "lara_fused_smem_bytes", (64, 64, 2, 392, 8), (64, 64, 1, 392, 8)),
            (k5, "lara_fused_smem_bytes", (16, 1, 2, 5, 16), (16, 1, 1, 5, 16)),
            (k5, "lara_fused_smem_bytes", (512, 16, 2), (512, 16, 1, 0, 1)),
            (k5, "lara_fused_smem_bytes", (64, 49, 4), (64, 49, 0, 0, 1)),
            (k5, "lara_fused_smem_bytes", (12, 4, 2), (12, 4, 1, 0, 1)),
            (k6, "performer_fused_smem_bytes", (64, 64, 2), (64, 64, 1)),
            (k6, "performer_fused_smem_bytes", (64, 64, 4), (64, 64, 0)),
            (k6, "performer_fused_smem_bytes", (12, 16, 2), (12, 16, 1)),
            (k7, "local_packed_smem_bytes", (64, 49, 2), (64, 49, 1)),
            (k7, "local_packed_smem_bytes", (64, 49, 4), (64, 49, 0)),
            (k7, "local_packed_smem_bytes", (64, 121, 2), (64, 121, 1)),
            (k7, "local_packed_smem_bytes", (32, 9, 2), (32, 9, 1)),
            (k7, "local_packed_smem_bytes", (16, 16, 2), (16, 16, 1)),
            (k7, "local_packed_smem_bytes", (12, 49, 2), (12, 49, 1))):
        if getattr(k._lib(), fn)(*lib_args) != k.smem_bytes(*args):
            raise AssertionError(f"{k.NAME} gate's smem layout != kernel's {args}")
    # K5's routes: the wrapper's plan against the kernel's (cluster size,
    # 0 the CUDA-core kernel, -1 the wmma kernel, -2 none), the cluster
    # kernel's registers and spills (none allowed) and how many clusters of
    # the headline's size fit the card at once
    for N in (1, 37, 50, 196, 784, 3136, 6272, 20000):
        for d in (12, 16, 32, 48, 64, 512):
            for C in (1, 16, 17, 49, 64, 65):
                for itemsize in (2, 4):
                    route = k5.plan(1, N, 1, d, C, itemsize)
                    want = -2 if route is None else route[0]
                    got = k5._lib().lara_fused_plan(N, d, C, int(itemsize == 2))
                    if got != want:
                        raise AssertionError(f"lara_fused plan{(N, d, C, itemsize)}: the "
                                             f"kernel's {got}, the wrapper's {want}")
    k5_ptxas = mma_kernel_report(_build.BUILD_DIR / f"{k5.NAME}.log",
                                 "lara_fused_cluster_kernel")
    k5_plan = k5.plan(128, 784, 3, 64, 49, 2)
    k5_clusters = k5._lib().lara_fused_max_active_clusters(784, 64, 49, k5_plan[0])
    log(f"[build] lara_fused cluster route, ptxas: {json.dumps(k5_ptxas)}; plan at the "
        f"headline (ranks, smem bytes, route) {json.dumps(k5_plan)}; clusters at once "
        f"(occupancy calculator) {k5_clusters}")
    if any("0 bytes spill stores" not in v for v in k5_ptxas.values()):
        raise AssertionError(f"lara_fused cluster route spills: {k5_ptxas}")
    if k5_clusters < 1:
        raise AssertionError(f"lara_fused: {k5_clusters} clusters fit the card")
    # K6's ring route: the wrapper's copy of its layout and grid against the
    # kernel's, its registers (spills of at most 64 bytes), and the blocks
    # an SM that the layout plan picks at the cell's shape allows
    for layout in ((64, 64, 784, 4, 64, 4), (64, 64, 784, 8, 128, 4),
                   (16, 16, 49, 4, 16, 4), (32, 128, 3136, 8, 64, 8),
                   (64, 64, 784, 4, 64, 3), (64, 64, 60000, 8, 128, 4)):
        want = k6.ring_smem_bytes(*layout) if k6.ring_config_ok(*layout) else -1
        if k6._lib().performer_fused_ring_smem_bytes(*layout) != want:
            raise AssertionError(f"performer_fused ring layout {layout}: the kernel's "
                                 f"{k6._lib().performer_fused_ring_smem_bytes(*layout)}, "
                                 f"the wrapper's {want}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, nh, bps in ((128, 3, 3), (1, 3, 3), (7, 12, 1), (128, 12, 3)):
        if k6._lib().performer_fused_ring_blocks(B, nh, bps) != k6.ring_blocks(B, nh, bps, sms):
            raise AssertionError(f"performer_fused ring_blocks{(B, nh, bps)} differ")
    k6_ptxas = mma_kernel_report(
        _build.BUILD_DIR / f"{k6.NAME}.log", "performer_fused_ring_kernel",
        names=lambda D, bools, ints: f"D={D} MT={ints[0]} W={ints[1]}")
    k6_plan = k6.plan(128, 784, 3, 64, 64, 2)
    k6_blocks = k6._lib().performer_fused_ring_blocks_per_sm(64, 64, k6_plan.warps,
                                                               k6_plan.smem)
    log(f"[build] performer_fused ring route, ptxas: {json.dumps(k6_ptxas)}; plan at the "
        f"headline {json.dumps(k6_plan._asdict())}; blocks an SM (occupancy "
        f"calculator) {k6_blocks}")
    spilled = {k: int(re.search(r"(\d+) bytes spill stores", v)[1]) for k, v in k6_ptxas.items()}
    if max(spilled.values()) > 64:
        raise AssertionError(f"performer_fused ring route spills: {k6_ptxas}")
    if k6_blocks < k6_plan.bps:
        raise AssertionError(f"performer_fused ring route: {k6_blocks} blocks an SM, the "
                             f"plan {k6_plan}")
    # K7's tensor-core route: its gate against the kernel's, its registers
    # and spills (none allowed), blocks an SM (at least 3 at head dim 64,
    # S = 49)
    for d in k7.HEAD_DIMS:
        for itemsize in (2, 4):
            if bool(k7._lib().local_packed_uses_mma(d, itemsize)) != k7.uses_mma(d, itemsize):
                raise AssertionError(f"local_packed uses_mma({d}, {itemsize}): the "
                                     f"kernel's and the wrapper's differ")
    k7_ptxas = mma_kernel_report(_build.BUILD_DIR / f"{k7.NAME}.log",
                                 "local_packed_fwd_mma_kernel")
    k7_blocks = {f"d{d} S{S}": k7._lib().local_packed_mma_blocks_per_sm(d, S)
                 for d, S in ((64, 49), (32, 49), (16, 49), (64, 121))}
    log(f"[build] local_packed tensor-core route, ptxas: {json.dumps(k7_ptxas)}; "
        f"blocks an SM (occupancy calculator): {json.dumps(k7_blocks)}; "
        f"{k7.smem_bytes(64, 49, 2)} bytes of shared memory a block at head dim 64, "
        f"S = 49")
    if any("0 bytes spill stores" not in v for v in k7_ptxas.values()):
        raise AssertionError(f"local_packed tensor-core route spills: {k7_ptxas}")
    if k7_blocks["d64 S49"] < 3:
        raise AssertionError(f"local_packed tensor-core route: {k7_blocks} blocks an SM")
    for args in ((64, 8, 4, 8, 4), (16, 8, 4, 5, 5), (128, 32, 16, 8, 1)):
        if k4._lib().eva_1d_smem_bytes(*args) != k4.smem_bytes(*args):
            raise AssertionError(f"eva_1d gate's smem layout != kernel's {args}")
    # the f32 route's layout and gate, (d, ws, ext, C, query rows an item):
    # the recipe's plan, the long shape's, head dims 16 and 128, a
    # straddling window, and item sizes the route refuses
    for args in ((64, 8, 4, 8, 32), (64, 8, 4, 8, 64), (16, 8, 4, 5, 48),
                 (128, 16, 8, 8, 64), (32, 24, 5, 9, 32), (128, 16, 8, 8, 128),
                 (64, 8, 4, 8, 40), (64, 8, 4, 8, 144), (48, 8, 4, 8, 32)):
        want = k4.tf32_smem_bytes(*args) if k4.tf32_config_ok(*args) else -1
        if k4._lib().eva_1d_tf32_smem_bytes(*args) != want:
            raise AssertionError(f"eva_1d f32 route's layout {args}: kernel "
                                 f"{k4._lib().eva_1d_tf32_smem_bytes(*args)}, wrapper {want}")
    k4_plans = {label: k4.plan(B, N, ws, ext, C, nh, d, 4)
                for label, (B, N, nh, d, ws, ext, C, _) in K4_CHECKS}
    k4_ptxas = mma_kernel_report(_build.BUILD_DIR / f"{k4.NAME}.log", "eva_1d_tf32x3_kernel")
    log(f"[build] eva_1d f32 route, ptxas: {json.dumps(k4_ptxas)}; plans "
        f"{json.dumps({k: v._asdict() for k, v in k4_plans.items()})}")
    if any("0 bytes spill stores" not in v for v in k4_ptxas.values()):
        raise AssertionError(f"eva_1d f32 route spills: {k4_ptxas}")
    for fn, py, args in (
            (k8._lib().eva_summaries_smem_bytes, k8.smem_bytes, (112, 64, 2, 0)),
            (k8._lib().eva_summaries_smem_bytes, k8.smem_bytes, (28, 12, 4, 0)),
            (k10._lib().eva_mega_summaries_smem_bytes, k8.smem_bytes, (112, 64, 2, 192)),
            (k10._lib().eva_mega_summaries_smem_bytes, k8.smem_bytes, (28, 12, 4, 48)),
            (k1._lib_out().eva_packed_out_smem_bytes, k1.smem_bytes_out,
             (64, 49, 49, 3, 2, 0)),
            (k1._lib_out().eva_packed_out_smem_bytes, k1.smem_bytes_out,
             (12, 49, 49, 4, 4, 0)),
            (k10._lib().eva_mega_attention_smem_bytes, k1.smem_bytes_out,
             (64, 49, 49, 3, 4, 192)),
            (k10._lib().eva_mega_attention_smem_bytes, k1.smem_bytes_out,
             (12, 49, 49, 4, 2, 48))):
        if fn(*args) != py(*args):
            raise AssertionError(f"{py.__name__}{args} {py(*args)} != the "
                                 f"kernel's {fn(*args)}")
    # K8 and K10a's persistent route: its layout against the kernel's, at
    # the SUM_CHECKS geometries it takes the layout mma_plan picks there;
    # registers and spills; its blocks an SM (the occupancy calculator) at
    # least the plan's
    sum_plans = {}
    for label, (B, g, j, nh, d), _, _ in SUM_CHECKS:
        for name, fn, fn_bps, xdim in (
                ("K8", k8._lib().eva_summaries_mma_smem_bytes,
                 k8._lib().eva_summaries_mma_blocks_per_sm, 0),
                ("K10a", k10._lib().eva_mega_summaries_mma_smem_bytes,
                 k10._lib().eva_mega_summaries_mma_blocks_per_sm, nh * d)):
            cfg = k8.mma_plan(B, nh, g, g, j, d, 2, xdim=xdim)
            if cfg is None:
                continue
            args = (j * g, d, xdim, g // j, j * j, cfg.stages, cfg.teams)
            fits = fn_bps(d, cfg.warps, cfg.teams, cfg.smem)
            if not fn(*args) == k8.mma_smem_bytes(*args) == cfg.smem or fits < cfg.bps:
                raise AssertionError(f"{name} {label}: layout {args} {fn(*args)} vs the "
                                     f"wrapper's {k8.mma_smem_bytes(*args)}, {fits} blocks "
                                     f"an SM for the plan's {cfg}")
            sum_plans[f"{name} {label}"] = list(cfg) + [fits]
    sum_ptxas = {
        f"{name} {tag}": mma_kernel_report(
            _build.BUILD_DIR / f"{name}.log", tag,
            names=lambda d, bools, ints: f"D={d} {ints[0]} warps" if ints else f"D={d}")
        for name, tag in ((k8.NAME, "eva_summaries_mma_kernel"),
                          (k10.NAME, "eva_summaries_mma_kernel"),
                          (k10.NAME, "eva_summaries_ws_kernel"))}
    log(f"[build] eva_summaries_mma_kernel (K8 and K10a's persistent route), ptxas: "
        f"{json.dumps(sum_ptxas)}; plans at SUM_CHECKS (warps, stages, blocks an SM, "
        f"teams, bytes a block, blocks an SM that fit): {json.dumps(sum_plans)}")
    if any("0 bytes spill stores" not in v for r in sum_ptxas.values() for v in r.values()):
        raise AssertionError(f"the persistent summaries kernels spill: {sum_ptxas}")
    # K9 and K10's attention on their tensor-core route: the layouts
    # out_mma_plan picks at the geometries it serves (the headline, PVT-B3's
    # three stages, two-pass strips, the odd one, the small and base EVA
    # ViTs), registers and spills for head dims 64, 32 and 16, blocks an SM
    # (one of 12 warps)
    for d, S, C, nh in ((64, 49, 49, 3), (32, 49, 49, 2), (32, 49, 49, 4),
                        (32, 49, 49, 10), (16, 49, 196, 2), (16, 16, 4, 3),
                        (64, 49, 49, 6), (64, 49, 49, 12)):
        for fn, xdim in ((k1._lib_out().eva_packed_out_smem_bytes, 0),
                         (k10._lib().eva_mega_attention_smem_bytes, nh * d)):
            if fn(d, S, C, nh, 2, xdim) != k1.smem_bytes_out(d, S, C, nh, 2, xdim):
                raise AssertionError(f"smem_bytes_out{(d, S, C, nh, 2, xdim)} "
                                     f"{k1.smem_bytes_out(d, S, C, nh, 2, xdim)} != the "
                                     f"kernel's {fn(d, S, C, nh, 2, xdim)}")
    out_ptxas = {name: mma_kernel_report(_build.BUILD_DIR / f"{name}.log",
                                         "eva_out_mma_kernel", split_last=True)
                 for name in (k1.NAME_OUT, k10.NAME)}
    out_blocks = {
        f"{name} d{d}": fn(d, 49, C, nh, *xd)
        for d, C, nh in ((64, 49, 3), (32, 49, 2), (16, 196, 2))
        for name, fn, xd in (("K9", k1._lib_out().eva_packed_out_mma_blocks_per_sm, ()),
                             ("K10b", k10._lib().eva_mega_attention_mma_blocks_per_sm,
                              (nh * d,)))}
    out_plans = {f"{name} xdim {xdim}": k1.out_mma_plan(64, 49, 49, 3, xdim)
                 for name, xdim in (("K9", 0), ("K10b", 192))}
    log(f"[build] eva_out_mma_kernel (K9 and K10's attention), ptxas: "
        f"{json.dumps(out_ptxas)}; blocks an SM (occupancy calculator): "
        f"{json.dumps(out_blocks)}; plan at the headline (heads staged at once, "
        f"Wo whole, split, slab rows, bytes a block): {json.dumps(out_plans)}")
    if min(out_blocks.values()) < 1:
        raise AssertionError(f"eva_out_mma_kernel: {out_blocks} blocks an SM")
    # its one-pass strips at head dim 64 (and 32) spill a few registers at
    # the 168 that 384 threads leave (16-32 bytes, PERF.md §6, where the
    # two-pass strips that do not spill are timed against them): more than
    # 64 bytes is a regression
    out_spills = [int(m) for report in out_ptxas.values() for v in report.values()
                  for m in re.findall(r"(\d+) bytes spill stores", v)]
    if len(out_spills) != 24 or max(out_spills) > 64:
        raise AssertionError(f"eva_out_mma_kernel spills: {out_ptxas}")
    for d, S, C, itemsize in ((64, 49, 49, 2), (64, 49, 49, 4), (32, 49, 49, 2),
                              (48, 49, 49, 2), (48, 49, 196, 2), (64, 64, 64, 2),
                              (128, 49, 49, 2), (16, 8, 5, 4), (16, 8, 5, 2),
                              (24, 16, 6, 2)):
        want = k11.smem_bytes(d, S, C, itemsize)
        for fn in (k11._lib().eva_kernel_smem_bytes,
                   k12._lib().eva_rowmajor_smem_bytes):
            if fn(d, S, C, int(itemsize == 2)) != want:
                raise AssertionError(f"eva_kernel smem_bytes{(d, S, C, itemsize)} "
                                     f"{want} != the kernel's {fn(d, S, C, itemsize == 2)}")
    # K11 and K12's tensor-core route: its gate against the kernels', its
    # registers and spills (none allowed) and blocks an SM (at least 3 at
    # head dims 64 and 32)
    for k, prefix in ((k11, "eva_kernel"), (k12, "eva_rowmajor")):
        lib = k._lib()
        for d in k11.HEAD_DIMS:
            for itemsize in (2, 4):
                if (bool(getattr(lib, f"{prefix}_uses_mma")(d, itemsize))
                        != k11.uses_mma(d, itemsize)):
                    raise AssertionError(f"{prefix} uses_mma({d}, {itemsize}): the "
                                         f"kernel's and the wrapper's differ")
        win_ptxas = mma_kernel_report(_build.BUILD_DIR / f"{k.NAME}.log",
                                      "window_mma_kernel")
        win_blocks = {f"d{d}": getattr(lib, f"{prefix}_mma_blocks_per_sm")(d, 49, 49)
                      for d in (64, 48, 32, 16)}
        log(f"[build] {prefix} tensor-core route, ptxas: {json.dumps(win_ptxas)}; "
            f"blocks an SM at 49 + 49 keys (occupancy calculator): "
            f"{json.dumps(win_blocks)}; {k11.smem_bytes(64, 49, 49, 2)} bytes of "
            f"shared memory a block at head dim 64")
        if any("0 bytes spill stores" not in v for v in win_ptxas.values()):
            raise AssertionError(f"{prefix} tensor-core route spills: {win_ptxas}")
        if min(win_blocks["d64"], win_blocks["d32"]) < 3:
            raise AssertionError(f"{prefix} tensor-core route: {win_blocks} blocks an SM")

    # ---- 2. kernels against their plain versions
    errors = {}
    for label, geo, dtype_name in CHECKS:
        dtype = getattr(torch, dtype_name)
        args, bias = k2_inputs(*geo, dtype, seed=len(errors))
        before = k2.LAUNCHES_MMA
        out = k2.eva_attention_single(*args, bias=bias)
        torch.cuda.synchronize()
        if k2.LAUNCHES_MMA - before != int(k2.uses_mma(geo[-1], out.element_size())):
            raise AssertionError(f"eva_single {label}: {k2.LAUNCHES_MMA - before} "
                                 f"tensor-core launches")
        ref = k2.eva_attention_single_ref(*args, bias=bias)
        if out.shape != ref.shape or out.dtype != ref.dtype:
            raise AssertionError(f"{label}: {out.shape} {out.dtype} vs "
                                 f"{ref.shape} {ref.dtype}")
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        tol = TOL[str(dtype)]
        log(f"[k2 vs plain] {label}: max abs err {err:.3e} (tol {tol:.1e}), "
            f"max rel err {rel:.3e}")
        if not err <= tol:
            raise AssertionError(f"eva_single {label}: max abs err {err} > {tol}")
        errors[label] = err
    # K2's tensor-core route in bf16 at K2_CHECKS, and the CUDA-core kernel
    # forced on the same inputs; then both types at large-norm keys (keys
    # x40, zero queries), where only a chunk softmax at its true maximum
    # stays finite
    k2_errors = {}
    tol = TOL["torch.bfloat16"]
    for label, geo, with_bias, use_ln in K2_CHECKS:
        args, bias = k2_inputs(*geo, torch.bfloat16, seed=30 + len(k2_errors),
                               use_ln=use_ln)
        bias = bias if with_bias else None
        before = k2.LAUNCHES_MMA
        out = k2.eva_attention_single(*args, bias=bias)
        old = k2.eva_attention_single(*args, bias=bias, cuda_cores=True)
        torch.cuda.synchronize()
        ref = k2.eva_attention_single_ref(*args, bias=bias)
        err = (out.float() - ref.float()).abs().max().item()
        old_err = (old.float() - ref.float()).abs().max().item()
        mean_err = (out.float() - ref.float()).abs().mean().item()
        log(f"[k2 vs plain] {label} bf16 {geo} bias {with_bias} ln {use_ln}: tensor-core "
            f"route (cluster {k2.plan(geo[0], geo[4], geo[1], geo[1], geo[2], geo[3], geo[5], 2)[0]})"
            f" max abs err {err:.3e}, mean {mean_err:.3e}; CUDA-core kernel {old_err:.3e} "
            f"(tol {tol:.1e})")
        if k2.LAUNCHES_MMA - before != 1:
            raise AssertionError(f"eva_single {label}: not on the tensor-core route")
        if not (err <= tol and old_err <= tol):
            raise AssertionError(f"eva_single {label}: max abs err {err}, {old_err} > {tol}")
        k2_errors[label] = err
    for dtype_name in ("bfloat16", "float32"):
        B, g, ws, j, nh, d = LARGE_KEYS
        args, bias = k2_inputs(B, g, ws, j, nh, d, torch.float32, seed=98)
        qkv = args[0]
        qkv[..., :nh * d] = 0.0
        qkv[..., nh * d:2 * nh * d] *= 40.0
        args = (qkv.to(getattr(torch, dtype_name)), *args[1:])
        before = k2.LAUNCHES_MMA
        out = k2.eva_attention_single(*args, bias=bias)
        torch.cuda.synchronize()
        ref = k2.eva_attention_single_ref(*args, bias=bias)
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[f"torch.{dtype_name}"]
        log(f"[k2 vs plain] large-norm keys {dtype_name}: max abs err {err:.3e} (tol "
            f"{tol:.1e}), max |value| {ref.float().abs().max().item():.3e}, tensor-core "
            f"launches {k2.LAUNCHES_MMA - before}")
        if not (torch.isfinite(out.float()).all() and err <= tol):
            raise AssertionError(f"eva_single at large-norm keys {dtype_name}: err {err}")
        if k2.LAUNCHES_MMA - before != int(dtype_name == "bfloat16"):
            raise AssertionError(f"eva_single at large-norm keys {dtype_name}: wrong route")
        k2_errors[f"large keys {dtype_name}"] = err
    k1_errors = {}
    for label, (B, g, ws, j, nh, d), dtype_name, with_bias in K1_CHECKS:
        dtype = getattr(torch, dtype_name)
        qkv, rf, beta, bias, grad = k1_inputs(B, g, ws, j, nh, d, dtype,
                                              seed=10 + len(k1_errors))
        bias = bias if with_bias else None
        scale = d ** -0.5
        mma_before = (k1.LAUNCHES_FWD_MMA, k1.LAUNCHES_BWD_MMA)
        got = [k1._forward(qkv, rf, beta, bias, scale, nh, g, ws),
               *k1._backward(qkv, rf, beta, bias, grad, scale, nh, g, ws)]
        torch.cuda.synchronize()
        mma = k1.fwd_uses_mma(d, qkv.element_size())
        if mma != k1.bwd_uses_mma(d, qkv.element_size()):
            raise AssertionError(f"eva_packed {label}: the gates differ")
        if (k1.LAUNCHES_FWD_MMA - mma_before[0],
                k1.LAUNCHES_BWD_MMA - mma_before[1]) != (int(mma), int(mma)):
            raise AssertionError(f"eva_packed {label}: the forward or the backward "
                                 f"did not take the {'tensor' if mma else 'CUDA'}-core "
                                 f"route")
        want = [k1.eva_packed_fwd_ref(qkv, rf, beta, scale, nh, g, ws, bias),
                *k1.eva_packed_bwd_ref(qkv, rf, beta, bias, grad, scale, nh,
                                       g, ws)]
        if label == "main bf16":  # the CUDA-core routes, timed beside them
            label_cc = "main bf16 cuda-core"
            before_cc = (k1.LAUNCHES_FWD_MMA, k1.LAUNCHES_BWD_MMA)
            got_cc = [k1._forward(qkv, rf, beta, bias, scale, nh, g, ws,
                                  cuda_cores=True),
                      *k1._backward(qkv, rf, beta, bias, grad, scale, nh, g, ws,
                                    cuda_cores=True)]
            torch.cuda.synchronize()
            if (k1.LAUNCHES_FWD_MMA, k1.LAUNCHES_BWD_MMA) != before_cc:
                raise AssertionError("eva_packed cuda_cores=True took a tensor-core "
                                     "route")
            for name, a, b in zip(("out", "dqkv", "drf", "dbeta", "dbias"), got_cc,
                                  want):
                err = (a.float() - b.float()).abs().max().item()
                tol = K1_TOL[str(b.dtype)] * max(1.0, b.float().abs().max().item())
                log(f"[k1 vs plain] {label_cc} {name}: max abs err {err:.3e} "
                    f"(tol {tol:.1e})")
                if not err <= tol:
                    raise AssertionError(f"eva_packed {label_cc} {name}: max abs "
                                         f"err {err} > {tol}")
            del got_cc
        log(f"[k1 vs plain] {label}: forward and backward on the "
            f"{'tensor' if mma else 'CUDA'}-core routes")
        for name, a, b in zip(("out", "dqkv", "drf", "dbeta", "dbias"),
                              got, want):
            if b is None and not with_bias:
                if a is not None:
                    raise AssertionError(f"eva_packed {label}: dbias without a bias")
                continue
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"eva_packed {label} {name}: {a.shape} "
                                     f"{a.dtype} vs {b.shape} {b.dtype}")
            err = (a.float() - b.float()).abs().max().item()
            peak = b.float().abs().max().item()
            tol = K1_TOL[str(b.dtype)] * max(1.0, peak)
            log(f"[k1 vs plain] {label} {name}: max abs err {err:.3e} "
                f"(tol {tol:.1e}), max |value| {peak:.3e}")
            if not err <= tol:
                raise AssertionError(f"eva_packed {label} {name}: max abs err "
                                     f"{err} > {tol}")
            k1_errors[(label, name)] = err
    k3_errors = {}
    for i, (label, (B, T, nh, d, w, cs), dtype_name) in enumerate(K3_CHECKS):
        ops, grad = k3_inputs(B, T, nh, d, w, cs, getattr(torch, dtype_name),
                              seed=30 + 7 * i)
        scale = d ** -0.5
        # f32 takes the forward's and the backward's split-TF32 routes,
        # bf16 the CUDA-core kernels; f32 is also held on the CUDA-core
        # kernels, forced
        tf32_before = (k3.LAUNCHES_FWD_TF32, k3.LAUNCHES_BWD_TF32)
        got = [k3._forward(*ops, scale, nh, w, cs),
               *k3._backward(*ops, grad, scale, nh, w, cs)]
        f32 = ops[0].dtype == torch.float32
        for part, before, after in zip(("forward", "backward"), tf32_before,
                                       (k3.LAUNCHES_FWD_TF32, k3.LAUNCHES_BWD_TF32)):
            if after - before != int(f32):
                raise AssertionError(f"causal_packed {label}: the {part} took the "
                                     f"{'CUDA-core' if f32 else 'split-TF32'} route")
        names = ["out", "dq", "dk", "dv", "drf", "dbeta", "dbias"]
        grad_names = names[1:]
        if f32:
            got.append(k3._forward(*ops, scale, nh, w, cs, cuda_cores=True))
            got += k3._backward(*ops, grad, scale, nh, w, cs, cuda_cores=True)
            names += ["out (CUDA cores)"] + [f"{n} (CUDA cores)" for n in grad_names]
            if (k3.LAUNCHES_FWD_TF32, k3.LAUNCHES_BWD_TF32) != tuple(b + 1 for b in tf32_before):
                raise AssertionError(f"causal_packed {label}: a forced CUDA-core call "
                                     "took the split-TF32 route")
        torch.cuda.synchronize()
        want = [k3.causal_packed_fwd_ref(*ops, scale, nh, w, cs),
                *k3.causal_packed_bwd_ref(*ops, grad, scale, nh, w, cs)]
        want += want * f32
        for name, a, b in zip(names, got, want):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"causal_packed {label} {name}: {a.shape} "
                                     f"{a.dtype} vs {b.shape} {b.dtype}")
            err = (a.float() - b.float()).abs().max().item()
            peak = b.float().abs().max().item()
            # as eva_packed's: f32 to summation (and atomics) order and the
            # split-TF32 products' dropped terms, bf16 to one rounding;
            # dbias stays f32 in both
            tol = K1_TOL[str(ops[0].dtype)] * max(1.0, peak)
            log(f"[k3 vs plain] {label} {name}: max abs err {err:.3e} "
                f"(tol {tol:.1e}), max |value| {peak:.3e}")
            if not err <= tol:
                raise AssertionError(f"causal_packed {label} {name}: max abs "
                                     f"err {err} > {tol}")
            k3_errors[(label, name)] = err
        del ops, grad, got, want
    lin_errors = {}
    for label, (B, g, nh, d, C, m, ws), dtype_name in LIN_CHECKS:
        a = lin_inputs(B, g, nh, d, C, m, ws, getattr(torch, dtype_name),
                       seed=50 + len(lin_errors))
        for name, (kernel, plain) in lin_calls(k5, k6, k7, a, nh, g, ws).items():
            out = kernel()
            torch.cuda.synchronize()
            ref = plain()
            if out.shape != ref.shape or out.dtype != ref.dtype:
                raise AssertionError(f"{name} {label}: {out.shape} {out.dtype} vs "
                                     f"{ref.shape} {ref.dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            peak = ref.float().abs().max().item()
            # as eva_packed's: f32 to summation order, bf16 to one rounding
            tol = K1_TOL[f"torch.{dtype_name}"] * max(1.0, peak)
            log(f"[{name} vs plain] {label}: max abs err {err:.3e} (tol "
                f"{tol:.1e}), max |value| {peak:.3e}")
            if not err <= tol:
                raise AssertionError(f"{name} {label}: max abs err {err} > {tol}")
            lin_errors[(name, label)] = err
        del a
    # K5's bf16 routes at their own geometries, each launch counted on its
    # route, within one bf16 spacing of the output's largest value
    k5_errors = {}
    for label, (B, N, nh, d, C), key_scale, want_route in K5_CHECKS:
        a = k5_inputs(B, N, nh, d, C, key_scale, seed=70 + len(k5_errors))
        route = k5.plan(B, N, nh, d, C, 2)
        if route[2] != want_route:
            raise AssertionError(f"lara_fused {label}: plan {route}, not {want_route}")
        before = (k5.LAUNCHES, k5.LAUNCHES_MMA)
        out = k5.lara_attention_fused(a[0], *a[1:], d ** -0.5, nh, 2.0)
        torch.cuda.synchronize()
        counts = (k5.LAUNCHES - before[0], k5.LAUNCHES_MMA - before[1])
        if counts != (1, int(want_route == "cluster")):
            raise AssertionError(f"lara_fused {label}: {counts[0]} launches, "
                                 f"{counts[1]} on the cluster route")
        ref = k5.lara_fused_ref(a[0], *a[1:], d ** -0.5, nh, 2.0)
        if out.shape != ref.shape or out.dtype != ref.dtype:
            raise AssertionError(f"lara_fused {label}: {out.shape} {out.dtype} vs "
                                 f"{ref.shape} {ref.dtype}")
        err = (out.float() - ref.float()).abs().max().item()
        peak = ref.float().abs().max().item()
        tol = K1_TOL["torch.bfloat16"] * peak
        log(f"[lara_fused vs plain] {label} ({route[2]} route, ranks {route[0]}, "
            f"{route[1]} bytes a block): max abs err {err:.3e} (tol {tol:.1e}), mean abs "
            f"err {(out.float() - ref.float()).abs().mean().item():.3e}, max |value| "
            f"{peak:.3e}")
        if not err <= tol or not torch.isfinite(out.float()).all():
            raise AssertionError(f"lara_fused {label}: max abs err {err} > {tol}")
        k5_errors[label] = err
        del a, out, ref
    # K6 at its own geometries: one launch each on the route plan names,
    # within one bf16 rounding of the output's largest value
    k6_errors = {}
    for label, (B, N, nh, d, m), key_scale, want_route in K6_CHECKS:
        qkv, proj = k6_inputs(B, N, nh, d, m, key_scale, seed=110 + len(k6_errors))
        route = k6_route(k6, B, N, nh, d, m)
        if route != want_route:
            raise AssertionError(f"performer_fused {label}: route {route}, not {want_route}")
        before = (k6.LAUNCHES, k6.LAUNCHES_RING)
        out = k6.performer_attention_fused(qkv, proj, nh)
        torch.cuda.synchronize()
        counts = (k6.LAUNCHES - before[0], k6.LAUNCHES_RING - before[1])
        if counts != (1, int(route == "ring")):
            raise AssertionError(f"performer_fused {label}: {counts[0]} launches, "
                                 f"{counts[1]} on the ring route")
        ref = k6.performer_fused_ref(qkv, proj, nh)
        if out.shape != ref.shape or out.dtype != ref.dtype:
            raise AssertionError(f"performer_fused {label}: {out.shape} {out.dtype} vs "
                                 f"{ref.shape} {ref.dtype}")
        err = (out.float() - ref.float()).abs().max().item()
        peak = ref.float().abs().max().item()
        tol = K1_TOL["torch.bfloat16"] * peak
        ring = k6.plan(B, N, nh, d, m, 2)
        log(f"[performer_fused vs plain] {label} ({route} route"
            f"{', layout ' + str(tuple(ring[:4])) if ring else ''}): max abs err {err:.3e} "
            f"(tol {tol:.1e}), mean abs err "
            f"{(out.float() - ref.float()).abs().mean().item():.3e}, max |value| {peak:.3e}")
        if not err <= tol or not torch.isfinite(out.float()).all():
            raise AssertionError(f"performer_fused {label}: max abs err {err} > {tol}")
        k6_errors[label] = err
        del qkv, proj, out, ref
    # K7 at its own geometries: with and without the bias, the route
    # counted (bf16 at head dims 16, 32, 64 on tensor cores, f32 and head
    # dim 12 off them)
    for label, (B, g, nh, d, ws), dtype_name in K7_CHECKS:
        a = lin_inputs(B, g, nh, d, 4, 16, ws, getattr(torch, dtype_name),
                       seed=90 + len(lin_errors))
        on_route = k7.uses_mma(d, a["qkv"].element_size())
        for bias in (a["bias"], None):
            tag = f"{label} {'bias' if bias is not None else 'no bias'}"
            before = (k7.LAUNCHES, k7.LAUNCHES_MMA)
            out = k7.local_attention_packed(a["qkv"], d ** -0.5, nh, g, ws, bias=bias)
            torch.cuda.synchronize()
            if (k7.LAUNCHES, k7.LAUNCHES_MMA) != (before[0] + 1, before[1] + on_route):
                raise AssertionError(f"local_packed {tag}: launched "
                                     f"{k7.LAUNCHES - before[0]} times, "
                                     f"{k7.LAUNCHES_MMA - before[1]} on the tensor-core "
                                     f"route (want {int(on_route)})")
            ref = k7.local_packed_ref(a["qkv"], d ** -0.5, nh, g, ws, bias)
            if out.shape != ref.shape or out.dtype != ref.dtype:
                raise AssertionError(f"local_packed {tag}: {out.shape} {out.dtype} vs "
                                     f"{ref.shape} {ref.dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            peak = ref.float().abs().max().item()
            tol = K1_TOL[f"torch.{dtype_name}"] * max(1.0, peak)
            log(f"[local_packed vs plain] {tag} "
                f"({'tensor cores' if on_route else 'CUDA cores'}): max abs err "
                f"{err:.3e} (tol {tol:.1e}), mean abs err "
                f"{(out.float() - ref.float()).abs().mean().item():.3e}, max |value| "
                f"{peak:.3e}")
            if not err <= tol:
                raise AssertionError(f"local_packed {tag}: max abs err {err} > {tol}")
            lin_errors[(k7.NAME, tag)] = err
        del a

    # f32 on the split-TF32 route and on the CUDA-core kernel it replaced
    # (config=0), bf16 on the CUDA-core kernel; each launch asserted on its
    # route
    k4_errors = {}
    for i, (label, (B, N, nh, d, ws, ext, C, bias_kind)) in enumerate(K4_CHECKS):
        for j, (dtype_name, route, config) in enumerate((
                ("float32", "f32 route", None), ("float32", "CUDA cores", 0),
                ("bfloat16", "CUDA cores", None))):
            qkv, rf, beta, mask, bias = k4_inputs(
                B, N, nh, d, ws, ext, C, bias_kind, getattr(torch, dtype_name),
                seed=70 + 2 * i + (j == 2))
            before = k4.LAUNCHES_TF32
            with torch.no_grad():
                out = k4.eva_attention_1d(qkv, rf, beta, mask, d ** -0.5, nh, ws,
                                          ext, bias=bias, config=config)
                torch.cuda.synchronize()
                ref = k4.eva_1d_ref(qkv, rf, beta, mask, d ** -0.5, nh, ws, ext, bias)
            if (k4.LAUNCHES_TF32 - before == 1) != (route == "f32 route"):
                raise AssertionError(f"eva_1d {label} {dtype_name} did not take the "
                                     f"{route}")
            if out.shape != ref.shape or out.dtype != ref.dtype:
                raise AssertionError(f"eva_1d {label}: {out.shape} {out.dtype} vs "
                                     f"{ref.shape} {ref.dtype}")
            keep = ~mask  # query rows that are not padding
            err = (out.float() - ref.float())[keep].abs().max().item()
            peak = ref.float()[keep].abs().max().item()
            tol = K4_TOL[f"torch.{dtype_name}"] * max(1.0, peak)
            log(f"[eva_1d vs plain] {label} {dtype_name} ({route}): max abs err "
                f"{err:.3e} (tol {tol:.1e}) at {int(keep.sum())} non-pad rows, max "
                f"|value| {peak:.3e}")
            if not err <= tol:
                raise AssertionError(f"eva_1d {label} {dtype_name} ({route}): max abs "
                                     f"err {err} > {tol}")
            k4_errors[(label, dtype_name, route)] = err

    # K8, K9 and K10's two entry points at the three shapes, in K1's terms
    eval_errors = {}
    for label, (B, g, ws, j, nh, d), dtype_name in CHECKS:
        a = eval_inputs(B, g, ws, j, nh, d, getattr(torch, dtype_name),
                        seed=90 + len(eval_errors))
        for name, (kernel, plain) in eval_calls(k8, k1, k10, a, nh, g, ws,
                                                j).items():
            with torch.no_grad():
                out = kernel()
                torch.cuda.synchronize()
                ref = plain()
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            for o, r in zip(outs, refs):
                if o.shape != r.shape or o.dtype != r.dtype:
                    raise AssertionError(f"{name} {label}: {o.shape} {o.dtype} vs "
                                         f"{r.shape} {r.dtype}")
            err = max((o.float() - r.float()).abs().max().item()
                      for o, r in zip(outs, refs))
            peak = max(r.float().abs().max().item() for r in refs)
            tol = K1_TOL[f"torch.{dtype_name}"] * max(1.0, peak)
            log(f"[{name} vs plain] {label}: max abs err {err:.3e} (tol "
                f"{tol:.1e}), max |value| {peak:.3e}")
            if not err <= tol:
                raise AssertionError(f"{name} {label}: max abs err {err} > {tol}")
            eval_errors[(name, label)] = err
        del a
    # K9 and K10's attention on their tensor-core route at OUT_CHECKS, with
    # the bias and without, in K1's terms, one launch each on the route
    out_errors = {}
    for label, (B, g, ws, j, nh, d) in OUT_CHECKS:
        a = eval_inputs(B, g, ws, j, nh, d, torch.bfloat16, seed=120 + len(out_errors))
        for with_bias in (True, False):
            calls = eval_calls(k8, k1, k10, a if with_bias else dict(a, bias=None),
                               nh, g, ws, j)
            for name in (k1.NAME_OUT, k10.NAME_ATTENTION):
                kernel, plain = calls[name]
                before = k1.LAUNCHES_OUT_MMA + k10.LAUNCHES_ATTENTION_MMA
                with torch.no_grad():
                    out = kernel()
                    torch.cuda.synchronize()
                    ref = plain()
                mma = k1.LAUNCHES_OUT_MMA + k10.LAUNCHES_ATTENTION_MMA - before
                err = (out.float() - ref.float()).abs().max().item()
                tol = K1_TOL["torch.bfloat16"] * max(1.0, ref.float().abs().max().item())
                log(f"[{name} tensor-core route vs plain] {label} "
                    f"{'bias' if with_bias else 'no bias'}: max abs err {err:.3e} "
                    f"(tol {tol:.1e}), launches on the route {mma}")
                if not (out.shape == ref.shape and err <= tol and mma == 1):
                    raise AssertionError(f"{name} tensor-core route {label} bias="
                                         f"{with_bias}: err {err} > {tol} or {mma} "
                                         f"launches on the route")
                out_errors[(name, label, with_bias)] = err
        del a
    # K8 where the TPU kernel's bound-shifted chunk softmax underflows: keys
    # x40 and zero queries; the true-max shift stays finite
    for dtype_name in ("float32", "bfloat16"):
        B, g, ws, j, nh, d = LARGE_KEYS
        a = eval_inputs(B, g, ws, j, nh, d, torch.float32, seed=99)
        qkv = a["qkv"]
        qkv[..., :nh * d] = 0.0
        qkv[..., nh * d:2 * nh * d] *= 40.0
        qkv = qkv.to(getattr(torch, dtype_name))
        out = k8.eva_summaries_packed(qkv, *a["adaptive"], nh, g, j, True)
        torch.cuda.synchronize()
        ref = k8.eva_summaries_packed_ref(qkv, *a["adaptive"], nh, g, j, True)
        err = max((o.float() - r.float()).abs().max().item()
                  for o, r in zip(out, ref))
        peak = max(r.float().abs().max().item() for r in ref)
        tol = K1_TOL[f"torch.{dtype_name}"] * max(1.0, peak)
        log(f"[eva_summaries vs plain] large-norm keys {dtype_name}: max abs err "
            f"{err:.3e} (tol {tol:.1e}), max |value| {peak:.3e}")
        if not (all(torch.isfinite(o.float()).all() for o in out) and err <= tol):
            raise AssertionError(f"eva_summaries at large-norm keys: err {err}")
    # K8 and K10a at SUM_CHECKS in bf16: one launch each, on the persistent
    # route exactly where mma_plan takes the geometry, each output within
    # SUM_TOL of its peak; large-norm keys: q zeroed and k x40 in qkv, and
    # in Wqkv's and bqkv's columns for K10a
    sum_errors = {}
    for label, (B, g, j, nh, d), use_ln, large in SUM_CHECKS:
        a = eval_inputs(B, g, 7, j, nh, d, torch.bfloat16, seed=140 + len(sum_errors))
        hd = nh * d
        if large:
            qkv = a["qkv"].float()
            qkv[..., :hd] = 0.0
            qkv[..., hd:2 * hd] *= 40.0
            a["qkv"] = qkv.to(torch.bfloat16)
            for w in (a["wqkv"].T, a["bqkv"]):
                w[:hd] = 0.0
                w[hd:2 * hd] *= 40.0
        summ = (*a["adaptive"][:4], *(a["adaptive"][4:] if use_ln else [None] * 4), nh,
                g, j, use_ln)
        tok = (a["x"], a["wqkv"], a["bqkv"])
        calls = {
            k8.NAME: (lambda: k8.eva_summaries_packed(a["qkv"], *summ),
                      lambda: k8.eva_summaries_packed_ref(a["qkv"], *summ),
                      lambda: k8.LAUNCHES_MMA, 0),
            k10.NAME_SUMMARIES: (lambda: k10.eva_summaries_from_x(*tok, *summ),
                                 lambda: k10.eva_summaries_from_x_ref(*tok, *summ),
                                 lambda: k10.LAUNCHES_SUMMARIES_MMA, hd)}
        for name, (kernel, plain, on_route, xdim) in calls.items():
            route = k8.mma_plan(B, nh, g, g, j, d, 2, xdim=xdim)
            before = on_route()
            with torch.no_grad():
                out = kernel()
                torch.cuda.synchronize()
                ref = plain()
            launched_route = on_route() - before
            errs = [(o.float() - r.float()).abs().max().item() for o, r in zip(out, ref)]
            peaks = [r.float().abs().max().item() for r in ref]
            finite = all(bool(torch.isfinite(o.float()).all()) for o in out)
            log(f"[{name} vs plain] {label}: route "
                f"{'persistent ' + str(tuple(route[:4])) if route else 'first kernel'}, "
                f"launches on the persistent route {launched_route}; rf_k, beta max abs err "
                f"{errs[0]:.3e}, {errs[1]:.3e} against peaks {peaks[0]:.3e}, {peaks[1]:.3e} "
                f"(tol {SUM_TOL:.4g} of the peak)")
            if not (finite and launched_route == int(route is not None)
                    and all(e <= SUM_TOL * pk for e, pk in zip(errs, peaks))):
                raise AssertionError(f"{name} {label}: errors {errs}, peaks {peaks}, "
                                     f"{launched_route} launches on the route, want "
                                     f"{int(route is not None)}")
            sum_errors[(name, label)] = max(e / pk for e, pk in zip(errs, peaks))
        del a

    # K11 on the windows and K12 on the same q, k, v in token order, in K1's
    # terms; K11 also in 1-D (5 windows of 8, 5 chunks)
    win_errors = {}
    for label, (B, H, gh, gw, ws, C, d), dtype_name, with_bias in WIN_CHECKS:
        a = win_inputs(B, H, gh, gw, ws, C, d, getattr(torch, dtype_name),
                       seed=100 + len(win_errors), with_bias=with_bias)
        merged = lambda t: windows.window_2d_merge(  # noqa: E731
            t, ws, (gh, gw)).reshape(B, H, gh * gw, d)
        for name, (kernel, plain) in win_calls(k11, k12, a, gw, ws).items():
            with torch.no_grad():
                out = kernel()
                torch.cuda.synchronize()
                ref = plain()
            if out.shape != ref.shape or out.dtype != ref.dtype:
                raise AssertionError(f"{name} {label}: {out.shape} {out.dtype} vs "
                                     f"{ref.shape} {ref.dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            peak = ref.float().abs().max().item()
            tol = K1_TOL[f"torch.{dtype_name}"] * max(1.0, peak)
            log(f"[{name} vs plain] {label}: max abs err {err:.3e} (tol "
                f"{tol:.1e}), max |value| {peak:.3e}")
            if not err <= tol:
                raise AssertionError(f"{name} {label}: max abs err {err} > {tol}")
            win_errors[(name, label)] = err
            # K11 and K12 run the same device code on the same rows: K11's
            # output merged to token order equals K12's bit for bit
            if name == k11.NAME:
                k11_out = merged(out)
            elif not torch.equal(k11_out, out):
                raise AssertionError(
                    f"eva_rowmajor {label} differs from eva_kernel's merged output "
                    f"by {(k11_out.float() - out.float()).abs().max().item():.3e}")
            else:
                log(f"[eva_rowmajor vs eva_kernel] {label}: equal bit for bit")
        del a
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        gen1 = torch.Generator(device="cuda").manual_seed(109)
        r = lambda *sh: torch.randn(*sh, generator=gen1, device="cuda")  # noqa: E731
        ops = [r(2, 3, 5, 8, 16).to(dtype) for _ in range(3)]
        ops += [r(2, 3, 5, 16).to(dtype), r(2, 3, 5, 16).to(dtype)]
        bias = 0.5 * r(3, 8, 8)
        out = k11.eva_attention_fused(*ops, 0.25, bias)
        torch.cuda.synchronize()
        ref = k11.eva_fused_ref(*ops, 0.25, bias)
        err = (out.float() - ref.float()).abs().max().item()
        tol = K1_TOL[f"torch.{dtype_name}"] * max(1.0, ref.float().abs().max().item())
        log(f"[eva_kernel vs plain] 1-D {dtype_name}: max abs err {err:.3e} (tol "
            f"{tol:.1e})")
        if not err <= tol:
            raise AssertionError(f"eva_kernel 1-D {dtype_name}: max abs err {err}")
    # CUDA tensors outside the gates raise (head dim 20), launching nothing
    a = win_inputs(1, 2, 8, 8, 4, 4, 20, torch.float32, seed=108)
    before = k11.LAUNCHES, k12.LAUNCHES
    for name, (kernel, _) in win_calls(k11, k12, a, 8, 4).items():
        try:
            kernel()
        except ValueError as err:
            log(f"[{name} outside its gate] raises: {err}")
        else:
            raise AssertionError(f"{name} took head dim 20")
    if (k11.LAUNCHES, k12.LAUNCHES) != before:
        raise AssertionError("a kernel outside its gate launched")
    del a

    # ---- 3. the LM training path, counts set to 0 just before and read after
    shutil.rmtree("build/smoke_lm", ignore_errors=True)  # nothing to resume
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k3.LAUNCHES_FWD = k3.LAUNCHES_BWD = k3.LAUNCHES_FWD_TF32 = k3.LAUNCHES_BWD_TF32 = 0
    t0 = time.perf_counter()
    lm_stats = train_lm.cli_main(LM_ARGV + LM_TRAIN_ARGV)
    torch.cuda.synchronize()
    lm_launches = {"causal_packed_fwd": k3.LAUNCHES_FWD,
                   "causal_packed_bwd": k3.LAUNCHES_BWD}
    lm_fwd_tf32, lm_bwd_tf32 = k3.LAUNCHES_FWD_TF32, k3.LAUNCHES_BWD_TF32
    lm_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[lm-train] 8 steps + validation {json.dumps(lm_stats)} in "
        f"{time.perf_counter() - t0:.2f} s; launches {json.dumps(lm_launches)}, "
        f"{lm_fwd_tf32} of the forwards and {lm_bwd_tf32} of the backwards on the "
        f"split-TF32 routes")
    log(f"[lm-train] peak device memory {lm_peak_gb:.3f} GiB "
        f"(torch.cuda.max_memory_allocated, train steps and validation)")
    for key in ("loss", "gnorm", "valid_loss"):
        if not math.isfinite(lm_stats[key]):
            raise AssertionError(f"non-finite {key} in {lm_stats}")
    if lm_stats["step"] != 8 or lm_launches != {
            "causal_packed_fwd": 16 * (8 + lm_stats["valid_batches"]),
            "causal_packed_bwd": 16 * 8}:
        raise AssertionError(f"launches {lm_launches} for 8 train steps and "
                             f"{lm_stats['valid_batches']} validation batches "
                             "of a 16-layer model")
    if lm_fwd_tf32 != lm_launches["causal_packed_fwd"]:
        raise AssertionError(f"{lm_fwd_tf32} of {lm_launches['causal_packed_fwd']} "
                             "LM forwards on the split-TF32 route")
    if lm_bwd_tf32 != lm_launches["causal_packed_bwd"]:
        raise AssertionError(f"{lm_bwd_tf32} of {lm_launches['causal_packed_bwd']} "
                             "LM backwards on the split-TF32 route")
    # f32 gradients of a 2-layer full-width LM: the kernel path against the
    # eager path, train mode, zero proposal noise, dropout 0
    lm_args = train_lm.parse_args(LM_ARGV + ["--decoder-layers", "2"])
    lm = train_lm.build_model(lm_args, LM_VOCAB, dense_tokens=True).cuda().train()
    lm_eager = copy.deepcopy(lm)
    for layer in lm_eager.decoder.layers:
        layer.self_attn.impl = "xla"
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(4, LM_VOCAB, (4, 513), generator=gen, device="cuda")
    before = k3.LAUNCHES_BWD
    with mock.patch.object(CausalEVAttention, "_proposal_noise",
                           lambda self, shape, like: like.new_zeros(shape)):
        for m in (lm, lm_eager):
            m.loss(toks[:, :-1], toks[:, 1:]).mean().backward()
    torch.cuda.synchronize()
    if k3.LAUNCHES_BWD - before != 2:
        raise AssertionError("the kernel path did not run causal_packed twice")
    gerr, gpeak = 0.0, 0.0
    for p, pe in zip(lm.parameters(), lm_eager.parameters()):
        gerr = max(gerr, (p.grad - pe.grad).abs().max().item())
        gpeak = max(gpeak, pe.grad.abs().max().item())
    lm_gtol = GRAD_TOL * max(1.0, gpeak)
    log(f"[lm-train] f32 gradients kernel path vs eager path, 2 layers at full "
        f"width, all {len(list(lm.parameters()))} parameters: max abs err "
        f"{gerr:.3e} (tol {lm_gtol:.1e}), max |grad| {gpeak:.3e}")
    if not gerr <= lm_gtol:
        raise AssertionError(f"f32 LM gradients differ by {gerr}")
    del lm, lm_eager
    torch.cuda.empty_cache()

    # ---- 3b. the LM protocol on binarized data, every count set to 0 just
    # before each CLI call and read just after
    lm_protocol = lm_protocol_phase(torch, card, all_counters + (
        (k3, "LAUNCHES_FWD_TF32"), (k3, "LAUNCHES_BWD_TF32")))
    print(json.dumps({"lm_protocol": lm_protocol}), flush=True)

    # ---- 4. the serving path, counts set to 0 just before and read just after
    k2.LAUNCHES = k2.LAUNCHES_MMA = 0
    t0 = time.perf_counter()
    stats = train_vit.cli_main(MAIN_ARGV + ["--eval", "--bf16"])
    torch.cuda.synchronize()
    launches, launches_mma = k2.LAUNCHES, k2.LAUNCHES_MMA
    log(f"[serve] eval {json.dumps(stats)} in {time.perf_counter() - t0:.2f} s;"
        f" eva_single launches {launches}, on the tensor-core route {launches_mma}")
    if not all(math.isfinite(stats[k]) for k in ("acc1", "acc5", "loss")):
        raise AssertionError(f"non-finite eval stats {stats}")
    if stats["batches"] != 4 or launches != 12 * stats["batches"]:
        raise AssertionError(f"{launches} eva_single launches for "
                             f"{stats['batches']} batches of a 12-block model")
    if launches_mma != launches:
        raise AssertionError(f"{launches_mma} of the {launches} bf16 eva_single launches "
                             "took the tensor-core route")
    # the tracked DeiT-tiny-p16 cell: 14x14 tokens, chunks of 2x2, K2 in
    # every block; counts set to 0 just before and read just after
    k2.LAUNCHES = k2.LAUNCHES_MMA = 0
    t0 = time.perf_counter()
    p16_stats = train_vit.cli_main(P16_ARGV + ["--eval", "--bf16"])
    torch.cuda.synchronize()
    p16_launches = (k2.LAUNCHES, k2.LAUNCHES_MMA)
    log(f"[serve p16] eval {json.dumps(p16_stats)} in {time.perf_counter() - t0:.2f} s;"
        f" eva_single launches {p16_launches[0]}, on the tensor-core route "
        f"{p16_launches[1]}")
    if not all(math.isfinite(p16_stats[k]) for k in ("acc1", "acc5", "loss")):
        raise AssertionError(f"non-finite p16 eval stats {p16_stats}")
    if p16_launches != (12 * p16_stats["batches"],) * 2 or p16_stats["batches"] != 4:
        raise AssertionError(f"p16: eva_single launches {p16_launches} for "
                             f"{p16_stats['batches']} batches of a 12-block model")
    # f32 logits: the kernel path against the eager path on the card
    args = train_vit.parse_args(MAIN_ARGV + ["--eval"])
    model = train_vit.build_model(args).cuda()
    eager = copy.deepcopy(model)
    for blk in eager.blocks:
        blk.attn.impl = "xla"
    from efficient_attention_torch.data.imagenet import SyntheticImageDataset

    ds = SyntheticImageDataset(8, 224, 1000, train=False)
    x = torch.stack([torch.from_numpy(ds.load(i, None)[0]) for i in range(8)]).cuda()
    with torch.no_grad():
        logits, logits_eager = model(x), eager(x)
    torch.cuda.synchronize()
    if logits.shape != (8, 1000) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits {logits.shape}")
    lerr = (logits - logits_eager).abs().max().item()
    lscale = logits_eager.abs().max().item()
    log(f"[serve] f32 logits kernel path vs eager path: max abs err {lerr:.3e}"
        f" (tol {LOGITS_TOL:.0e}), max |logit| {lscale:.3e}")
    if not lerr <= LOGITS_TOL:
        raise AssertionError(f"f32 logits differ by {lerr}")

    # the LARA, Performer and local cells: counts set to 0 just before each
    # eval and read just after, then f32 logits, kernel path against eager
    counted = {k.NAME: k for k in (k5, k6, k7)}
    cell_kernel = {"lara": k5.NAME, "performer": k6.NAME, "local": k7.NAME}
    cell_launches = {}
    for cell, flags in CELLS.items():
        for k in counted.values():
            k.LAUNCHES = 0
        k5.LAUNCHES_MMA = k7.LAUNCHES_MMA = k6.LAUNCHES_RING = 0
        k1.LAUNCHES_FWD = k1.LAUNCHES_BWD = k2.LAUNCHES = 0
        k3.LAUNCHES_FWD = k3.LAUNCHES_BWD = 0
        t0 = time.perf_counter()
        stats = train_vit.cli_main(CELL_ARGV + flags + ["--eval", "--bf16"])
        torch.cuda.synchronize()
        got = {name: k.LAUNCHES for name, k in counted.items()}
        k5_mma, k6_ring, k7_mma = k5.LAUNCHES_MMA, k6.LAUNCHES_RING, k7.LAUNCHES_MMA
        others = (k1.LAUNCHES_FWD + k1.LAUNCHES_BWD + k2.LAUNCHES
                  + k3.LAUNCHES_FWD + k3.LAUNCHES_BWD)
        log(f"[serve {cell}] eval {json.dumps(stats)} in "
            f"{time.perf_counter() - t0:.2f} s; launches {json.dumps(got)}, "
            f"lara_fused on its cluster route {k5_mma}, performer_fused on its ring "
            f"route {k6_ring}, local_packed on its tensor-core route {k7_mma}, K1-K3 "
            f"{others}")
        if k5_mma != got[k5.NAME]:
            raise AssertionError(f"{cell}: {k5_mma} of {got[k5.NAME]} lara_fused "
                                 f"launches on its cluster route")
        if cell == "lara":
            lara_mma = k5_mma
        if k6_ring != got[k6.NAME]:
            raise AssertionError(f"{cell}: {k6_ring} of {got[k6.NAME]} performer_fused "
                                 f"launches on its ring route")
        if cell == "performer":
            performer_ring = k6_ring
        if k7_mma != got[k7.NAME]:
            raise AssertionError(f"{cell}: {k7_mma} of {got[k7.NAME]} local_packed "
                                 f"launches on its tensor-core route")
        if not all(math.isfinite(stats[k]) for k in ("acc1", "acc5", "loss")):
            raise AssertionError(f"non-finite {cell} eval stats {stats}")
        want = {name: 12 * stats["batches"] if name == cell_kernel[cell] else 0
                for name in counted}
        if stats["batches"] != 4 or got != want or others:
            raise AssertionError(f"{cell}: launches {got} (K1-K3 {others}) for "
                                 f"{stats['batches']} batches, want {want}")
        cell_launches[cell_kernel[cell]] = got[cell_kernel[cell]]
        args = train_vit.parse_args(CELL_ARGV + flags + ["--eval"])
        model = train_vit.build_model(args).cuda()
        eager = copy.deepcopy(model)
        for blk in eager.blocks:
            blk.attn.impl = "xla"
        before = counted[cell_kernel[cell]].LAUNCHES
        with torch.no_grad():
            logits, logits_eager = model(x), eager(x)
        torch.cuda.synchronize()
        if counted[cell_kernel[cell]].LAUNCHES - before != 12:
            raise AssertionError(f"the {cell} kernel path did not launch "
                                 f"{cell_kernel[cell]} 12 times")
        if logits.shape != (8, 1000) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad {cell} logits {logits.shape}")
        lerr = (logits - logits_eager).abs().max().item()
        log(f"[serve {cell}] f32 logits kernel path vs eager path: max abs err "
            f"{lerr:.3e} (tol {LOGITS_TOL:.0e}), max |logit| "
            f"{logits_eager.abs().max().item():.3e}")
        if not lerr <= LOGITS_TOL:
            raise AssertionError(f"{cell} f32 logits differ by {lerr}")
        del model, eager

    # EVA's routes on the serving cell, each selected by its attention args
    # on the namespace that build_model reads: every kernel's count set to 0
    # just before the 4-batch eval and read just after; then f32 logits of
    # the route against the eager path
    counters = ((k2, "LAUNCHES", k2.NAME), (k1, "LAUNCHES_FWD", "eva_packed_fwd"),
                (k1, "LAUNCHES_BWD", "eva_packed_bwd"),
                (k3, "LAUNCHES_FWD", "causal_packed_fwd"),
                (k3, "LAUNCHES_BWD", "causal_packed_bwd"), (k4, "LAUNCHES", k4.NAME),
                (k5, "LAUNCHES", k5.NAME), (k6, "LAUNCHES", k6.NAME),
                (k7, "LAUNCHES", k7.NAME), (k8, "LAUNCHES", k8.NAME),
                (k1, "LAUNCHES_OUT", k1.NAME_OUT),
                (k10, "LAUNCHES_SUMMARIES", k10.NAME_SUMMARIES),
                (k10, "LAUNCHES_ATTENTION", k10.NAME_ATTENTION),
                (k11, "LAUNCHES", k11.NAME), (k12, "LAUNCHES", k12.NAME))

    def launched():
        return {name: getattr(k, attr) for k, attr, name in counters
                if getattr(k, attr)}

    def route_args(extra, toggles):
        rargs = train_vit.parse_args(MAIN_ARGV + extra)
        for key, value in toggles.items():
            setattr(rargs.attn_specific_args, key, value)
        return rargs

    route_launches, route_fwd_mma, route_out_mma, route_sum_mma = {}, {}, {}, {}
    for route, (toggles, route_kernels) in EVA_ROUTES.items():
        for k, attr, _ in counters:
            setattr(k, attr, 0)
        k1.LAUNCHES_FWD_MMA = k2.LAUNCHES_MMA = 0
        k1.LAUNCHES_OUT_MMA = k10.LAUNCHES_ATTENTION_MMA = 0
        k8.LAUNCHES_MMA = k10.LAUNCHES_SUMMARIES_MMA = 0
        t0 = time.perf_counter()
        stats = train_vit.main(route_args(["--eval", "--bf16"], toggles))
        torch.cuda.synchronize()
        got = launched()
        fwd_mma = k1.LAUNCHES_FWD_MMA
        log(f"[serve eva {route}] {json.dumps(toggles)}: eval {json.dumps(stats)} "
            f"in {time.perf_counter() - t0:.2f} s; launches {json.dumps(got)}, "
            f"eva_packed forward on the tensor-core route {fwd_mma}")
        if not all(math.isfinite(stats[k]) for k in ("acc1", "acc5", "loss")):
            raise AssertionError(f"non-finite eva {route} eval stats {stats}")
        want = {name: 12 * stats["batches"] for name in route_kernels}
        if stats["batches"] != 4 or got != want:
            raise AssertionError(f"eva {route}: launches {got} for "
                                 f"{stats['batches']} batches, want {want}")
        # every bf16 K1 and K2 launch on its tensor-core route
        if k2.LAUNCHES_MMA != got.get(k2.NAME, 0):
            raise AssertionError(f"eva {route}: {k2.LAUNCHES_MMA} of the "
                                 f"{got.get(k2.NAME, 0)} eva_single launches took the "
                                 f"tensor-core route")
        if fwd_mma != got.get("eva_packed_fwd", 0):
            raise AssertionError(f"eva {route}: {fwd_mma} of the "
                                 f"{got.get('eva_packed_fwd', 0)} bf16 eva_packed "
                                 f"forward launches took the tensor-core route")
        # every K8 and K10a launch on the persistent route
        sum_mma = {k8.NAME: k8.LAUNCHES_MMA,
                   k10.NAME_SUMMARIES: k10.LAUNCHES_SUMMARIES_MMA}
        if any(n != got.get(name, 0) for name, n in sum_mma.items()):
            raise AssertionError(f"eva {route}: {sum_mma} of the launches {got} took "
                                 f"the persistent summaries route")
        if any(name in route_kernels for name in sum_mma):
            route_sum_mma[route] = sum_mma
        # and every bf16 K9 and K10 attention launch on theirs
        out_mma = {k1.NAME_OUT: k1.LAUNCHES_OUT_MMA,
                   k10.NAME_ATTENTION: k10.LAUNCHES_ATTENTION_MMA}
        if any(n != got.get(name, 0) for name, n in out_mma.items()):
            raise AssertionError(f"eva {route}: {out_mma} of the launches {got} took "
                                 f"the tensor-core route")
        if any(name in route_kernels for name in out_mma):
            route_out_mma[route] = out_mma
        route_launches[route] = got
        if "eva_packed_fwd" in route_kernels:
            route_fwd_mma[route] = fwd_mma
        model = train_vit.build_model(route_args(["--eval"], toggles)).cuda()
        eager = copy.deepcopy(model)
        for blk in eager.blocks:
            blk.attn.impl = "xla"
        before = dict(launched())
        with torch.no_grad():
            logits, logits_eager = model(x), eager(x)
        torch.cuda.synchronize()
        delta = {n: c - before.get(n, 0) for n, c in launched().items()
                 if c != before.get(n, 0)}
        if delta != {name: 12 for name in route_kernels}:
            raise AssertionError(f"eva {route} f32 forward launched {delta}")
        if logits.shape != (8, 1000) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad eva {route} logits {logits.shape}")
        lerr = (logits - logits_eager).abs().max().item()
        log(f"[serve eva {route}] f32 logits vs eager path: max abs err "
            f"{lerr:.3e} (tol {LOGITS_TOL:.0e}), max |logit| "
            f"{logits_eager.abs().max().item():.3e}")
        if not lerr <= LOGITS_TOL:
            raise AssertionError(f"eva {route} f32 logits differ by {lerr}")
        del model, eager

    # K11 as EVA's auto fallback (JAX attention/eva.py:767-793): 28x28
    # tokens, window 7, 49 landmarks, 2 heads of 48, a head dim K1 and K2
    # are not built for; eval, then training (zero RF noise) with every
    # gradient, against the eager path in f32
    fb = EVA(96, 2, window_size=7, attn_2d=True, use_rpe=True,
             num_landmarks=49).cuda()
    if (k1.supports_packed(16, 784, 28, 7, 49, 48, 4, 2)
            or k2.supports_single(16, 28, 28, 7, 4, "default", 288, 2, 4)
            or not k11.supports_fused(16, 16, 49, 49, 48, 4, 2)):
        raise AssertionError("the fallback geometry is not one for K11 alone")
    with torch.no_grad():
        fb.local_relative_position_bias_table.normal_(0.0, 0.5)
    fb_eager = set_impl(copy.deepcopy(fb), EVA, "xla")
    gen_fb = torch.Generator(device="cuda").manual_seed(111)
    xf = torch.randn(16, 28, 28, 96, generator=gen_fb, device="cuda")
    cot = torch.randn(xf.shape, generator=gen_fb, device="cuda")
    fb_errors = {}
    for train in (False, True):
        for k, attr, _ in counters:
            setattr(k, attr, 0)
        outs = []
        with mock.patch.object(EVA, "_sample_weights", lambda self, mu: mu):
            for m in (fb, fb_eager):
                m.train(train).zero_grad()
                xt = xf.clone().requires_grad_(train)
                with torch.set_grad_enabled(train):
                    out = m(xt)
                    if train:
                        (out * cot).sum().backward()
                outs.append([out.detach(), *([xt.grad] + [
                    p.grad for p in m.parameters()] if train else [])])
        torch.cuda.synchronize()
        got = launched()
        if got != {k11.NAME: 1}:
            raise AssertionError(f"the auto fallback launched {got}")
        errs = [(a - b).abs().max().item() / max(1.0, b.abs().max().item())
                for a, b in zip(*outs)]
        fb_errors["train" if train else "eval"] = max(errs)
        log(f"[auto fallback] {'train' if train else 'eval'}: K11 launched once; "
            f"f32 output{' and all gradients' if train else ''} vs eager path: "
            f"max err {max(errs):.3e} relative to the largest |value| (at least "
            f"1; tol {GRAD_TOL:.0e})")
        if not max(errs) <= GRAD_TOL:
            raise AssertionError(f"auto fallback differs from eager by {max(errs)}")
    del fb, fb_eager, xf, cot

    # PVTv2-B3 served on each route: every kernel's count set to 0 just before
    # the 4-batch eval and read just after; then f32 logits of each route on
    # 8 images against the eager path (TF32 off in cuDNN's convolutions)
    def pvt_args(extra, impl):
        pargs = train_vit.parse_args(PVT_ARGV + extra)
        setattr(pargs.attn_specific_args, "impl", impl)
        return pargs

    pvt_launches = {}
    for impl, kname in PVT_ROUTES.items():
        for k, attr, _ in counters:
            setattr(k, attr, 0)
        k2.LAUNCHES_MMA = 0
        t0 = time.perf_counter()
        stats = train_vit.main(pvt_args(["--eval", "--bf16"], impl))
        torch.cuda.synchronize()
        got = launched()
        if k2.LAUNCHES_MMA != got.get(k2.NAME, 0):
            raise AssertionError(f"pvt {impl}: {k2.LAUNCHES_MMA} of the "
                                 f"{got.get(k2.NAME, 0)} eva_single launches took the "
                                 f"tensor-core route")
        log(f"[serve pvt {impl}] eval {json.dumps(stats)} in "
            f"{time.perf_counter() - t0:.2f} s; launches {json.dumps(got)}")
        if not all(math.isfinite(stats[k]) for k in ("acc1", "acc5", "loss")):
            raise AssertionError(f"non-finite pvt {impl} eval stats {stats}")
        if stats["batches"] != 4 or got != {kname: PVT_EVA_BLOCKS * 4}:
            raise AssertionError(f"pvt {impl}: launches {got} for "
                                 f"{stats['batches']} batches of "
                                 f"{PVT_EVA_BLOCKS} EVA blocks")
        pvt_launches[impl] = got[kname]
        if impl == "auto":
            pvt_k2_mma = k2.LAUNCHES_MMA
    pvt = set_impl(train_vit.build_model(pvt_args(["--eval"], "xla")).cuda(),
                   EVA, "xla")
    with torch.no_grad():
        pvt_eager = pvt(x)
    pvt_errors = {}
    for impl, kname in PVT_ROUTES.items():
        before = dict(launched())
        with torch.no_grad():
            logits = set_impl(pvt, EVA, impl)(x)
        torch.cuda.synchronize()
        delta = {n: c - before.get(n, 0) for n, c in launched().items()
                 if c != before.get(n, 0)}
        if delta != {kname: PVT_EVA_BLOCKS}:
            raise AssertionError(f"pvt {impl} f32 forward launched {delta}")
        if logits.shape != (8, 1000) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad pvt {impl} logits {logits.shape}")
        lerr = (logits - pvt_eager).abs().max().item()
        pvt_errors[impl] = lerr
        log(f"[serve pvt {impl}] f32 logits vs eager path: max abs err "
            f"{lerr:.3e} (tol {LOGITS_TOL:.0e}), max |logit| "
            f"{pvt_eager.abs().max().item():.3e}")
        if not lerr <= LOGITS_TOL:
            raise AssertionError(f"pvt {impl} f32 logits differ by {lerr}")
    del pvt
    torch.cuda.empty_cache()

    # ---- 5. the MT serving path, counts set to 0 just before and read after
    for k in (k2, k4, k5, k6, k7):
        k.LAUNCHES = 0
    k1.LAUNCHES_FWD = k1.LAUNCHES_BWD = k3.LAUNCHES_FWD = k3.LAUNCHES_BWD = 0
    k4.LAUNCHES_TF32 = 0
    t0 = time.perf_counter()
    mt_result = generate.cli_main(MT_ARGV)
    torch.cuda.synchronize()
    mt_wall = time.perf_counter() - t0
    mt_launches, mt_tf32 = k4.LAUNCHES, k4.LAUNCHES_TF32
    others = (k1.LAUNCHES_FWD + k1.LAUNCHES_BWD + k2.LAUNCHES + k3.LAUNCHES_FWD
              + k3.LAUNCHES_BWD + k5.LAUNCHES + k6.LAUNCHES + k7.LAUNCHES)
    mt_batches = -(-mt_result["sentences"] // 64)
    log(f"[mt-serve] generate {mt_result['sentences']} sentences in {mt_wall:.2f} s "
        f"(bleu {mt_result['bleu']}, {mt_result['hypothesis_tokens']} hypothesis "
        f"tokens, encode {mt_result['encode_s']:.3f} s, beam loop "
        f"{mt_result['beam_s']:.3f} s); eva_1d launches {mt_launches} ({mt_tf32} on "
        f"the f32 route), other kernels {others}")
    if not math.isfinite(mt_result["bleu"]) or mt_result["sentences"] != 256:
        raise AssertionError(f"bad generate result {mt_result['bleu']}, "
                             f"{mt_result['sentences']} sentences")
    if mt_batches != 4 or mt_launches != 6 * mt_batches or others:
        raise AssertionError(f"{mt_launches} eva_1d launches (others {others}) "
                             f"for {mt_batches} batches of a 6-layer encoder")
    if mt_tf32 != mt_launches:
        raise AssertionError(f"{mt_tf32} of {mt_launches} eva_1d launches took the "
                             f"f32 route")
    # f32 encoder states and 1-best hypotheses: kernel path against eager
    mt_args = generate.parse_args(MT_ARGV)
    mt_model = generate.build_model(mt_args, MT_VOCAB, MT_VOCAB).cuda().eval()
    mt_eager = copy.deepcopy(mt_model)
    for layer in mt_eager.encoder.layers:
        layer.self_attn.attn.impl = "xla"
    src, _, _, _ = generate.load_pairs(mt_args)
    _, src_b, _, _, _ = next(generate.generation_batches(mt_args, src))
    src_t = torch.from_numpy(src_b).cuda()
    before = k4.LAUNCHES
    with torch.no_grad():
        (enc, pad), (enc_eager, _) = mt_model.encode(src_t), mt_eager.encode(src_t)
    torch.cuda.synchronize()
    if k4.LAUNCHES - before != 6:
        raise AssertionError("the kernel path did not launch eva_1d 6 times")
    keep = ~pad
    eerr = (enc - enc_eager)[keep].abs().max().item()
    log(f"[mt-serve] f32 encoder states kernel path vs eager path, batch "
        f"{tuple(src_b.shape)}, {int(keep.sum())} non-pad positions: max abs "
        f"err {eerr:.3e} (tol {ENC_TOL:.0e}), max |value| "
        f"{enc_eager[keep].abs().max().item():.3e}")
    if not eerr <= ENC_TOL:
        raise AssertionError(f"f32 encoder states differ by {eerr}")
    mt_runs = {}
    for path, m in (("kernel", mt_model), ("eager", mt_eager), ("eager again", mt_eager),
                    ("kernel again", mt_model)):
        t0 = time.perf_counter()
        res = generate.translate(mt_args, m, torch.device("cuda"))
        torch.cuda.synchronize()
        res["wall_s"] = time.perf_counter() - t0
        mt_runs[path] = res
    same = sum(a == b for a, b in zip(mt_runs["kernel"]["hypotheses"],
                                      mt_runs["eager"]["hypotheses"]))
    log(f"[mt-serve] 1-best hypotheses identical between the kernel and the "
        f"eager encoder: {same} of {len(mt_runs['kernel']['hypotheses'])} "
        f"({same / len(mt_runs['kernel']['hypotheses']):.3f}); BLEU kernel "
        f"{mt_runs['kernel']['bleu']}, eager {mt_runs['eager']['bleu']}")

    # ---- 6. the MT training path, counts set to 0 just before and read after
    mt_train_phase(torch, card, all_counters, k4)

    # ---- 6b. the MT protocol from text to BLEU, every count set to 0 just
    # before each CLI call and read just after
    mt_protocol = mt_protocol_phase(torch, card, all_counters, k4)
    print(json.dumps({"mt_protocol": mt_protocol}), flush=True)

    # ---- 7. the ViT training path, counts set to 0 just before and read after
    k1.LAUNCHES_FWD = k1.LAUNCHES_BWD = k2.LAUNCHES = k2.LAUNCHES_MMA = 0
    k1.LAUNCHES_FWD_MMA = k1.LAUNCHES_BWD_MMA = 0
    t0 = time.perf_counter()
    record = train_vit.cli_main(MAIN_ARGV + TRAIN_ARGV)
    torch.cuda.synchronize()
    train_launches = {"eva_packed_fwd": k1.LAUNCHES_FWD,
                      "eva_packed_bwd": k1.LAUNCHES_BWD,
                      "eva_single": k2.LAUNCHES}
    fwd_mma_launches, bwd_mma_launches = k1.LAUNCHES_FWD_MMA, k1.LAUNCHES_BWD_MMA
    log(f"[train] 8 steps + eval {json.dumps(record)} in "
        f"{time.perf_counter() - t0:.2f} s; launches {json.dumps(train_launches)}")
    # the epoch's loss and grad norm are means over its steps, so they are
    # finite only if every step's are (the loop itself aborts on a
    # non-finite loss)
    for key in ("loss", "grad_norm", "val_loss", "val_acc1"):
        if not math.isfinite(record[key]):
            raise AssertionError(f"non-finite {key} in {record}")
    if train_launches != {"eva_packed_fwd": 12 * 8, "eva_packed_bwd": 12 * 8,
                          "eva_single": 12 * 4}:
        raise AssertionError(f"launches {train_launches} for 8 train steps and "
                             "4 eval batches of a 12-block model")
    log(f"[train] eva_packed launches on the tensor-core routes: forward "
        f"{fwd_mma_launches} of {train_launches['eva_packed_fwd']}, backward "
        f"{bwd_mma_launches} of {train_launches['eva_packed_bwd']}")
    if k2.LAUNCHES_MMA:  # the end-of-epoch eval runs the f32 parameters
        raise AssertionError(f"{k2.LAUNCHES_MMA} f32 eval eva_single launches took the "
                             "tensor-core route")
    if (fwd_mma_launches, bwd_mma_launches) != (12 * 8, 12 * 8):
        raise AssertionError(f"{fwd_mma_launches} of the 96 bf16 eva_packed forward "
                             f"and {bwd_mma_launches} of the 96 backward launches "
                             "took the tensor-core routes")
    # f32 gradients of every parameter: the kernel path against the eager
    # path, train mode, zero RF noise, no drop-path
    args = train_vit.parse_args(MAIN_ARGV + ["--drop-path", "0"])
    model = train_vit.build_model(args).cuda().train()
    eager = copy.deepcopy(model)
    for blk in eager.blocks:
        blk.attn.impl = "xla"
    from efficient_attention_torch.data.mixup import (
        one_hot_smooth,
        soft_target_cross_entropy,
    )

    labels = torch.arange(8, device="cuda") * 97 % 1000
    targets = one_hot_smooth(labels, 1000, 0.1)
    before = k1.LAUNCHES_FWD
    with mock.patch.object(EVA, "_sample_weights", lambda self, mu: mu):
        for m in (model, eager):
            soft_target_cross_entropy(m(x), targets).backward()
    torch.cuda.synchronize()
    if k1.LAUNCHES_FWD - before != 12:
        raise AssertionError("the kernel path did not run eva_packed 12 times")
    gerr, gpeak = 0.0, 0.0
    for (name, p), pe in zip(model.named_parameters(), eager.parameters()):
        gerr = max(gerr, (p.grad - pe.grad).abs().max().item())
        gpeak = max(gpeak, pe.grad.abs().max().item())
    gtol = GRAD_TOL * max(1.0, gpeak)
    log(f"[train] f32 gradients kernel path vs eager path, all "
        f"{len(list(model.parameters()))} parameters: max abs err {gerr:.3e} "
        f"(tol {gtol:.1e}), max |grad| {gpeak:.3e}")
    if not gerr <= gtol:
        raise AssertionError(f"f32 gradients differ by {gerr}")
    del model, eager
    # the same training step with impl='pallas' (K11) and impl='rowmajor'
    # (K12), whose gradients are autograd's over the plain versions: counts
    # set to 0 just before and read just after; then f32 gradients
    win_train = {}
    for impl, kname in (("pallas", k11.NAME), ("rowmajor", k12.NAME)):
        for k, attr, _ in counters:
            setattr(k, attr, 0)
        t0 = time.perf_counter()
        record = train_vit.main(route_args(TRAIN_ARGV, {"impl": impl}))
        torch.cuda.synchronize()
        got = launched()
        log(f"[train {impl}] 8 steps + eval {json.dumps(record)} in "
            f"{time.perf_counter() - t0:.2f} s; launches {json.dumps(got)}")
        for key in ("loss", "grad_norm", "val_loss", "val_acc1"):
            if not math.isfinite(record[key]):
                raise AssertionError(f"non-finite {key} in {record}")
        if got != {kname: 12 * 8 + 12 * 4}:
            raise AssertionError(f"train {impl}: launches {got} for 8 train "
                                 "steps and 4 eval batches of a 12-block model")
        win_train[kname] = got[kname]
        model = train_vit.build_model(route_args(["--drop-path", "0"],
                                                 {"impl": impl})).cuda().train()
        eager = set_impl(copy.deepcopy(model), EVA, "xla")
        before = dict(launched())
        with mock.patch.object(EVA, "_sample_weights", lambda self, mu: mu):
            for m in (model, eager):
                soft_target_cross_entropy(m(x), targets).backward()
        torch.cuda.synchronize()
        if launched().get(kname, 0) - before.get(kname, 0) != 12:
            raise AssertionError(f"the {impl} path did not run {kname} 12 times")
        gerr, gpeak = 0.0, 0.0
        for p, pe in zip(model.parameters(), eager.parameters()):
            gerr = max(gerr, (p.grad - pe.grad).abs().max().item())
            gpeak = max(gpeak, pe.grad.abs().max().item())
        gtol = GRAD_TOL * max(1.0, gpeak)
        log(f"[train {impl}] f32 gradients vs eager path, all "
            f"{len(list(model.parameters()))} parameters: max abs err {gerr:.3e} "
            f"(tol {gtol:.1e}), max |grad| {gpeak:.3e}")
        if not gerr <= gtol:
            raise AssertionError(f"{impl} f32 gradients differ by {gerr}")
        del model, eager

    # ---- 7b. the ImageNet recipe from an image folder to a top-1, every
    # count set to 0 just before each CLI call and read just after
    vit_protocol = vit_protocol_phase(torch, card, all_counters + (
        (k1, "LAUNCHES_FWD_MMA"), (k1, "LAUNCHES_BWD_MMA"), (k2, "LAUNCHES_MMA")))
    print(json.dumps({"vit_protocol": vit_protocol}), flush=True)

    # ---- 7c. the rest of the zoo, the stems, the optimizers and validate,
    # every count set to 0 just before each call and read just after
    zoo = zoo_phase(torch, card, all_counters + (
        (k1, "LAUNCHES_FWD_MMA"), (k1, "LAUNCHES_BWD_MMA"), (k2, "LAUNCHES_MMA"),
        (k3, "LAUNCHES_FWD_TF32"), (k3, "LAUNCHES_BWD_TF32")))
    print(json.dumps({"zoo": zoo}), flush=True)

    # ---- 7d. the mesh on torch.distributed with the one card: DDP, FSDP2,
    # TP and FSDP2 + TP on NCCL at world size 1, two gloo ranks on the card
    scaleout = scaleout_phase(torch, card, all_counters, k1, k3, k4)
    print(json.dumps({"scaleout": scaleout}), flush=True)

    # ---- 8. timings
    # K2 in bf16 at the headline, PVT-B3's three EVA stages and DeiT-tiny-p16:
    # its tensor-core route at plan()'s cluster size, the CUDA-core kernel
    # forced, and K8 + K1 (the `summaries` route: the same function in two
    # launches; no single PyTorch call computes it) on the same inputs, in
    # turns; then the plain version and the bound (the route at each cluster
    # size: scripts/torch_eva_single_phases.py)
    k2_time = {}
    for label, (B, g, j, nh, d) in K2_SHAPES:
        args, bias = k2_inputs(B, g, 7, j, nh, d, torch.bfloat16, seed=7)
        out = k2.eva_attention_single(*args, bias=bias)

        def k8_k1():
            rf, beta = k8.eva_summaries_packed(args[0], *args[1:9], nh, g, j, True)
            return k1._forward(args[0], rf, beta, bias, d ** -0.5, nh, g, 7)

        calls = {"tensor cores": lambda: k2.eva_attention_single(*args, bias=bias),
                 "cuda cores": lambda: k2.eva_attention_single(*args, bias=bias,
                                                              cuda_cores=True),
                 "k8+k1": k8_k1}
        turns = {}
        for name in ("tensor cores", "cuda cores", "k8+k1", "k8+k1", "cuda cores",
                     "tensor cores"):
            turns.setdefault(name, []).append(
                cuda_ms(calls[name], 5 if name == "cuda cores" else 20))
        k2_time[label] = {
            "ms": sum(turns["tensor cores"]) / 2, "turns": turns,
            "plan": k2.plan(B, nh, g, g, 7, j, d, 2)[:2],
            "plain_ms": cuda_ms(lambda: k2.eva_attention_single_ref(*args, bias=bias), 3),
            "bound": k2_bound(args, bias, out)}
        log(f"[time] eva_single {label} (B={B}, {g}x{g} tokens, chunks {j}x{j}, {nh} "
            f"heads of {d}) bf16: {json.dumps(k2_time[label])}; {card}")
        del args, bias, out
    k2_ms, plain_ms = k2_time["headline"]["ms"], k2_time["headline"]["plain_ms"]
    bound_ms, bound_by = k2_time["headline"]["bound"]
    tp_args = train_vit.parse_args(MAIN_ARGV + ["--throughput", "--bf16"])
    device, bf16 = torch.device("cuda"), torch.bfloat16
    kernel_model = train_vit.build_model(tp_args).to(device, bf16)
    eager_model = copy.deepcopy(kernel_model)
    for blk in eager_model.blocks:
        blk.attn.impl = "xla"
    sm_args = train_vit.parse_args(
        ["--model", "evit_tiny_p8", "--attn-name", "softmax", "--input-size",
         "224", "--batch-size", "128", "--throughput", "--bf16"])
    softmax_model = train_vit.build_model(sm_args).to(device, bf16)
    rates = {}
    for name, m in (("eva kernel path", kernel_model),
                    ("eva eager path", eager_model),
                    ("softmax", softmax_model),
                    ("eva kernel path (again)", kernel_model)):
        rates[name] = train_vit.compute_throughput(m, tp_args, device, bf16)[
            "images_per_sec"]
    fwd_ms = 128e3 / rates["eva kernel path"]
    log(f"[time] forward B=128 bf16 images/s: {json.dumps(rates)}; "
        f"eva_single share of the kernel-path forward "
        f"{12 * k2_ms / fwd_ms:.3f} (12 x {k2_ms:.4f} ms of {fwd_ms:.3f} ms);"
        f" {card}")
    # one headline forward on K2's route by op: K2's share of device busy
    # time and the device's idle share of an unprofiled forward
    xb = torch.randn(128, 224, 224, 3, generator=torch.Generator(device="cuda").manual_seed(6),
                     device="cuda").to(bf16)
    with torch.no_grad():
        kernel_model(xb)
        busy, k2_total, wall_ms, table = profile_steps(
            torch, train_vit._profiler, lambda: kernel_model(xb), "eva_single")
    log(f"[profile] one headline forward on K2's route at B=128 bf16: device busy "
        f"{busy:.3f} ms ({wall_ms:.3f} ms wall while profiled, {fwd_ms:.3f} ms a "
        f"forward unprofiled, idle share {1 - busy / fwd_ms:.3f}), eva_single "
        f"{k2_total:.3f} ms ({k2_total / busy:.3f} of busy)")
    print(table, flush=True)
    del xb
    # the tracked DeiT-tiny-p16 cell's forward images/s, kernel path (K2)
    # and eager path in turns
    p16_tp = train_vit.parse_args(P16_ARGV + ["--throughput", "--bf16"])
    p16_model = train_vit.build_model(p16_tp).to(device, bf16)
    p16_eager = set_impl(copy.deepcopy(p16_model), EVA, "xla")
    p16_rates = {}
    for name, m in (("kernel", p16_model), ("eager", p16_eager), ("eager", p16_eager),
                    ("kernel", p16_model)):
        p16_rates.setdefault(name, []).append(train_vit.compute_throughput(
            m, p16_tp, device, bf16)["images_per_sec"])
    log(f"[time] DeiT-tiny-p16 + EVA forward B=128 bf16 images/s, in turns: "
        f"{json.dumps(p16_rates)}; {card}")
    del p16_model, p16_eager

    qkv, rf, beta, bias, grad = k1_inputs(128, 28, 7, 4, 3, 64, bf16, seed=20)
    k1_args = (qkv, rf, beta, bias, 64 ** -0.5, 3, 28, 7)
    k1_ms = {
        "fwd": cuda_ms(lambda: k1._forward(*k1_args), 20),
        "fwd_cuda_cores": cuda_ms(lambda: k1._forward(*k1_args, cuda_cores=True),
                                  20),
        "bwd": cuda_ms(lambda: k1._backward(*k1_args[:4], grad,
                                            *k1_args[4:]), 10),
        "bwd_cuda_cores": cuda_ms(lambda: k1._backward(
            *k1_args[:4], grad, *k1_args[4:], cuda_cores=True), 10),
        "plain_fwd": cuda_ms(lambda: k1.eva_packed_fwd_ref(
            *k1_args[:3], *k1_args[4:], bias), 5),
        "plain_bwd": cuda_ms(lambda: k1.eva_packed_bwd_ref(
            *k1_args[:4], grad, *k1_args[4:]), 3),
    }
    k1_bounds = {"fwd": k1_bound(qkv, rf, beta, bias, 3, 7, False),
                 "bwd": k1_bound(qkv, rf, beta, bias, 3, 7, True)}
    sdpa = dict(zip(("fwd", "bwd", "fwd+bwd"),
                    sdpa_yardstick(qkv, rf, beta, bias, 3, 28, 7, grad)))
    log(f"[time] eva_packed main shape bf16 (fwd and bwd on the tensor-core "
        f"routes, *_cuda_cores on the CUDA-core routes): {json.dumps(k1_ms)} ms, "
        f"bounds "
        f"{json.dumps(k1_bounds)}, SDPA on pre-partitioned windows "
        f"{json.dumps(sdpa)} ms; {card}")
    del qkv, rf, beta, grad, kernel_model, eager_model, softmax_model
    # K11 and K12 at the headline cell's and PVT-B3's stage shapes, bf16:
    # kernel, plain version, bound, and SDPA on the windows (its output's
    # error against the plain version beside it)
    win_ms = {}
    for label, (B, H, g, d) in (("headline", (128, 3, 28, 64)),) + PVT_STAGES:
        a = win_inputs(B, H, g, g, 7, 49, d, bf16, seed=120)
        with torch.no_grad():
            lib_ms, lib_out = win_sdpa(a)
            for name, (kernel, plain) in win_calls(k11, k12, a, g, 7).items():
                win_ms[(name, label)] = {
                    "ms": cuda_ms(kernel, 20), "plain_ms": cuda_ms(plain, 3),
                    "bound": win_bound(a, 7), "library_ms": lib_ms}
            ref = k11.eva_fused_ref(*a[0], *a[2], d ** -0.5, a[3])
            lib_err = (lib_out.float() - ref.float()).abs().max().item()
        log(f"[time] eva_kernel / eva_rowmajor {label} (B={B}, {H} heads of "
            f"{d}, {g}x{g} tokens) bf16: "
            f"{json.dumps({n: t for (n, lb), t in win_ms.items() if lb == label})}"
            f"; SDPA output vs plain version max abs err {lib_err:.3e}; {card}")
        del a, lib_out, ref

    # the train step at B=128 bf16 with the recipe's mixup, cutmix, erasing
    # and drop-path, on one batch held on the card: kernel path, eager
    # path, eager, kernel; then a profile of 3 kernel-path steps by op
    from efficient_attention_torch.data.erasing import ErasingConfig
    from efficient_attention_torch.data.mixup import MixupConfig
    from efficient_attention_torch.training.optim import make_optimizer
    from efficient_attention_torch.training.train_state import (
        TrainState,
        make_vit_train_step,
    )

    step_fn = make_vit_train_step(MixupConfig(num_classes=1000), 1000,
                                  erasing_cfg=ErasingConfig(),
                                  compute_dtype=bf16)
    gen = torch.Generator(device="cuda").manual_seed(5)
    images = torch.randn(128, 224, 224, 3, generator=gen, device="cuda")
    labels = torch.randint(0, 1000, (128,), generator=gen, device="cuda")
    train_args = train_vit.parse_args(MAIN_ARGV + TRAIN_ARGV)
    states = {}
    # the kernel path (K1), K11's route and the eager path
    for path, impl in (("kernel", "auto"), ("pallas", "pallas"), ("eager", "xla")):
        m = set_impl(train_vit.build_model(train_args).cuda(), EVA, impl)
        states[path] = TrainState(m, make_optimizer(
            "adamw", m.named_parameters(), lambda step: 5e-4 * 128 / 512))

    def steps(state, n):
        for _ in range(n):
            step_fn(state, images, labels, gen)

    train_rates = {}
    for i, path in enumerate(("kernel", "pallas", "eager", "eager", "pallas",
                              "kernel")):
        steps(states[path], 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(states[path], 10)
        torch.cuda.synchronize()
        train_rates[f"{path} path ({'first' if i < 3 else 'second'})"] = (
            128 * 10 / (time.perf_counter() - t0))
    log(f"[time] train step B=128 bf16 images/s: {json.dumps(train_rates)}; "
        f"{card}")
    busy, k1_ms_total, wall_ms, table = profile_steps(
        torch, train_vit._profiler, lambda: steps(states["kernel"], 3),
        "eva_packed")
    step_ms = 128e3 / train_rates["kernel path (second)"]
    log(f"[profile] 3 kernel-path train steps: device busy {busy:.3f} ms "
        f"({busy / 3:.3f} ms a step, against {step_ms:.3f} ms a step "
        f"unprofiled: idle share {1 - busy / 3 / step_ms:.3f}; "
        f"{wall_ms:.3f} ms wall while profiled), eva_packed kernels "
        f"{k1_ms_total:.3f} ms ({k1_ms_total / busy:.3f} of busy)")
    print(table, flush=True)
    del states, images
    torch.cuda.empty_cache()

    # causal_packed at the LM's shape (B=18, T=512, 8 heads of 128, window
    # 128, chunk 8): kernels, plain versions, bounds, SDPA yardstick, in bf16
    # and in the f32 that the LM step runs (the kernels line); the f32
    # forward and backward on the split-TF32 routes and on the CUDA-core
    # kernels in turns
    k3_shape = (18, 512, 8, 128, 128, 8)
    k3_geo = (128 ** -0.5, 8, 128, 8)
    for dtype in (bf16, torch.float32):
        ops, grad = k3_inputs(*k3_shape, dtype, seed=40)
        times = {
            "fwd": cuda_ms(lambda: k3._forward(*ops, *k3_geo), 20),
            "bwd": cuda_ms(lambda: k3._backward(*ops, grad, *k3_geo), 10),
            "plain_fwd": cuda_ms(lambda: k3.causal_packed_fwd_ref(*ops, *k3_geo), 5),
            "plain_bwd": cuda_ms(lambda: k3.causal_packed_bwd_ref(*ops, grad, *k3_geo),
                                 3),
        }
        if dtype == torch.float32:
            times["fwd_cuda_cores"] = cuda_ms(
                lambda: k3._forward(*ops, *k3_geo, cuda_cores=True), 20)
            times["fwd (second)"] = cuda_ms(lambda: k3._forward(*ops, *k3_geo), 20)
            times["bwd_cuda_cores"] = cuda_ms(
                lambda: k3._backward(*ops, grad, *k3_geo, cuda_cores=True), 10)
            times["bwd (second)"] = cuda_ms(lambda: k3._backward(*ops, grad, *k3_geo), 10)
        bounds = {"fwd": k3_bound(ops[0], ops[3], 128, 8, 8, False),
                  "bwd": k3_bound(ops[0], ops[3], 128, 8, 8, True)}
        lib_ms = dict(zip(("fwd", "bwd", "fwd+bwd"), k3_sdpa(ops, grad, 8, 128, 8)))
        log(f"[time] causal_packed main shape {str(dtype)[6:]}: {json.dumps(times)} "
            f"ms, bounds {json.dumps(bounds)}, SDPA on pre-partitioned windows "
            f"{json.dumps(lib_ms)} ms; {card}")
        if dtype == torch.float32:
            k3_ms, k3_bounds, k3_sdpa_ms = times, bounds, lib_ms
        del ops, grad
    # the split-TF32 backward's tail: it takes a block a window at one block
    # an SM, so B=18 is 576 blocks, 4.36 waves of the H100's 132 SMs; B=33
    # is 1056 blocks, 8 whole waves
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops, grad = k3_inputs(33, *k3_shape[1:], torch.float32, seed=41)
    t33 = cuda_ms(lambda: k3._backward(*ops, grad, *k3_geo), 10)
    blocks = {B: B * 8 * 512 // 128 for B in (18, 33)}
    log(f"[time] causal_packed f32 backward tail: {t33:.4f} ms at B=33 ({blocks[33]} "
        f"blocks, {blocks[33] / sms:.2f} waves of {sms} SMs), {k3_ms['bwd']:.4f} ms at "
        f"B=18 ({blocks[18]} blocks, {blocks[18] / sms:.2f} waves), "
        f"{t33 * blocks[18] / blocks[33]:.4f} ms for B=18 at B=33's time a block; {card}")
    del ops, grad

    # the LM train step at B=18 x 512 bf16, dropout 0, on one batch held on
    # the card: kernel path, eager path, eager, kernel; then a profile of 3
    # kernel-path steps by op
    from efficient_attention_torch.training.lm_steps import make_lm_train_step

    lm_step = make_lm_train_step(use_adaptive=True, compute_dtype=bf16)
    lm_args = train_lm.parse_args(LM_ARGV)
    lm_batch = torch.randint(4, LM_VOCAB, (18, 513), generator=gen, device="cuda")
    lm_states = {}
    for path in ("kernel", "eager"):
        m = train_lm.build_model(lm_args, LM_VOCAB, dense_tokens=True).cuda()
        if path == "eager":
            for layer in m.decoder.layers:
                layer.self_attn.impl = "xla"
        lm_states[path] = TrainState(m, make_optimizer(
            "nag", m.named_parameters(), lambda step: 1e-3, weight_decay=0.0,
            clip_grad=0.1))

    def lm_steps(state, n):
        for _ in range(n):
            lm_step(state, lm_batch[:, :-1], lm_batch[:, 1:], gen)

    lm_rates = {}
    for i, path in enumerate(("kernel", "eager", "eager", "kernel")):
        lm_steps(lm_states[path], 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm_steps(lm_states[path], 5)
        torch.cuda.synchronize()
        lm_rates[f"{path} path ({'first' if i in (0, 1) else 'second'})"] = (
            18 * 512 * 5 / (time.perf_counter() - t0))
    log(f"[time] LM train step B=18x512 bf16 tokens/s: {json.dumps(lm_rates)}; "
        f"{card}")
    busy, k3_ms_total, wall_ms, table = profile_steps(
        torch, train_lm._profiler, lambda: lm_steps(lm_states["kernel"], 3),
        "causal_packed")
    step_ms = 18 * 512 * 1e3 / lm_rates["kernel path (second)"]
    log(f"[profile] 3 kernel-path LM train steps: device busy {busy:.3f} ms "
        f"({busy / 3:.3f} ms a step, against {step_ms:.3f} ms a step "
        f"unprofiled: idle share {1 - busy / 3 / step_ms:.3f}; "
        f"{wall_ms:.3f} ms wall while profiled), causal_packed kernels "
        f"{k3_ms_total:.3f} ms ({k3_ms_total / busy:.3f} of busy)")
    print(table, flush=True)
    del lm_states, lm_batch
    torch.cuda.empty_cache()

    # K5, K6, K7 at the cells' main shape (B=128, 28x28 tokens, 3 heads of
    # 64, 49 landmarks, 64 features, window 7, bf16): kernel, plain version,
    # bound, and for K7 SDPA on pre-partitioned windows
    a = lin_inputs(128, 28, 3, 64, 49, 64, 7, bf16, seed=60)
    lin_ms = {}
    for name, (kernel, plain) in lin_calls(k5, k6, k7, a, 3, 28, 7).items():
        lin_ms[name] = {"ms": cuda_ms(kernel, 20), "plain_ms": cuda_ms(plain, 5),
                        "bound": lin_bound(name, a, 3, 7), "library_ms": None}
    # K7 and SDPA in turns (kernel, SDPA, SDPA, kernel), and K7's device
    # time: the wrapper's host work is of the kernel's order
    k7_call = lin_calls(k5, k6, k7, a, 3, 28, 7)[k7.NAME][0]
    k7_turns = {"kernel": [], "sdpa": []}
    for which in ("kernel", "sdpa", "sdpa", "kernel"):
        k7_turns[which].append(cuda_ms(k7_call, 50) if which == "kernel"
                               else k7_sdpa(a, 3, 28, 7))
    lin_ms[k7.NAME].update(
        ms=sum(k7_turns["kernel"]) / 2, library_ms=sum(k7_turns["sdpa"]) / 2,
        turns=k7_turns, device_ms=device_ms(torch, k7_call))
    # K6's ring route in turns with the kernel it replaced at this shape (the
    # wmma kernel, forced by config=0): ring, wmma, wmma, ring
    k6_turns = {"ring": [], "wmma": []}
    for which in ("ring", "wmma", "wmma", "ring"):
        k6_turns[which].append(cuda_ms(lambda: k6.performer_attention_fused(
            a["qkv"], a["proj"], 3, config=None if which == "ring" else 0), 50))
    lin_ms[k6.NAME].update(ms=sum(k6_turns["ring"]) / 2, turns=k6_turns,
                           layout=tuple(k6.plan(128, 784, 3, 64, 64, 2)[:4]))
    log(f"[time] K5-K7 main shape bf16: {json.dumps(lin_ms)}; {card}")
    del a
    # K6 against the eager Performer, module level (dim 192, 3 heads, 64
    # features, B=128, bf16, eval), at 784 and 3136 tokens, in turns
    from efficient_attention_torch.attention.kernelized import (
        KernelizedAttention,
    )

    crossover = {}
    for side in (28, 56):
        attn = KernelizedAttention(192, 3, approx_attn_dim=64).to(device, bf16).eval()
        xs = torch.randn(128, side, side, 192, generator=gen, device="cuda").to(bf16)
        turns = {}
        for impl in ("xla", "auto", "auto", "xla"):
            attn.impl = impl
            with torch.no_grad():
                turns.setdefault(impl, []).append(cuda_ms(lambda: attn(xs), 10))
        crossover[side * side] = {"eager_ms": turns["xla"], "k6_ms": turns["auto"]}
        del attn, xs
    log(f"[time] Performer module forward, eager vs K6, B=128 bf16: "
        f"{json.dumps(crossover)}; {card}")
    # forward images/s of the three cells, kernel and eager path in turns
    cell_rates = {}
    for cell, flags in CELLS.items():
        cargs = train_vit.parse_args(CELL_ARGV + flags + ["--throughput", "--bf16"])
        km = train_vit.build_model(cargs).to(device, bf16)
        em = copy.deepcopy(km)
        for blk in em.blocks:
            blk.attn.impl = "xla"
        for path, m in (("kernel", km), ("eager", em), ("eager again", em),
                        ("kernel again", km)):
            cell_rates[f"{cell} {path}"] = train_vit.compute_throughput(
                m, cargs, device, bf16)["images_per_sec"]
        if cell == "lara":
            # one LARA-cell forward by op
            xb = torch.randn(128, 224, 224, 3, generator=gen, device="cuda").to(bf16)
            with torch.no_grad():
                busy, k5_total, wall_ms, table = profile_steps(
                    torch, train_vit._profiler, lambda: km(xb), "lara_fused")
            log(f"[profile] one LARA-cell forward at B=128 bf16: device busy "
                f"{busy:.3f} ms ({wall_ms:.3f} ms wall while profiled, "
                f"{128e3 / cell_rates['lara kernel']:.3f} ms a forward "
                f"unprofiled), lara_fused {k5_total:.3f} ms "
                f"({k5_total / busy:.3f} of busy)")
            print(table, flush=True)
            del xb
        if cell == "performer":
            # one Performer-cell forward by op: K6's share of device busy
            xb = torch.randn(128, 224, 224, 3, generator=gen, device="cuda").to(bf16)
            fwd_ms = 128e3 / cell_rates["performer kernel"]
            with torch.no_grad():
                busy, k6_total, wall_ms, table = profile_steps(
                    torch, train_vit._profiler, lambda: km(xb), "performer_fused")
            log(f"[profile] one Performer-cell forward at B=128 bf16: device busy "
                f"{busy:.3f} ms ({wall_ms:.3f} ms wall while profiled; {fwd_ms:.3f} ms a "
                f"forward unprofiled, idle share {1 - busy / fwd_ms:.3f}), "
                f"performer_fused {k6_total:.3f} ms ({k6_total / busy:.3f} of busy)")
            print(table, flush=True)
            del xb
        if cell == "local":
            # one local-cell forward by op, with the device's idle share
            xb = torch.randn(128, 224, 224, 3, generator=gen, device="cuda").to(bf16)
            fwd_ms = 128e3 / cell_rates["local kernel"]
            with torch.no_grad():
                busy, k7_total, wall_ms, table = profile_steps(
                    torch, train_vit._profiler, lambda: km(xb), "local_packed")
            log(f"[profile] one local-cell forward at B=128 bf16: device busy "
                f"{busy:.3f} ms ({wall_ms:.3f} ms wall while profiled, idle share "
                f"{1 - busy / wall_ms:.3f}; {fwd_ms:.3f} ms a forward unprofiled, "
                f"idle share {1 - busy / fwd_ms:.3f}), local_packed {k7_total:.3f} ms "
                f"({k7_total / busy:.3f} of busy)")
            print(table, flush=True)
            del xb
        del km, em
    log(f"[time] serving cells' forward B=128 bf16 images/s: "
        f"{json.dumps(cell_rates)}; {card}")

    # K8, K9 and K10's entry points at the EVA cell's shape in bf16: kernel,
    # plain version, bound; K9 and K10's attention also in turns with their
    # yardsticks, as no one library call computes either (K9: K1's forward,
    # then attn Wo + bo in one addmm; K10's: x Wqkv + bqkv in one addmm,
    # then K9; all in bf16); then the forward images/s of EVA's eval routes
    # in turns with the default K2 route and the eager path, and one
    # megakernel-route forward by op
    a = eval_inputs(128, 28, 7, 4, 3, 64, bf16, seed=95)
    wo16, bo16 = a["wo"].to(bf16), a["bo"].to(bf16)
    wqkv16, bqkv16 = a["wqkv"].to(bf16), a["bqkv"].to(bf16)
    yardsticks = {
        k1.NAME_OUT: lambda: torch.addmm(bo16, k1.eva_attention_packed(
            a["qkv"], a["rf"], a["beta"], 64 ** -0.5, 3, 28, 7, a["bias"]).view(-1, 192),
            wo16),
        k10.NAME_ATTENTION: lambda: k1.eva_attention_packed_out(
            torch.addmm(bqkv16, a["x"].view(-1, 192), wqkv16).view(128, 784, 576),
            a["rf"], a["beta"], a["wo"], a["bo"], 64 ** -0.5, 3, 28, 7, a["bias"]),
    }
    # K8 and K10a: also the first kernel (a block a strip, head and image,
    # forced) in turns with the persistent route, and K10a's yardstick:
    # x Wqkv + bqkv in one addmm, then K8 on its persistent route
    summ = (*a["adaptive"], 3, 28, 4, True)
    firsts = {
        k8.NAME: lambda: k8.eva_summaries_packed(a["qkv"], *summ, config=0),
        k10.NAME_SUMMARIES: lambda: k10.eva_summaries_from_x(
            a["x"], a["wqkv"], a["bqkv"], *summ, config=0),
    }
    sum_yardstick = lambda: k8.eva_summaries_packed(  # noqa: E731
        torch.addmm(bqkv16, a["x"].view(-1, 192), wqkv16).view(128, 784, 576), *summ)
    eval_ms = {}
    with torch.no_grad():
        for name, (kernel, plain) in eval_calls(k8, k1, k10, a, 3, 28, 7,
                                                4).items():
            eval_ms[name] = {"ms": cuda_ms(kernel, 20),
                             "plain_ms": cuda_ms(plain, 5),
                             "bound": eval_bound(name, a, 3, 7),
                             "library_ms": None}
            if name in yardsticks:
                eval_ms[name]["yardstick_ms"] = [cuda_ms(yardsticks[name], 20),
                                                 cuda_ms(yardsticks[name], 20)]
                eval_ms[name]["ms_again"] = cuda_ms(kernel, 20)
            if name in firsts:
                seq = [("first kernel", firsts[name]), ("persistent", kernel)]
                if name == k10.NAME_SUMMARIES:
                    seq.append(("addmm + K8", sum_yardstick))
                turns = {}
                for key, call in seq + seq[::-1]:
                    turns.setdefault(key, []).append(cuda_ms(call, 50))
                eval_ms[name]["turns"] = turns
    log(f"[time] K8-K10 main shape bf16 (yardstick_ms: K9's K1 forward + addmm, "
        f"K10 attention's addmm + K9, timed kernel, yardstick, yardstick, kernel; "
        f"turns: K8 and K10a's first kernel, persistent route and K10a's addmm + K8, "
        f"in turns): {json.dumps(eval_ms)}; {card}")
    del a
    route_models = {
        route: train_vit.build_model(route_args(["--throughput", "--bf16"],
                                                toggles)).to(device, bf16)
        for route, toggles in [("default K2", {})] + [
            (r, t) for r, (t, _) in EVA_ROUTES.items()]}
    route_models["eager"] = copy.deepcopy(route_models["default K2"])
    for blk in route_models["eager"].blocks:
        blk.attn.impl = "xla"
    route_rates = {}
    for route in ["default K2", "eager", *EVA_ROUTES, *reversed(list(EVA_ROUTES)),
                  "eager", "default K2"]:
        route_rates.setdefault(route, []).append(train_vit.compute_throughput(
            route_models[route], tp_args, device, bf16)["images_per_sec"])
    log(f"[time] EVA eval routes' forward B=128 bf16 images/s, in turns: "
        f"{json.dumps(route_rates)}; {card}")
    xb = torch.randn(128, 224, 224, 3, generator=gen, device="cuda").to(bf16)
    with torch.no_grad():
        route_models["two-kernel"](xb)
        busy, k1_fwd_total, wall_ms, table = profile_steps(
            torch, train_vit._profiler, lambda: route_models["two-kernel"](xb),
            "eva_packed")
    log(f"[profile] one two-kernel-route forward at B=128 bf16: device busy "
        f"{busy:.3f} ms ({wall_ms:.3f} ms wall while profiled, "
        f"{128e3 / route_rates['two-kernel'][0]:.3f} ms a forward unprofiled), "
        f"eva_packed's forward {k1_fwd_total:.3f} ms ({k1_fwd_total / busy:.3f} "
        f"of busy)")
    print(table, flush=True)
    with torch.no_grad():
        busy, (k10_total, k10a_total), wall_ms, table = profile_steps(
            torch, train_vit._profiler, lambda: route_models["megakernel"](xb),
            ("eva_eval::", "eva_eval::eva_summaries"))
    log(f"[profile] one megakernel-route forward at B=128 bf16: device busy "
        f"{busy:.3f} ms ({wall_ms:.3f} ms wall while profiled, "
        f"{128e3 / route_rates['megakernel'][0]:.3f} ms a forward unprofiled), "
        f"the two eva_mega kernels {k10_total:.3f} ms ({k10_total / busy:.3f} "
        f"of busy), K10a {k10a_total:.3f} ms ({k10a_total / busy:.3f} of busy)")
    print(table, flush=True)
    del route_models, xb
    # PVT-B3's forward images/s at B=128 bf16 on its routes and the eager
    # path, in turns on one model; then one forward on K11 by op
    pvt_tp = train_vit.parse_args(PVT_ARGV + ["--throughput", "--bf16"])
    pvt = train_vit.build_model(pvt_tp).to(device, bf16)
    pvt_rates = {}
    for impl in ["auto", "pallas", "rowmajor", "xla", "xla", "rowmajor", "pallas",
                 "auto"]:
        pvt_rates.setdefault(impl, []).append(train_vit.compute_throughput(
            set_impl(pvt, EVA, impl), pvt_tp, device, bf16)["images_per_sec"])
    log(f"[time] PVT-B3 forward B=128 bf16 images/s, in turns: "
        f"{json.dumps(pvt_rates)}; {card}")
    xb = torch.randn(128, 224, 224, 3, generator=gen, device="cuda").to(bf16)
    with torch.no_grad():
        busy, k11_total, wall_ms, table = profile_steps(
            torch, train_vit._profiler, lambda: set_impl(pvt, EVA, "pallas")(xb),
            "eva_window::")
    log(f"[profile] one PVT-B3 forward on K11 at B=128 bf16: device busy "
        f"{busy:.3f} ms ({wall_ms:.3f} ms wall while profiled, "
        f"{128e3 / pvt_rates['pallas'][0]:.3f} ms a forward unprofiled), "
        f"eva_kernel {k11_total:.3f} ms ({k11_total / busy:.3f} of busy)")
    print(table, flush=True)
    del pvt, xb
    torch.cuda.empty_cache()

    # eva_1d at the WMT encoder's shape (B=64 sentences of 32 tokens, 8 heads
    # of 64, window 8, halo 4, 8 chunks) and at long sentences (B=16, 256
    # tokens): kernel, plain version, bound, SDPA on pre-partitioned windows;
    # in f32 the split-TF32 route in turns with the CUDA-core kernel it
    # replaced (config=0: old, new, new, old), a call and on the device
    k4_ms = {}
    for label, (B, N, nh, d, ws, ext, C, bias_kind) in K4_CHECKS[:2]:
        for dtype_name in ("float32", "bfloat16"):
            qkv, rf, beta, mask, bias = k4_inputs(
                B, N, nh, d, ws, ext, C, bias_kind, getattr(torch, dtype_name),
                seed=80)
            geo = (d ** -0.5, nh, ws, ext)
            calls = {"new": lambda: k4.eva_attention_1d(qkv, rf, beta, mask, *geo,
                                                        bias=bias),
                     "old": lambda: k4.eva_attention_1d(qkv, rf, beta, mask, *geo,
                                                        bias=bias, config=0)}
            turns = ("old", "new", "new", "old") if dtype_name == "float32" else ("new",)
            with torch.no_grad():
                sdpa_ms, sdpa_out = k4_sdpa(qkv, rf, beta, mask, bias, nh, ws, ext)
                ref = k4.eva_1d_ref(qkv, rf, beta, mask, *geo, bias)
                ms, dev = {}, {}
                for key in turns:
                    ms.setdefault(key, []).append(cuda_ms(calls[key], 50))
                # the kernel's own device time (a call's CUDA-event time
                # includes the wrapper's host work where the host is slower
                # than the device)
                for key in turns:
                    dev.setdefault(key, []).append(device_ms(torch, calls[key]))
                k4_ms[f"{label} {dtype_name}"] = {
                    "ms": sum(ms["new"]) / len(ms["new"]),
                    "device_ms": sum(dev["new"]) / len(dev["new"]),
                    "turns_ms": ms, "turns_device_ms": dev,
                    "plain_ms": cuda_ms(lambda: k4.eva_1d_ref(
                        qkv, rf, beta, mask, *geo, bias), 10),
                    "bound": k4_bound(qkv, rf, beta, mask, bias, nh, ws, ext),
                    "library_ms": sdpa_ms,
                    # the yardstick computes the same function
                    "library_max_abs_err": (sdpa_out.float() - ref.float())[
                        ~mask].abs().max().item()}
    log(f"[time] eva_1d: {json.dumps(k4_ms)}; {card}")
    # the f32 encoder forward of one batch (64 x 32 tokens), kernel and
    # eager path in turns, and the generation rates of phase 5's runs
    enc_ms = {}
    with torch.no_grad():
        for path, m in (("kernel", mt_model), ("eager", mt_eager),
                        ("eager again", mt_eager), ("kernel again", mt_model)):
            enc_ms[path] = cuda_ms(lambda: m.encode(src_t), 20)
    log(f"[time] MT encoder forward f32 B={tuple(src_b.shape)} ms: "
        f"{json.dumps(enc_ms)}; {card}")
    mt_rates = {path: {
        "sentences_per_s": r["sentences"] / r["wall_s"],
        "hypothesis_tokens_per_s": r["hypothesis_tokens"] / r["wall_s"],
        "decode_steps": r["decode_steps"],
        "beam_rows_per_s": 4 * 64 * r["decode_steps"] / r["beam_s"],
        "encode_s": r["encode_s"], "beam_s": r["beam_s"], "wall_s": r["wall_s"],
        "bleu": r["bleu"]} for path, r in mt_runs.items()}
    log(f"[time] MT generation f32, 256 sentences, beam 4: "
        f"{json.dumps(mt_rates)}; {card}")
    # one batch of 64 sentences by op, with the device's idle share
    one_batch = generate.parse_args(MT_ARGV[:-4] + ["--gen-subset-size", "64",
                                                    "--device", "cuda"])
    generate.translate(one_batch, mt_model, torch.device("cuda"))  # warm
    busy, k4_total, wall_ms, table = profile_steps(
        torch, train_lm._profiler,
        lambda: generate.translate(one_batch, mt_model, torch.device("cuda")),
        "eva_1d")
    log(f"[profile] one MT batch (64 sentences, beam 4, f32): device busy "
        f"{busy:.3f} ms of {wall_ms:.3f} ms wall (idle share "
        f"{1 - busy / wall_ms:.3f}: the Python-stepped beam loop is bound by "
        f"the host), eva_1d {k4_total:.3f} ms ({k4_total / busy:.4f} of busy)")
    print(table, flush=True)
    del mt_model, mt_eager
    torch.cuda.empty_cache()

    # ---- 9. the kernels line, the card line, the result
    kernels = [{
        "name": k2.NAME, "route": "cuda", "source": k2.SOURCE,
        "replaces": k2.REPLACES, "launches": launches,
        "max_abs_err": errors["main bf16"], "ms": k2_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]
    for part, replaces, out_name in (("fwd", k1.REPLACES_FWD, "out"),
                                     ("bwd", k1.REPLACES_BWD, None)):
        name = f"{k1.NAME}_{part}"
        err = (k1_errors[("main bf16", out_name)] if out_name else
               max(k1_errors[("main bf16", n)]
                   for n in ("dqkv", "drf", "dbeta", "dbias")))
        kernels.append({
            "name": name, "route": "cuda", "source": k1.SOURCE,
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": err, "ms": k1_ms[part],
            "plain_ms": k1_ms[f"plain_{part}"], "bound_ms": k1_bounds[part][0],
            "bound_by": k1_bounds[part][1], "library_ms": sdpa[part],
        })
    for part, replaces, names in (
            ("fwd", k3.REPLACES_FWD, ("out",)),
            ("bwd", k3.REPLACES_BWD, ("dq", "dk", "dv", "drf", "dbeta", "dbias"))):
        name = f"{k3.NAME}_{part}"
        kernels.append({
            "name": name, "route": "cuda", "source": k3.SOURCE,
            "replaces": replaces, "launches": lm_launches[name],
            "max_abs_err": max(k3_errors[("main f32", n)] for n in names),
            "ms": k3_ms[part], "plain_ms": k3_ms[f"plain_{part}"],
            "bound_ms": k3_bounds[part][0], "bound_by": k3_bounds[part][1],
            "library_ms": k3_sdpa_ms[part],
        })
    t = k4_ms["recipe float32"]
    kernels.append({
        "name": k4.NAME, "route": "cuda", "source": k4.SOURCE,
        "replaces": k4.REPLACES, "launches": mt_launches,
        "max_abs_err": k4_errors[("recipe", "float32", "f32 route")], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1], "library_ms": t["library_ms"],
    })
    for k in (k5, k6, k7):
        t = lin_ms[k.NAME]
        kernels.append({
            "name": k.NAME, "route": "cuda", "source": k.SOURCE,
            "replaces": k.REPLACES, "launches": cell_launches[k.NAME],
            "max_abs_err": lin_errors[(k.NAME, "main bf16")], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
        })
    for name, source, replaces, route in (
            (k8.NAME, k8.SOURCE, k8.REPLACES, "summaries"),
            (k1.NAME_OUT, k1.SOURCE_OUT, k1.REPLACES_OUT, "fused-out"),
            (k10.NAME_SUMMARIES, k10.SOURCE, k10.REPLACES_SUMMARIES, "megakernel"),
            (k10.NAME_ATTENTION, k10.SOURCE, k10.REPLACES_ATTENTION, "megakernel")):
        t = eval_ms[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": route_launches[route][name],
            "max_abs_err": eval_errors[(name, "main bf16")], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
        })
    for k, launches_run in ((k11, pvt_launches["pallas"]),
                            (k12, pvt_launches["rowmajor"])):
        t = win_ms[(k.NAME, "headline")]
        kernels.append({
            "name": k.NAME, "route": "cuda", "source": k.SOURCE,
            "replaces": k.REPLACES, "launches": launches_run,
            "max_abs_err": win_errors[(k.NAME, "main bf16")], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
        })
    log(f"[launches] lara_fused on its cluster route in the LARA cell's 4-batch "
        f"eval: {lara_mma} of {cell_launches[k5.NAME]}; checks {json.dumps(k5_errors)}")
    log(f"[launches] performer_fused on its ring route in the Performer cell's 4-batch "
        f"eval: {performer_ring} of {cell_launches[k6.NAME]}; checks "
        f"{json.dumps(k6_errors)}")
    log(f"[launches] K8 and K10a on their persistent route in the 4-batch evals: "
        f"{json.dumps(route_sum_mma)} (48 a route); checks "
        f"{json.dumps({f'{n} {l}': e for (n, l), e in sum_errors.items()})} (error / peak)")
    log(f"[launches] K9 and K10's attention on their tensor-core route in the "
        f"4-batch evals: {json.dumps(route_out_mma)} (48 a route); checks "
        f"{json.dumps({f'{n} {l} bias={b}': e for (n, l, b), e in out_errors.items()})}")
    log(f"[launches] eva_packed forward on the tensor-core route: training "
        f"{fwd_mma_launches} of {train_launches['eva_packed_fwd']}, EVA eval "
        f"routes {json.dumps(route_fwd_mma)} (48 a route)")
    log(f"[launches] eva_single on the tensor-core route: headline serving "
        f"{launches_mma} of {launches}, DeiT-tiny-p16 serving {p16_launches[1]} of "
        f"{p16_launches[0]}, PVT-B3 `auto` {pvt_k2_mma} of {pvt_launches['auto']}, "
        f"the megakernel-alone route {route_launches['megakernel alone']}; checks "
        f"{json.dumps(k2_errors)}")
    serve_win = {r: route_launches[r] for r in ("pallas", "rowmajor")}
    log(f"[launches] K11 and K12's paths: headline serving "
        f"{json.dumps(serve_win)}, headline "
        f"training {json.dumps(win_train)}, PVT-B3 serving "
        f"{json.dumps(pvt_launches)}, auto fallback errors "
        f"{json.dumps(fb_errors)}, PVT-B3 f32 logits errors "
        f"{json.dumps(pvt_errors)}")
    print(json.dumps({"kernels": kernels}))
    log(f"[wall] chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's process set-up and its data-parallel CLIs, on the CPU.

Bootstrap: the distributed flags (JAX's names) and ``torchrun``'s
environment join a gloo group, a run without either joins none, and a
world without a coordinator, a rank outside the world or a mesh the world
does not divide raise.  Then gloo ranks (``_torch_dist.py``, float32, zero
RF noise, dropout 0 where trajectories are compared):

* ``train_mt`` (joined by its flags) and ``train_lm`` (joined by
  ``torchrun``'s environment) on 2 ranks on dummy data, whose ranks hold
  different token counts: every step's loss and gradient norm within 1e-6
  relative, and the final parameters within 1e-5, of the single-process run
  at the same global batch; validation reduced over the ranks;
* a 2-rank ``train_lm`` resumed after 2 updates equals a straight run of 4
  bit for bit; rank 1 writes no file; a rank that reaches a checkpoint
  save a second after rank 0 saves too;
* the ViT eval sharded over a split that 2 does not divide scores every
  image once, as one process does; beam search with the sentences split
  over the ranks returns every row of the single-process search, in order;
  ``dryrun_multichip(2)`` runs gates 1 and 5; and a one-process ViT
  checkpoint resumed at ``--mesh-model 2`` with drop path leaves the two
  model ranks, which share their rows, with the same generator state.
"""
import argparse
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist import run_ranks, zero_noise
from _torch_port import exact_float32
from efficient_attention_torch.cli import train_lm, train_mt, train_vit
from efficient_attention_torch.parallel import (
    add_distributed_args,
    init_distributed,
    init_distributed_from_args,
    is_primary,
    local_rows,
)
from efficient_attention_torch.parallel.distributed import free_port
from efficient_attention_torch.training.checkpoint import CheckpointManager


@pytest.fixture(autouse=True)
def _f32_zero_noise(monkeypatch):
    zero_noise(monkeypatch.setattr)
    with exact_float32():
        yield


def test_flags_and_torchrun_environment(monkeypatch):
    parser = add_distributed_args(argparse.ArgumentParser())
    args = parser.parse_args(["--distributed", "--coordinator-address",
                              "localhost:1234", "--num-processes", "4",
                              "--process-id", "3"])
    assert (args.distributed, args.coordinator_address, args.num_processes,
            args.process_id) == (True, "localhost:1234", 4, 3)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    plain = argparse.Namespace(distributed=False, device="cpu")
    assert not init_distributed_from_args(plain) and not dist.is_initialized()
    assert is_primary()
    with pytest.raises(ValueError, match="coordinator-address"):
        init_distributed(num_processes=2, process_id=0, device_type="cpu")
    with pytest.raises(ValueError, match="outside a world"):
        init_distributed("localhost:1", 2, 2, device_type="cpu")
    # torchrun's environment alone joins a group, here of one process
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    try:
        assert init_distributed_from_args(plain)
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert is_primary()
        from efficient_attention_torch.parallel import make_mesh

        mesh = make_mesh(device_type="cpu")
        batch = torch.arange(6)
        assert torch.equal(local_rows(batch, mesh, 2), batch)
        with pytest.raises(ValueError, match="world of 1 devices"):
            make_mesh(fsdp=2, device_type="cpu")
    finally:
        dist.destroy_process_group()


class _Axis:
    def __init__(self, rank, size):
        self.rank, self.n = rank, size

    def get_local_rank(self):
        return self.rank

    def size(self):
        return self.n


@pytest.mark.parametrize("microbatches", [1, 2])
def test_local_rows_are_blocks_of_each_microbatch(microbatches):
    """Rank (d, f) of data x fsdp = 2 x 2 keeps block 2d + f of each
    microbatch; ranks differing only in model keep the same rows."""
    batch = torch.arange(16)
    seen = []
    for d in range(2):
        for f in range(2):
            mesh = {"data": _Axis(d, 2), "fsdp": _Axis(f, 2)}
            rows = local_rows(batch, mesh, microbatches)
            block = 2 * d + f
            want = torch.cat([c.chunk(4)[block]
                              for c in batch.chunk(microbatches)])
            assert torch.equal(rows, want)
            seen.append(rows)
    assert sorted(torch.cat(seen).tolist()) == list(range(16))
    with pytest.raises(ValueError, match="does not split"):
        local_rows(torch.arange(6), {"data": _Axis(0, 2), "fsdp": _Axis(0, 2)})


MT_ARGV = [
    "--dummy-data", "--dummy-vocab", "120", "--encoder-embed-dim", "24",
    "--encoder-ffn-embed-dim", "48", "--encoder-layers", "1",
    "--decoder-layers", "1", "--encoder-attention-heads", "2",
    "--attn-name-encoder", "eva", "--encoder-attn-window-size", "8",
    "--encoder-attn-num-landmarks", "8", "--encoder-attn-overlap-window",
    "--encoder-attn-use-t5-rpe", "--encoder-attn-adaptive-proj", "no-ln",
    "--attn-name-decoder", "causal_eva", "--decoder-attn-window-size", "16",
    "--decoder-attn-chunk-size", "8", "--decoder-attn-adaptive-proj", "qk",
    "--decoder-attn-causal", "--share-all-embeddings", "--device", "cpu",
    "--max-tokens", "4096", "--batch-size", "8", "--update-freq", "2",
    "--dropout", "0", "--max-update", "3", "--validate-interval-updates", "3",
    "--eval-bleu", "--eval-bleu-args", '{"beam": 2, "lenpen": 0.6}',
    "--eval-bleu-subset-size", "12", "--save-interval-updates", "3",
]
LM_ARGV = [
    "--dummy-data", "--dummy-vocab", "200", "--tokens-per-sample", "32",
    "--max-tokens", "128", "--decoder-embed-dim", "32",
    "--decoder-ffn-embed-dim", "64", "--decoder-layers", "1",
    "--decoder-attention-heads", "2", "--warmup-updates", "2",
    "--update-freq", "2", "--seed", "7", "--device", "cpu",
]


def _trajectory(module, name, run):
    from _torch_dist import _recording

    log = []
    saved = getattr(module, name)
    _recording(module, name, log)
    try:
        stats = run()
    finally:
        setattr(module, name, saved)
    return log, stats


def _final_params(directory):
    return CheckpointManager(os.path.join(directory, "ckpt")).load()["params"]


@pytest.mark.timeout(300)
def test_train_mt_and_train_lm_on_two_ranks_match_one_process(tmp_path):
    from efficient_attention_torch.training import lm_steps

    ranks = tmp_path / "ranks"
    mt_argv = MT_ARGV + ["--save-dir", str(ranks / "mt")]
    lm_argv = LM_ARGV + ["--dropout", "0.0", "--max-update", "3",
                         "--save-interval-updates", "3",
                         "--save-dir", str(ranks / "lm")]
    resume_argv = LM_ARGV + ["--dropout", "0.1", "--save-interval-updates", "2"]
    out = run_ranks(2, "text_cli_runs", str(ranks), mt_argv, lm_argv,
                    resume_argv, timeout=240)
    assert out[1]["writes"] == [], out[1]["writes"]
    got = out[0]
    one = tmp_path / "one"
    for name, cli, factory, argv in (
            ("mt", train_mt, "make_mt_train_step", MT_ARGV),
            ("lm", train_lm, "make_lm_train_step",
             lm_argv[:-1] + [str(one / "lm")])):
        argv = [a if a != str(ranks / "mt") else str(one / "mt") for a in argv]
        if name == "mt":
            argv = argv + ["--save-dir", str(one / "mt")]
        log, stats = _trajectory(lm_steps, factory,
                                 lambda: cli.main(cli.parse_args(argv)))
        # the LM log goes on with the resume runs
        assert len(log) == 3 and len(got["logs"][name]) >= 3
        np.testing.assert_allclose(got["logs"][name][:3], log, rtol=1e-6)
        assert got[name]["step"] == stats["step"] == 3
        for k in ("valid_loss",):
            np.testing.assert_allclose(got[name][k], stats[k], rtol=1e-6)
        if name == "mt":
            np.testing.assert_allclose(got[name]["valid_bleu"],
                                       stats["valid_bleu"], rtol=1e-6)
        want = _final_params(str(one / name))
        for k, v in _final_params(str(ranks / name)).items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                       err_msg=f"{name}: {k}")
    # the 2-rank resume is bit for bit
    assert got["first"]["step"] == 2
    assert got["resumed"]["loss"] == got["straight"]["loss"]
    assert got["resumed"]["valid_loss"] == got["straight"]["valid_loss"]
    a, b = _final_params(str(ranks / "a")), _final_params(str(ranks / "b"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    saved = CheckpointManager(str(ranks / "b" / "ckpt")).load()
    assert len(saved["rng"]["generators"]) == 2
    # a rank that reaches a save late takes rank 0's decision
    assert [r["late_save"] for r in out] == [True, True]


@pytest.mark.timeout(300)
def test_sharded_eval_generate_and_dryrun_on_two_ranks(tmp_path):
    from efficient_attention_torch.data.imagenet import SyntheticImageDataset
    from efficient_attention_torch.parallel.dryrun import (
        beam_generate,
        mt_gate_model,
    )

    vit_argv = ["--model", "evit_tiny_p16", "--attn-name", "eva",
                "--attn-window-size", "2", "--attn-num-landmarks", "4",
                "--attn-attn-2d", "--attn-use-rpe", "--input-size", "64",
                "--depth", "1", "--num-classes", "10", "--batch-size", "2",
                "--num-workers", "1", "--device", "cpu"]
    rng = np.random.default_rng(4)
    src = rng.integers(4, 67, (4, 12)).astype(np.int64)
    src[1, 9:] = 1  # a padded sentence
    src[3, 6:] = 1
    # a one-process epoch with drop path, then its second epoch resumed on
    # 2 ranks at --mesh-model 2, whose ranks share rows and must draw alike
    run = vit_argv + ["--num-heads", "4", "--drop-path", "0.1",
                      "--max-steps-per-epoch", "1", "--output-dir",
                      str(tmp_path / "vit")]
    train_vit.main(train_vit.parse_args(run + ["--epochs", "1"]))
    resume_argv = run + ["--epochs", "2", "--mesh-model", "2", "--resume",
                         str(tmp_path / "vit" / "ckpt")]
    out = run_ranks(2, "eval_and_generate", vit_argv, 7, src, resume_argv,
                    timeout=240)
    args = train_vit.parse_args(vit_argv)
    data = SyntheticImageDataset(num_samples=7, img_size=64, num_classes=10,
                                 train=False)
    want = train_vit.evaluate(train_vit.build_model(args), data, args,
                              torch.device("cpu"), torch.float32)
    tokens, scores = beam_generate(mt_gate_model(), torch.from_numpy(src))
    for r, o in enumerate(out):
        assert o["eval"]["images"] == 7
        for k in ("acc1", "acc5", "loss"):
            np.testing.assert_allclose(o["eval"][k], want[k], rtol=1e-6)
        assert torch.equal(o["tokens"], tokens), r
        np.testing.assert_allclose(o["scores"].numpy(), scores.numpy(),
                                   rtol=1e-5)
        assert np.isfinite(o["dryrun"]["gate1"]["loss"])
        assert o["dryrun"]["gate1"]["mesh"] == {"data": 1, "fsdp": 2,
                                                "model": 1, "seq": 1}
        assert o["dryrun"]["gate5"]["tokens"][:2] == (2, 2)
    first = CheckpointManager(str(tmp_path / "vit" / "ckpt")).load(1)
    saved = CheckpointManager(str(tmp_path / "vit" / "ckpt")).load()
    states = saved["rng"]["generators"]
    assert saved["step"] == 2 and len(states) == 2
    assert torch.equal(states[0], states[1])
    assert not torch.equal(states[0], first["rng"]["generator"])


def test_num_heads_flag_builds_the_model():
    """``--num-heads`` overrides the arch's heads (the JAX factory's
    ``_evit`` raises a TypeError on it; ROADMAP.md Queue 3), as the mesh's
    tensor parallelism needs heads that ``--mesh-model`` divides."""
    args = train_vit.parse_args(["--model", "evit_tiny_p16", "--num-heads", "4",
                                 "--input-size", "64", "--depth", "1",
                                 "--device", "cpu"])
    model = train_vit.build_model(args)
    assert model.blocks[0].attn.num_heads == 4
    assert model.blocks[0].attn.head_dim == 48

"""Gloo ranks on the CPU for the port's multi-process tests
(``test_torch_parallel.py``, ``test_torch_distributed.py``), spawned as
``tests/test_distributed.py`` spawns JAX's: one OS process a rank, each
running a worker function of this module, which imports torch and the port
but no JAX.  A worker returns what the test compares; ``run_ranks`` hands
back each rank's result, or raises with the output of a rank that failed,
and kills every rank it started.

Each worker works in float32 with TF32 off, at one thread a rank, and sets
EVA's RF sample to its mean and causal EVA's proposal noise to zero
(``zero_noise``: the sharded step equals the unsharded one only where the
step draws nothing).  A rank other than 0 records every write it
makes under the run's directory (``_watch_writes``): it must make none.
"""
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def zero_noise(patch) -> None:
    """``patch(cls, name, fn)`` the training noise of EVA (its RF sample
    becomes its mean) and of causal EVA (its proposal noise zero)."""
    import torch

    from efficient_attention_torch.attention.causal_eva import CausalEVAttention
    from efficient_attention_torch.attention.eva import EVA

    patch(EVA, "_sample_weights", lambda self, mu: mu)
    patch(CausalEVAttention, "_proposal_noise",
          lambda self, shape, like: torch.zeros(shape, dtype=like.dtype,
                                                device=like.device))


def shared_port(tag: str) -> int:
    """A free port for a process group's store: rank 0 picks it just before
    it binds it and hands it to the other ranks through the run's directory.
    A port picked long before its use may be taken by then, since every
    gloo group binds ports of its own."""
    from efficient_attention_torch.parallel.distributed import free_port

    path = os.path.join(_RUN["out"], f"port.{tag}")
    if _RUN["rank"] == 0:
        with open(path + ".tmp", "w") as f:
            f.write(str(free_port()))
        os.replace(path + ".tmp", path)
    deadline = time.monotonic() + 120
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank 0 published no port {tag!r}")
        time.sleep(0.01)
    with open(path) as f:
        return int(f.read())


# this rank's number and the run's directory, set by ``_main``
_RUN: dict = {}


def run_ranks(world: int, target: str, *args, timeout: float = 240.0):
    """Run ``target(rank, world, *args)`` in ``world`` processes and return
    their results in rank order.  A rank that fails, or a run past
    ``timeout`` seconds, kills every rank and raises with their output."""
    import torch

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([ROOT, HERE, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory() as out:
        torch.save(args, os.path.join(out, "args.pt"))
        logs = [os.path.join(out, f"rank{rank}.log") for rank in range(world)]
        procs = []
        try:
            for rank in range(world):
                with open(logs[rank], "wb") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-c",
                         "import _torch_dist; _torch_dist._main()",
                         out, str(rank), str(world), target],
                        stdout=f, stderr=subprocess.STDOUT, env=env))
            deadline = time.monotonic() + timeout
            while (any(p.poll() is None for p in procs)
                   and not any(p.returncode for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode]
        if failed:
            tails = "".join(
                f"--- rank {r} ({procs[r].returncode}):\n"
                + open(logs[r], "rb").read()[-6000:].decode(errors="replace")
                for r in range(world))
            raise AssertionError(f"rank(s) {failed} of {world} failed or ran "
                                 f"past {timeout} s:\n{tails}")
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def _main() -> None:
    import torch

    out, rank, world, target = sys.argv[1:5]
    _RUN.update(out=out, rank=int(rank))
    args = torch.load(os.path.join(out, "args.pt"), weights_only=False)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    zero_noise(lambda cls, name, fn: setattr(cls, name, fn))
    try:
        module, _, name = target.rpartition(":")
        fn = getattr(__import__(module), name) if module else globals()[name]
        result = fn(int(rank), int(world), *args)
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


def _init(rank: int, world: int) -> None:
    from efficient_attention_torch.parallel import init_distributed

    init_distributed(f"127.0.0.1:{shared_port('init')}", world, rank,
                     device_type="cpu")


def _watch_writes(rank: int, directory: str) -> list:
    """On a rank other than 0, the writes this process makes under
    ``directory`` from now on (files opened to write, directories made,
    files moved or removed), as they happen."""
    seen: list = []
    if rank == 0:
        return seen
    root = os.path.realpath(directory)
    events = {"os.mkdir", "os.rename", "os.replace", "os.remove",
              "shutil.rmtree", "os.rmdir"}

    def hook(event, args):
        if event == "open" and args and isinstance(args[0], (str, bytes)):
            mode = args[1] if len(args) > 1 and isinstance(args[1], str) else ""
            flags = args[2] if len(args) > 2 and isinstance(args[2], int) else 0
            writing = any(c in mode for c in "wax+") or flags & (
                os.O_WRONLY | os.O_RDWR | os.O_CREAT)
            path = os.fsdecode(args[0])
        elif event in events and args and isinstance(args[0], (str, bytes, os.PathLike)):
            writing, path = True, os.fsdecode(args[0])
        else:
            return
        if writing and os.path.realpath(path).startswith(root):
            seen.append((event, path))

    sys.addaudithook(hook)
    return seen


# ---------------------------------------------------------------- workers --


def _vit(heads: int, sd):
    from efficient_attention_torch.models.efficient_vit import EfficientTransformer

    model = EfficientTransformer(
        attn_name="eva", attn_args={"window_size": 2, "num_landmarks": 4,
                                    "attn_2d": True, "use_rpe": True,
                                    "adaptive_proj": "default"},
        img_size=64, patch_size=16, embed_dim=16 * heads, depth=2,
        num_heads=heads, num_classes=16, drop_path_rate=0.0)
    model.load_state_dict(sd, strict=True)
    return model


def _vit_state(model, sharding, lr: float = 1e-3, warmup: int = 10):
    from efficient_attention_torch.training.optim import (
        cosine_schedule,
        make_optimizer,
    )
    from efficient_attention_torch.training.train_state import TrainState

    schedule = cosine_schedule(lr, warmup_steps=warmup, total_steps=100)
    opt = make_optimizer("adamw", model.named_parameters(), schedule,
                         weight_decay=0.05, clip_grad=5.0)
    return TrainState(model if sharding is None else sharding.model, opt,
                      ema_decay=0.9, sharding=sharding)


def vit_trajectory(model, sharding, images, labels, accum_steps: int = 1):
    """3 steps of the ViT train step (no mixup, no erasing): losses,
    gradient norms, and the state."""
    import torch

    from efficient_attention_torch.parallel import local_rows
    from efficient_attention_torch.training.train_state import make_vit_train_step

    mesh = None if sharding is None else sharding.mesh
    state = _vit_state(model, sharding)
    step = make_vit_train_step(None, num_classes=16, label_smoothing=0.1,
                               accum_steps=accum_steps)
    losses, norms = [], []
    for x, y in zip(images, labels):
        x, y = torch.from_numpy(x), torch.from_numpy(y).long()
        m = step(state, local_rows(x, mesh, accum_steps),
                 local_rows(y, mesh, accum_steps), None)
        losses.append(float(m.loss))
        norms.append(float(m.grad_norm))
    return losses, norms, state


def gate1(rank, world, data, single_ckpt, out_dir):
    """The 4-rank ``fsdp=2 x model=2`` ViT steps at 4 heads (attention
    head-parallel) and 3 heads (attention replicated), each saved through
    the checkpoint manager; then the single-process checkpoint loaded into
    the sharded state and gathered back."""
    from efficient_attention_torch.parallel import make_mesh, shard_model
    from efficient_attention_torch.parallel.distributed import generator_states
    from efficient_attention_torch.training.checkpoint import CheckpointManager

    import torch

    _init(rank, world)
    mesh = make_mesh(fsdp=2, model=2, device_type="cpu")
    writes = _watch_writes(rank, out_dir)
    out = {}
    for heads in (4, 3):
        d = data[heads]
        sharding = shard_model(_vit(heads, d["sd"]), mesh)
        losses, norms, state = vit_trajectory(sharding.module, sharding,
                                              d["images"], d["labels"])
        full = state.state_dict()
        gen = torch.Generator().manual_seed(rank)
        CheckpointManager(os.path.join(out_dir, f"h{heads}")).save(
            state.step, dict(full, rng=generator_states(gen)))
        loaded = {}
        if heads == 4:
            saved = CheckpointManager(single_ckpt).load()
            state.load_state_dict(saved)
            loaded = state.state_dict()
        out[heads] = {"losses": losses, "norms": norms, "log": sharding.log,
                      "params": full["params"], "ema": full["ema_params"],
                      "loaded": loaded}
    # tensor parallelism without FSDP would leave the data replicas
    # unreduced
    try:
        shard_model(_vit(4, data[4]["sd"]), make_mesh(model=2, device_type="cpu"),
                    use_fsdp=False, use_tp=True)
    except ValueError as e:
        out["tp_without_fsdp"] = str(e)
    out["writes"] = list(writes)
    return out if rank == 0 else {"writes": out["writes"]}


OPTIMIZERS = ("adamw", "adam", "nag", "sgd", "adafactor", "adagrad",
              "adadelta", "adamax", "lamb")


def toy_model(sd=None):
    """A model whose first weight adafactor factors (256 x 128) and whose
    last one FSDP splits unevenly over 2 ranks (5 rows)."""
    import torch
    from torch import nn

    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(128, 256), nn.LayerNorm(256), nn.GELU(),
                          nn.Linear(256, 5))
    if sd is not None:
        model.load_state_dict(sd)
    return model


def optimizer_run(name, model, sharding, xs, ys):
    """3 steps of optimizer ``name`` (clip 0.5, weight decay 0.05) on a
    squared error; the final parameters and optimizer state, whole."""
    import torch

    from efficient_attention_torch.parallel import local_rows
    from efficient_attention_torch.training.optim import make_optimizer

    mesh = None if sharding is None else sharding.mesh
    opt = make_optimizer(name, model.named_parameters(), lambda s: 1e-2,
                         weight_decay=0.05, clip_grad=0.5, momentum=0.9)
    train = model if sharding is None else sharding.model
    for x, y in zip(xs, ys):
        opt.zero_grad()
        x, y = (local_rows(torch.from_numpy(a), mesh) for a in (x, y))
        ((train(x) - y) ** 2).mean().backward()
        opt.step()
    if sharding is None:
        return model.state_dict(), opt.state_dict()
    return sharding.state_dict(), opt.state_dict(full=sharding.full)


def ddp_and_optimizers(rank, world, vit, toy):
    """2 ranks: the ViT step under DDP with 2 microbatches; mixup on each
    rank's rows; every optimizer at ``fsdp=2``."""
    import torch

    from efficient_attention_torch.data.mixup import MixupConfig, apply_mixup
    from efficient_attention_torch.parallel import local_rows, make_mesh, shard_model
    from efficient_attention_torch.parallel.distributed import rank_seed

    _init(rank, world)
    mesh = make_mesh(device_type="cpu")
    sharding = shard_model(_vit(4, vit["sd"]), mesh)
    losses, norms, state = vit_trajectory(sharding.module, sharding,
                                          vit["images"], vit["labels"],
                                          accum_steps=2)
    full = state.state_dict()
    out = {"losses": losses, "norms": norms, "params": full["params"],
           "ema": full["ema_params"], "kind": sharding.log}
    # mixup flips this rank's rows: labels are the global row indices
    rows = local_rows(torch.arange(8), mesh)
    gen = torch.Generator().manual_seed(rank_seed(3, mesh))
    cfg = MixupConfig(mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.0,
                      num_classes=8)
    pairs = []
    for _ in range(4):
        _, targets = apply_mixup(torch.zeros(len(rows), 8, 8, 3), rows, cfg, gen)
        pairs.append([sorted(torch.nonzero(t > 0).flatten().tolist())
                      for t in targets])
    out["mixup"] = {"rows": rows.tolist(), "pairs": pairs}
    fsdp_mesh = make_mesh(fsdp=2, device_type="cpu")
    out["optim"] = {}
    for name in OPTIMIZERS:
        model = toy_model(toy["sd"])
        out["optim"][name] = optimizer_run(
            name, model, shard_model(model, fsdp_mesh), toy["x"], toy["y"])
    return out


def _recording(module, name: str, log: list):
    """Wrap ``module.name`` (a train-step factory) so that every step's
    loss and gradient norm are appended to ``log`` in full precision."""
    make = getattr(module, name)

    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def run(*sa, **skw):
            m = step(*sa, **skw)
            log.append((float(m.loss), float(m.grad_norm)))
            return m

        return run

    setattr(module, name, wrapped)


def text_cli_runs(rank, world, tmp, mt_argv, lm_argv, resume_argv):
    """2 ranks: ``train_mt`` joined by its flags, ``train_lm`` by
    ``torchrun``'s environment, each on the global batch of the
    single-process run; then ``train_lm`` resumed (2 + 2 updates) beside a
    straight run of 4, all by their flags; each call joins and leaves its
    own process group.  Last, a checkpoint save that rank 1 reaches a
    second after rank 0."""
    from efficient_attention_torch.cli import train_lm, train_mt
    from efficient_attention_torch.training import lm_steps

    writes = _watch_writes(rank, tmp)
    logs = {"mt": [], "lm": []}
    _recording(lm_steps, "make_mt_train_step", logs["mt"])
    _recording(lm_steps, "make_lm_train_step", logs["lm"])
    flags = ["--distributed", "--num-processes", str(world),
             "--process-id", str(rank)]
    out = {"mt": train_mt.main(train_mt.parse_args(
        mt_argv + flags + ["--coordinator-address",
                           f"127.0.0.1:{shared_port('mt')}"]))}
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(shared_port("lm")))
    out["lm"] = train_lm.main(train_lm.parse_args(lm_argv))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        del os.environ[k]
    for run, (save, updates) in zip(("straight", "first", "resumed"),
                                    (("a", 4), ("b", 2), ("b", 4))):
        out[run] = train_lm.main(train_lm.parse_args(resume_argv + flags + [
            "--coordinator-address", f"127.0.0.1:{shared_port(run)}", "--max-update",
            str(updates), "--save-dir", os.path.join(tmp, save)]))
    # a save that rank 1 reaches late, when rank 0 could have written the
    # step already: each rank decides on the steps on disk before it does
    import torch
    import torch.distributed as dist

    from efficient_attention_torch.training.checkpoint import CheckpointManager

    _init(rank, world)
    if rank:
        time.sleep(1.0)
    late = CheckpointManager(os.path.join(tmp, "late"))
    out["late_save"] = late.save(1, {"x": torch.zeros(1)})
    dist.destroy_process_group()
    out["logs"] = logs
    out["writes"] = list(writes)
    return out


def eval_and_generate(rank, world, vit_argv, n_images, src, resume_argv):
    """2 ranks: the ViT CLI's eval sharded over a split of ``n_images`` that
    2 does not divide; beam search with the sentences split over the
    ranks; the dry run's gates 1 and 5; and the ViT CLI at ``--mesh-model
    2`` resumed from a one-process checkpoint (``resume_argv``)."""
    import torch

    from efficient_attention_torch.cli import train_vit
    from efficient_attention_torch.data.imagenet import SyntheticImageDataset
    from efficient_attention_torch.parallel import make_mesh, shard_model
    from efficient_attention_torch.parallel.dryrun import (
        dryrun_multichip,
        mt_gate_model,
        sharded_generate,
    )

    _init(rank, world)
    args = train_vit.parse_args(vit_argv)
    mesh = make_mesh(device_type="cpu")
    sharding = shard_model(train_vit.build_model(args), mesh)
    data = SyntheticImageDataset(num_samples=n_images, img_size=args.input_size,
                                 num_classes=args.num_classes, train=False)
    stats = train_vit.evaluate(sharding.module.eval(), data, args,
                               torch.device("cpu"), torch.float32, sharding)
    tokens, scores = sharded_generate(mt_gate_model(), torch.from_numpy(src),
                                      mesh)
    out = {"eval": stats, "tokens": tokens, "scores": scores,
           "dryrun": dryrun_multichip(world)}
    train_vit.main(train_vit.parse_args(resume_argv))
    return out

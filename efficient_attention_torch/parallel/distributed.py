"""Process set-up for multi-process runs on ``torch.distributed``.

Counterpart of ``efficient_attention_tpu/parallel/distributed.py``.  JAX
initialises one distributed runtime after which every process runs the
same program on the global device list; the port starts one process a
device, each joined to the default process group:

* ``init_distributed`` creates the group from the CLI's flags (JAX's
  names) or, failing them, from ``torchrun``'s environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL on
  ``cuda:LOCAL_RANK`` for a CUDA device, gloo on the CPU.  A run without
  ``--distributed`` and without ``torchrun``'s environment creates no
  group;
* ``local_rows`` stands in for ``put_batch``: every process holds the global
  batch and keeps its own rows, the contiguous block of its
  ``(data, fsdp)`` coordinate, as ``mesh.batch_spec()`` shards them;
* ``is_primary`` gates logging and writing to rank 0.
"""
from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist


def add_distributed_args(parser):
    """The JAX CLI's distributed flags (``fairseq/distributed/utils.py``'s
    env handling); ``torchrun``'s environment fills what they leave out."""
    g = parser.add_argument_group("distributed")
    g.add_argument("--distributed", action="store_true", default=False,
                   help="join a torch.distributed process group (NCCL on "
                        "CUDA, gloo on the CPU)")
    g.add_argument("--coordinator-address", default=None, type=str,
                   help="host:port of rank 0 (env MASTER_ADDR:MASTER_PORT)")
    g.add_argument("--num-processes", default=None, type=int,
                   help="world size (env WORLD_SIZE)")
    g.add_argument("--process-id", default=None, type=int,
                   help="this process's rank (env RANK)")
    return parser


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def free_port() -> int:
    """A free TCP port on this host, for a coordinator of one process."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device_type: str = "cuda",
                     backend: Optional[str] = None) -> bool:
    """Join the default process group (idempotent); True once it exists.

    The arguments fall back to ``torchrun``'s environment.  One process
    without an address gets a free local port; several without one raise,
    as does a coordinator that cannot be reached.  ``backend`` defaults to
    NCCL for ``device_type='cuda'`` (which needs a card: there is no quiet
    fall back to gloo) and gloo for the CPU; a caller that wants gloo on the
    card names it."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    num_processes = 1 if num_processes is None else num_processes
    process_id = 0 if process_id is None else process_id
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is outside a world of "
                         f"{num_processes}")
    if coordinator_address is None:
        if num_processes > 1:
            raise ValueError(
                f"{num_processes} processes need --coordinator-address "
                "host:port (or torchrun's MASTER_ADDR/MASTER_PORT)")
        coordinator_address = f"localhost:{free_port()}"
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a distributed run on cuda needs a CUDA device")
        # this process's card: torchrun's LOCAL_RANK, else the rank modulo
        # the host's cards
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(process_id % torch.cuda.device_count()
                              if local is None else local)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


def init_distributed_from_args(args) -> bool:
    """CLI entry: join a group under ``--distributed`` or ``torchrun``'s
    environment (``WORLD_SIZE`` set), else do nothing and return False."""
    if not (getattr(args, "distributed", False)
            or os.environ.get("WORLD_SIZE")):
        return False
    return init_distributed(
        getattr(args, "coordinator_address", None),
        getattr(args, "num_processes", None),
        getattr(args, "process_id", None),
        device_type=torch.device(getattr(args, "device", "cuda")).type)


def run_device(args) -> torch.device:
    """The CLI's device: ``--device``, on this process's own card when the
    run is distributed on CUDA."""
    device = torch.device(args.device)
    if device.type == "cuda" and dist.is_initialized() and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def dp_coordinate(mesh) -> tuple:
    """``(rank, size)`` of this process along the batch axes ``(data,
    fsdp)``; ``(0, 1)`` without a mesh."""
    if mesh is None:
        return 0, 1
    data, fsdp = mesh["data"], mesh["fsdp"]
    return (data.get_local_rank() * fsdp.size() + fsdp.get_local_rank(),
            data.size() * fsdp.size())


def local_rows(batch: torch.Tensor, mesh, microbatches: int = 1) -> torch.Tensor:
    """This process's rows of the global ``batch``: each of its
    ``microbatches`` equal chunks splits into one contiguous block per
    ``(data, fsdp)`` coordinate, and the process keeps its block of each,
    in order, so that its chunk ``i`` is its part of the global microbatch
    ``i``.  Processes that differ only in ``model`` or ``seq`` get the same
    rows.  Without a mesh, ``batch`` itself."""
    rank, size = dp_coordinate(mesh)
    if size == 1:
        return batch
    quantum = size * microbatches
    if batch.shape[0] % quantum:
        raise ValueError(f"a global batch of {batch.shape[0]} rows does not "
                         f"split into {microbatches} microbatch(es) over "
                         f"{size} data-parallel ranks")
    chunks = batch.chunk(microbatches) if microbatches > 1 else (batch,)
    return torch.cat([c.chunk(size)[rank] for c in chunks])


def rank_seed(seed: int, mesh) -> int:
    """The seed of this rank's generator: its draws (erasing, mixup, drop
    path, dropout, EVA's noise) are for its own rows, so ranks differ along
    ``(data, fsdp)`` and agree along ``model``, whose ranks share rows.
    Rank 0 draws as one process does."""
    return seed + 100_003 * dp_coordinate(mesh)[0]


def generator_states(generator: torch.Generator) -> dict:
    """What a checkpoint keeps of the step's generator: its state, and under
    a process group every rank's (collective)."""
    state = generator.get_state()
    if not dist.is_initialized():
        return {"generator": state}
    states = [None] * dist.get_world_size()
    dist.all_gather_object(states, state)
    return {"generator": states[0], "generators": states}


def restore_generator(generator: torch.Generator, rng: dict, mesh=None) -> None:
    """Set ``generator`` from :func:`generator_states`' record: this rank's
    own state where the record holds one a rank of this world, else rank
    0's, into which a rank folds its ``(data, fsdp)`` coordinate on
    ``mesh`` as :func:`rank_seed` does, so that ranks differing only in
    ``model`` still draw alike."""
    states = rng.get("generators")
    rank = dist.get_rank() if dist.is_initialized() else 0
    size = dist.get_world_size() if dist.is_initialized() else 1
    if states is not None and len(states) == size:
        generator.set_state(states[rank])
        return
    generator.set_state(rng["generator"])
    coordinate = dp_coordinate(mesh)[0]
    if coordinate:
        draw = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device))
        generator.manual_seed(draw + coordinate)


class _Discard:
    def write(self, text: str) -> int:
        return len(text)

    def flush(self) -> None:
        pass


def primary_output():
    """Within the block a rank other than 0 prints nothing (its standard
    output is discarded; errors still reach standard error)."""
    import contextlib

    if is_primary():
        return contextlib.nullcontext()
    return contextlib.redirect_stdout(_Discard())


def run_in_group(args, run):
    """``run(args)`` in the process group of the CLI's flags or
    ``torchrun``'s environment (joined here where none exists yet, and left
    again after), rank 0 alone printing; without either, in one process."""
    joined = not dist.is_initialized() and init_distributed_from_args(args)
    try:
        with primary_output():
            return run(args)
    finally:
        if joined:
            dist.destroy_process_group()

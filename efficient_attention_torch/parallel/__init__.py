"""Mesh, sharding and process set-up on ``torch.distributed``: the port's
counterpart of ``efficient_attention_tpu/parallel``.  ``dryrun_multichip``
lives in ``parallel.dryrun`` and is imported on first use."""
from efficient_attention_torch.parallel.distributed import (
    add_distributed_args,
    init_distributed,
    init_distributed_from_args,
    is_primary,
    local_rows,
)
from efficient_attention_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_SEQ,
    ShardedModel,
    batch_spec,
    infer_param_specs,
    make_mesh,
    shard_model,
)


def __getattr__(name: str):
    if name == "dryrun_multichip":
        from efficient_attention_torch.parallel.dryrun import dryrun_multichip

        return dryrun_multichip
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "make_mesh", "batch_spec", "infer_param_specs", "shard_model",
    "ShardedModel", "AXIS_DATA", "AXIS_FSDP", "AXIS_MODEL", "AXIS_SEQ",
    "add_distributed_args", "init_distributed", "init_distributed_from_args",
    "is_primary", "local_rows", "dryrun_multichip",
]

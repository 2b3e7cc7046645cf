"""Device mesh, sharding rules and the sharded model.

Counterpart of ``efficient_attention_tpu/parallel/mesh.py``.  JAX keeps one
global program and lets XLA place every array by its ``PartitionSpec``; the
port runs one process a device on local tensors, since its CUDA kernels take
plain tensors, so a layout is also a meaning.  The four named axes are
JAX's:

* ``data``: replicas, each on its own rows of the batch (DDP, or the
  replicated dimension of HSDP);
* ``fsdp``: parameters, gradients and optimizer state sharded
  (``fully_shard``), rows split as over ``data``;
* ``model``: tensor parallelism (``parallelize_module``) head-aligned in
  attention and column/row split in the MLP;
* ``seq``: sequence parallelism, not ported yet (ROADMAP.md Queue 1, item
  7, slice B).

``infer_param_specs`` applies JAX's path rules to the port's names and
layouts.  ``shard_model`` turns them into the PyTorch wrappers: DDP where
``fsdp = model = 1``, tensor parallelism where ``model > 1``, and
``fully_shard`` per block and then at the root over ``(data, fsdp)`` where
``fsdp > 1`` (HSDP: replicated over ``data``, sharded over ``fsdp``).
"""
from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXES = (AXIS_DATA, AXIS_FSDP, AXIS_MODEL, AXIS_SEQ)


def mesh_shape(n_devices: int, data: int = -1, fsdp: int = 1, model: int = 1,
               seq: int = 1) -> Dict[str, int]:
    """The axis sizes of a mesh over ``n_devices``; ``data=-1`` absorbs the
    devices the other axes leave.  A world the axes do not divide raises
    with the numbers (JAX asserts, ``mesh.py:49-53``)."""
    fixed = fsdp * model * seq
    if min(fsdp, model, seq) < 1:
        raise ValueError(f"mesh axes must be >= 1: fsdp={fsdp} model={model} "
                         f"seq={seq}")
    if data == -1:
        if n_devices % fixed:
            raise ValueError(
                f"a world of {n_devices} devices does not divide into "
                f"fsdp x model x seq = {fsdp} x {model} x {seq} = {fixed}")
        data = n_devices // fixed
    if data * fixed != n_devices:
        raise ValueError(f"mesh data={data} fsdp={fsdp} model={model} "
                         f"seq={seq} needs {data * fixed} devices, the world "
                         f"has {n_devices}")
    return dict(zip(AXES, (data, fsdp, model, seq)))


def make_mesh(data: int = -1, fsdp: int = 1, model: int = 1, seq: int = 1,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the default process group with the axes
    ``(data, fsdp, model, seq)``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group "
                           "(parallel.init_distributed)")
    shape = mesh_shape(dist.get_world_size(), data, fsdp, model, seq)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=AXES)


def dp_mesh(mesh):
    """The batch axes ``(data, fsdp)`` of ``mesh`` as one flat mesh."""
    return mesh[AXIS_DATA, AXIS_FSDP]._flatten("dp")


def batch_spec() -> Tuple[Tuple[str, str]]:
    """Inputs: the batch dimension split over ``(data, fsdp)``, the JAX
    spec ``P(('data', 'fsdp'))`` as a tuple."""
    return ((AXIS_DATA, AXIS_FSDP),)


# ---------------------------------------------------------------------------
# Parameter sharding rules (JAX ``mesh.py:70-106``): Megatron-style tensor
# parallelism (column-parallel qkv / MLP-in, row-parallel proj / MLP-out,
# embeddings and heads on their vocabulary or class dimension), then FSDP on
# the largest dimension left.  The paths are the port's names with '/'.
# ---------------------------------------------------------------------------

_COLUMN_PARALLEL = re.compile(
    r"(qkv|q_proj|k_proj|v_proj|fc1|wi|mlp.*layers_0|GatedMlp.*Dense_0|Dense_0)"
)
_ROW_PARALLEL = re.compile(
    r"(out_proj|(^|/)proj(/|$)|fc2|wo|GatedMlp.*Dense_1|Dense_1)")
_EMBED = re.compile(r"(embed_tokens|pos_embed|head|output_projection)")


def _rule_for(path: str, shape: Tuple[int, ...], use_fsdp: bool,
              use_tp: bool) -> Tuple[Optional[str], ...]:
    """JAX's rule on a shape in JAX's layout (``[in, out]`` kernels)."""
    ndim = len(shape)
    if ndim == 0:
        return ()
    spec: List[Optional[str]] = [None] * ndim
    if use_tp and ndim >= 2 and "experts" in path:
        spec[0] = AXIS_MODEL
    elif use_tp and ndim >= 2:
        if _COLUMN_PARALLEL.search(path):
            spec[-1] = AXIS_MODEL
        elif _ROW_PARALLEL.search(path):
            spec[-2] = AXIS_MODEL
        elif _EMBED.search(path):
            spec[-1] = AXIS_MODEL
    if use_fsdp:
        for i in sorted(range(ndim), key=lambda i: -shape[i]):
            if spec[i] is None and shape[i] % 2 == 0 and shape[i] >= 16:
                spec[i] = AXIS_FSDP
                break
    return tuple(spec)


def _to_jax_layout(module: nn.Module, leaf: str, ndim: int) -> Tuple[int, ...]:
    """The permutation of a parameter's dims into JAX's layout: a Linear's
    ``[out, in]`` is flax's ``[in, out]``, a convolution's OIHW its HWIO."""
    if leaf == "weight" and isinstance(module, nn.Linear) and ndim == 2:
        return (1, 0)
    if leaf == "weight" and isinstance(module, nn.Conv2d) and ndim == 4:
        return (2, 3, 1, 0)
    return tuple(range(ndim))


def infer_param_specs(model: nn.Module, use_fsdp: bool = True,
                      use_tp: bool = True) -> Dict[str, Tuple[Optional[str], ...]]:
    """``{name: spec}``: for each parameter of ``model``, the mesh axis of
    each of its dims (None: not split), in the port's layout, by JAX's
    rules applied in JAX's layout."""
    modules = dict(model.named_modules())
    specs = {}
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        perm = _to_jax_layout(modules[owner], leaf, p.dim())
        # JAX's paths name convolutions Conv_i, which no TP rule matches;
        # the port's stems call theirs proj
        tp = use_tp and not isinstance(modules[owner], nn.Conv2d)
        jax_spec = _rule_for(name.replace(".", "/"),
                             tuple(p.shape[i] for i in perm), use_fsdp, tp)
        spec: List[Optional[str]] = [None] * p.dim()
        for j, i in enumerate(perm):
            spec[i] = jax_spec[j]
        specs[name] = tuple(spec)
    return specs


# ---------------------------------------------------------------------------
# Tensor parallelism.
# ---------------------------------------------------------------------------


def qkv_head_permutation(num_heads: int, head_dim: int, parts: int) -> torch.Tensor:
    """Row order of a fused qkv projection that gives each of ``parts``
    contiguous shards ``[q_h, k_h, v_h]`` of its own heads: the rows
    ``(3, H, Dh)`` reordered as ``(parts, 3, H / parts, Dh)``.
    ``w[perm]`` is the sharded layout; ``w[perm.argsort()]`` undoes it."""
    return (torch.arange(3 * num_heads * head_dim)
            .view(3, parts, num_heads // parts, head_dim)
            .permute(1, 0, 2, 3).reshape(-1))


def _head_sharded_attention(module: nn.Module) -> bool:
    from efficient_attention_torch.attention.base import MultiheadAttention
    from efficient_attention_torch.attention.eva import EVA
    from efficient_attention_torch.attention.local import LocalAttention

    return type(module) in (MultiheadAttention, LocalAttention, EVA)


def _parallelize_blocks(module: nn.Module, tp_mesh) -> Tuple[Dict[str, torch.Tensor],
                                                             List[str], List[str]]:
    """Tensor parallelism over ``tp_mesh``: attention whose heads the axis
    divides runs on its own heads (qkv column-parallel in the head-aligned
    row order, proj row-parallel); a ``GatedMlp`` without GLU runs fc1
    column- and fc2 row-parallel.  Returns the permuted qkv parameters'
    permutations, the parameters shared by the heads (each model rank
    computes their gradient over its heads only) and a line per module."""
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    from efficient_attention_torch.models.layers import GatedMlp

    parts, rank = tp_mesh.size(), tp_mesh.get_local_rank()
    permuted: Dict[str, torch.Tensor] = {}
    shared: List[str] = []
    log: List[str] = []
    for name, sub in list(module.named_modules()):
        if _head_sharded_attention(sub):
            heads = sub.num_heads
            if heads % parts:
                log.append(f"{name}: replicated ({heads} heads over "
                           f"{parts} model ranks)")
                continue
            perm = qkv_head_permutation(heads, sub.head_dim, parts)
            with torch.no_grad():
                for leaf in ("weight", "bias"):
                    p = getattr(sub.qkv, leaf)
                    if p is not None:
                        p.copy_(p[perm.to(p.device)])
                        permuted[f"{name}.qkv.{leaf}"] = perm
            local = heads // parts
            sub.dim = sub.dim // parts
            sub.num_heads = local
            sub.local_heads = slice(rank * local, (rank + 1) * local)
            shared += [f"{name}.{n}" for n, _ in sub.named_parameters()
                       if not n.startswith(("qkv.", "proj."))]
            parallelize_module(sub, tp_mesh, {"qkv": ColwiseParallel(),
                                              "proj": RowwiseParallel()})
            log.append(f"{name}: {local} of {heads} heads a model rank")
        elif isinstance(sub, GatedMlp):
            hidden = sub.fc2.in_features
            if sub.use_glu or hidden % parts:
                log.append(f"{name}: replicated (GLU or {hidden} hidden "
                           f"units over {parts} model ranks)")
                continue
            parallelize_module(sub, tp_mesh, {"fc1": ColwiseParallel(),
                                              "fc2": RowwiseParallel()})
            log.append(f"{name}: {hidden // parts} of {hidden} hidden units "
                       "a model rank")
    return permuted, shared, log


def _blocks(module: nn.Module) -> List[nn.Module]:
    """The elements of the outermost ``nn.ModuleList``s (the transformer
    blocks), each a unit of ``fully_shard``."""
    out: List[nn.Module] = []
    for child in module.children():
        if isinstance(child, nn.ModuleList):
            out.extend(child)
        else:
            out.extend(_blocks(child))
    return out


def is_dtensor(t) -> bool:
    if not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def to_local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local piece (sharing its storage), or ``t`` itself."""
    return t.to_local() if is_dtensor(t) else t


class ShardedModel:
    """What :func:`shard_model` made of a model: ``model``, to train
    (the DDP wrapper, or the module itself under FSDP or tensor
    parallelism); ``module``, the module with its own names; the
    ``mesh``; and what the train step, the optimizer and the checkpoints
    need besides: gradient sync per microbatch, the sum of the head-shared
    gradients over ``model``, reductions over the batch axes, and full
    tensors in the unsharded layout."""

    def __init__(self, model: nn.Module, module: nn.Module, mesh, fsdp: bool,
                 tp: bool, permuted: Dict[str, torch.Tensor], shared: List[str],
                 log: List[str]):
        self.model, self.module, self.mesh = model, module, mesh
        self.fsdp, self.tp = fsdp, tp
        self.permuted, self.shared, self.log = permuted, shared, log
        self.dp_group = dp_mesh(mesh).get_group()
        self.dp_size = dp_mesh(mesh).size()
        self.model_group = mesh[AXIS_MODEL].get_group()
        self._params = dict(module.named_parameters())

    @contextlib.contextmanager
    def no_sync(self):
        """Gradients of the enclosed backward passes stay local (all but
        the last microbatch of an accumulation)."""
        if self.fsdp:
            self.module.set_requires_gradient_sync(False)
            try:
                yield
            finally:
                self.module.set_requires_gradient_sync(True)
        elif isinstance(self.model, nn.parallel.DistributedDataParallel):
            with self.model.no_sync():
                yield
        else:
            yield

    @torch.no_grad()
    def finish_grads(self) -> None:
        """Sum the gradients of the parameters shared by the heads over the
        model axis: each model rank saw only its own heads."""
        if not self.shared or self.mesh[AXIS_MODEL].size() == 1:
            return
        for name in self.shared:
            g = self._params[name].grad
            if g is not None:
                dist.all_reduce(to_local(g), group=self.model_group)

    def all_reduce_dp(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the batch axes (a new tensor)."""
        t = t.clone()
        dist.all_reduce(t, group=self.dp_group)
        return t

    def _perm(self, name: str, t: torch.Tensor) -> Optional[torch.Tensor]:
        perm = self.permuted.get(name)
        if perm is None or t.dim() == 0 or t.shape[0] != perm.numel():
            return None
        return perm.to(t.device)

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole of ``t`` in the unsharded layout, on the CPU: ``t`` is
        the parameter ``name``, a DTensor split like it, or a tensor held
        whole on every rank.  Collective: every rank calls it."""
        if is_dtensor(t):
            t = t.full_tensor()
        perm = self._perm(name, t)
        if perm is not None:
            t = t[perm.argsort()]
        return t.detach().cpu()

    def local(self, name: str, full: torch.Tensor, like: torch.Tensor):
        """The inverse of :meth:`full`: this rank's part of ``full``, a
        DTensor split as the parameter ``name`` is, or ``full`` itself on
        the device of ``like`` (the tensor it replaces) where the parameter
        is not split or ``full`` is not shaped like it."""
        from torch.distributed.tensor import distribute_tensor

        p = self._params.get(name)
        full = full.to(like.device)
        perm = self._perm(name, full)
        if perm is not None:
            full = full[perm]
        if not is_dtensor(p) or full.shape != p.shape:
            return full
        return distribute_tensor(full, p.device_mesh, p.placements,
                                 src_data_rank=None)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The module's whole state dict in the unsharded layout, on the
        CPU.  Collective."""
        return {n: self.full(n, t) for n, t in self.module.state_dict().items()}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Load a whole (unsharded) state dict strictly, each rank keeping
        its part."""
        own = self.module.state_dict()
        missing, unexpected = set(own) - set(state), set(state) - set(own)
        if missing or unexpected:
            raise RuntimeError(f"state dict mismatch: missing {sorted(missing)}, "
                               f"unexpected {sorted(unexpected)}")
        for n, t in own.items():
            to_local(t).copy_(to_local(self.local(n, state[n], t)))


def shard_model(model: nn.Module, mesh, use_fsdp: Optional[bool] = None,
                use_tp: Optional[bool] = None,
                compute_dtype: Optional[torch.dtype] = None) -> ShardedModel:
    """Wrap ``model`` (its float32 weights the same on every rank, on this
    rank's device) for ``mesh``: tensor parallelism over ``model`` where
    ``use_tp`` (default: the axis is above 1); ``fully_shard`` of each block
    and then of the root over ``(data, fsdp)`` where ``use_fsdp`` (default:
    ``fsdp`` above 1, or tensor parallelism with ``data`` above 1, whose
    replicas then reduce through HSDP); else DDP.  Under FSDP the bf16
    scheme of ``--bf16`` (``compute_dtype``) is FSDP's
    ``MixedPrecisionPolicy``: a bf16 copy of the float32 masters for the
    forward, float32 gradients reduced to them."""
    sizes = {a: mesh[a].size() for a in AXES}
    if sizes[AXIS_SEQ] > 1:
        raise NotImplementedError("the seq axis (sequence parallelism) is "
                                  "not ported yet; see ROADMAP.md Queue 1, "
                                  "item 7")
    use_tp = sizes[AXIS_MODEL] > 1 if use_tp is None else use_tp
    if use_fsdp is None:
        use_fsdp = sizes[AXIS_FSDP] > 1 or (use_tp and sizes[AXIS_DATA] > 1)
    if sizes[AXIS_MODEL] > 1 and not use_tp:
        raise ValueError(f"a model axis of {sizes[AXIS_MODEL]} needs use_tp")
    if sizes[AXIS_FSDP] > 1 and not use_fsdp:
        raise ValueError(f"an fsdp axis of {sizes[AXIS_FSDP]} needs use_fsdp")
    if use_tp and not use_fsdp and sizes[AXIS_DATA] > 1:
        raise ValueError(f"tensor parallelism with a data axis of "
                         f"{sizes[AXIS_DATA]} needs use_fsdp (HSDP averages "
                         f"the replicas' gradients)")
    permuted, shared, log = {}, [], []
    if use_tp:
        permuted, shared, log = _parallelize_blocks(model, mesh[AXIS_MODEL])
    if use_fsdp:
        from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

        policy = MixedPrecisionPolicy(param_dtype=compute_dtype,
                                      reduce_dtype=torch.float32
                                      if compute_dtype is not None else None)
        # 2-D (data, fsdp): HSDP, replicated over data, sharded over fsdp
        hsdp = mesh[AXIS_DATA, AXIS_FSDP]
        blocks = _blocks(model)
        for block in blocks:
            fully_shard(block, mesh=hsdp, mp_policy=policy)
        fully_shard(model, mesh=hsdp, mp_policy=policy)
        log.append(f"fully_shard: {len(blocks)} blocks and the root over "
                   f"data x fsdp = {sizes[AXIS_DATA]} x {sizes[AXIS_FSDP]}")
        wrapped = model
    elif use_tp:
        wrapped = model
    else:
        device = next(model.parameters()).device
        wrapped = nn.parallel.DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False)
        log.append(f"DDP over {sizes[AXIS_DATA]} replicas")
    return ShardedModel(wrapped, model, mesh, use_fsdp, use_tp, permuted,
                        shared, log)

"""The port's mesh, sharding rules and sharded ViT step, on the CPU.

``parallel.mesh`` against ``efficient_attention_tpu.parallel.mesh``: the
mesh shapes of ``TestMesh.test_make_mesh_shapes``, and for every parameter
of a small evit the same logical axis per mesh axis as JAX's
``infer_param_specs`` on the flax tree.  Then gloo ranks
(``_torch_dist.py``), all in float32 at zero RF noise, with numpy-drawn
weights carried across by ``interop``:

* gate 1: 4 ranks as ``fsdp=2 x model=2``, an evit at depth 2, 64 px, EVA
  window 2 with 4 landmarks, 3 AdamW steps behind the clip of 5.0 with an
  EMA, at 4 heads (attention head-parallel) and 3 (attention replicated):
  losses and gradient norms within 1e-6 relative, every parameter and the
  EMA within 1e-5 of the port's single-process step on the global batch,
  and within the ViT parity tests' limits of JAX's jitted step on
  ``make_mesh(8, data=-1, fsdp=2, model=2)`` (8 virtual devices);
  the 4-rank checkpoint loads strictly into one process and the
  single-process one into the 4 ranks, and ranks 1-3 write no file; tensor
  parallelism without FSDP over data replicas raises;
* DDP at 2 ranks with ``accum_steps=2``, each rank's mixup pairs within its
  own rows, and every optimizer of the port at ``fsdp=2`` (3 steps, the
  whole state gathered) against one process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_dist import _vit, run_ranks, vit_trajectory, zero_noise
from _torch_port import exact_float32, randomize, to_jax
from efficient_attention_tpu.data.mixup import (
    one_hot_smooth as jax_one_hot_smooth,
    soft_target_cross_entropy as jax_soft_target_ce,
)
from efficient_attention_tpu.models.efficient_vit import (
    EfficientTransformer as JaxViT,
)
from efficient_attention_tpu.parallel import (
    batch_spec as jax_batch_spec,
    infer_param_specs as jax_infer_param_specs,
    make_mesh as jax_make_mesh,
)
from efficient_attention_torch.interop import load_jax_params, state_dict_from_jax
from efficient_attention_torch.parallel import infer_param_specs
from efficient_attention_torch.parallel.mesh import mesh_shape, qkv_head_permutation

ATTN = {"window_size": 2, "num_landmarks": 4, "attn_2d": True,
        "use_rpe": True, "adaptive_proj": "default"}


@pytest.fixture(autouse=True)
def _f32_zero_noise(monkeypatch):
    zero_noise(monkeypatch.setattr)
    with exact_float32():
        yield


def test_mesh_shapes_match_jax():
    want = dict(jax_make_mesh(8, data=-1, fsdp=2, model=2).shape)
    assert mesh_shape(8, data=-1, fsdp=2, model=2) == want
    assert mesh_shape(8)["data"] == dict(jax_make_mesh(8).shape)["data"] == 8
    with pytest.raises(ValueError, match="world of 6 devices"):
        mesh_shape(6, fsdp=4)
    with pytest.raises(ValueError, match="needs 8 devices"):
        mesh_shape(6, data=4, fsdp=2)


def _jax_vit(heads):
    return JaxViT(attn_name="eva", attn_args=dict(ATTN, impl="xla"),
                  img_size=64, patch_size=16, embed_dim=16 * heads, depth=2,
                  num_heads=heads, num_classes=16, drop_path_rate=0.0)


def _flax_params(heads, seed):
    jm = _jax_vit(heads)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, deterministic=True),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    return jm, randomize(shapes, seed)


@pytest.mark.parametrize("use_fsdp,use_tp", [(True, True), (True, False),
                                             (False, True)])
def test_param_rules_shard_the_axes_jax_does(use_fsdp, use_tp):
    """Each parameter of a small evit: the port's rule in the port's layout
    names the same logical axis for each mesh axis as JAX's rule on the
    flax tree (a Linear's [out, in] is flax's [in, out], a conv's OIHW its
    HWIO)."""
    _, params = _flax_params(4, seed=1)
    jax_specs = jax_infer_param_specs(params, use_fsdp, use_tp)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    specs = jax.tree_util.tree_leaves(
        jax_specs, is_leaf=lambda x: isinstance(x, P))
    port = infer_param_specs(_vit(4, _port_sd(params)), use_fsdp, use_tp)
    from efficient_attention_torch.interop import flax_path_to_torch_key

    checked = 0
    for (path, leaf), spec in zip(flat, specs):
        parts = [str(getattr(p, "key", p)) for p in path][1:]
        name = flax_path_to_torch_key(parts)
        jax_axes = dict(enumerate(tuple(spec) + (None,) * (leaf.ndim - len(spec))))
        layout = {2: (1, 0), 4: (2, 3, 1, 0)}.get(leaf.ndim) \
            if parts[-1] == "kernel" else None
        ours = port[name]
        for axis in ("model", "fsdp"):
            jax_dim = [d for d, a in jax_axes.items() if a == axis]
            our_dim = [d for d, a in enumerate(ours) if a == axis]
            if layout is not None:  # our dim -> the flax dim it holds
                our_dim = [layout.index(d) for d in our_dim]
            assert our_dim == jax_dim, (name, axis, ours, spec)
        checked += 1
    assert checked == len(port)


def test_qkv_head_permutation_round_trips():
    """The head-aligned row order gives each model rank [q_h, k_h, v_h] of
    its own heads, and its argsort restores the fused layout exactly."""
    H, D, M = 4, 3, 2
    perm = qkv_head_permutation(H, D, M)
    w = torch.randn(3 * H * D, 5, dtype=torch.float64)
    shards = w[perm].chunk(M)
    for r, shard in enumerate(shards):
        q, k, v = shard.view(3, H // M, D, 5).unbind(0)
        heads = slice(r * H // M, (r + 1) * H // M)
        full = w.view(3, H, D, 5)
        assert torch.equal(q, full[0, heads]) and torch.equal(k, full[1, heads])
        assert torch.equal(v, full[2, heads])
    assert torch.equal(w[perm][perm.argsort()], w)
    assert torch.equal(qkv_head_permutation(H, D, 1), torch.arange(3 * H * D))


def _port_sd(params):
    from efficient_attention_torch.models.efficient_vit import EfficientTransformer

    heads = params["params"]["blocks_0"]["EVA_0"][
        "local_relative_position_bias_table"].shape[-1]
    m = EfficientTransformer(attn_name="eva", attn_args=ATTN, img_size=64,
                             patch_size=16, embed_dim=16 * heads, depth=2,
                             num_heads=heads, num_classes=16)
    return load_jax_params(m, params).state_dict()


def _jax_trajectory(jm, params, images, labels, shard_batch=True):
    """JAX's step on its 8-device mesh: the sharded params and state of
    ``dryrun_multichip``, 3 AdamW steps at ``deterministic=True``, the
    batch split over ``(data, fsdp)`` (else replicated)."""
    from efficient_attention_tpu.training import (
        TrainState,
        cosine_schedule,
        make_optimizer,
    )

    mesh = jax_make_mesh(8, data=-1, fsdp=2, model=2)
    params = to_jax(params)
    schedule = cosine_schedule(1e-3, warmup_steps=10, total_steps=100)
    tx = make_optimizer("adamw", schedule, weight_decay=0.05, clip_grad=5.0,
                        params_for_mask=params)
    state = TrainState.create(jm.apply, params, tx, ema_decay=0.9)
    specs = jax_infer_param_specs(params, use_fsdp=True, use_tp=True)
    shard = lambda s: NamedSharding(mesh, s)  # noqa: E731
    pshard = jax.tree_util.tree_map(shard, specs, is_leaf=lambda x: isinstance(x, P))
    state = state.replace(params=jax.device_put(state.params, pshard),
                          ema_params=jax.device_put(state.ema_params, pshard))

    def loss_fn(p, x, y):
        logits = jm.apply(p, x, deterministic=True)
        return jax_soft_target_ce(logits, jax_one_hot_smooth(y, 16, 0.1))

    @jax.jit
    def step(state, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, x, y)
        return state.apply_gradients(grads), loss, optax.global_norm(grads)

    data = NamedSharding(mesh, jax_batch_spec() if shard_batch else P())
    losses, norms = [], []
    for x, y in zip(images, labels):
        state, loss, gn = step(state, jax.device_put(x, data),
                               jax.device_put(y, data))
        losses.append(float(loss))
        norms.append(float(gn))
    return losses, norms, state_dict_from_jax(jax.device_get(state.params)), \
        state_dict_from_jax(jax.device_get(state.ema_params))


def _close(got, want, atol, what):
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w), atol=atol,
                                   rtol=0, err_msg=f"{what}: {k}")


@pytest.mark.timeout(300)
def test_gate1_fsdp_x_model_matches_one_process_and_jax(tmp_path):
    from efficient_attention_torch.parallel.distributed import generator_states
    from efficient_attention_torch.training.checkpoint import CheckpointManager

    rng = np.random.default_rng(5)
    data, ref, single = {}, {}, {}
    for heads in (4, 3):
        jm, params = _flax_params(heads, seed=heads)
        images = rng.standard_normal((3, 8, 64, 64, 3)).astype(np.float32)
        labels = rng.integers(0, 16, (3, 8)).astype(np.int32)
        sd = _port_sd(params)
        data[heads] = {"sd": sd, "images": images, "labels": labels}
        losses, norms, state = vit_trajectory(_vit(heads, sd), None, images,
                                              labels)
        single[heads] = (losses, norms, state)
        # JAX's step with the batch split too drifts from its own one-device
        # step at 4 heads (ROADMAP.md Queue 3); the batch is replicated there
        ref[heads] = _jax_trajectory(jm, params, images, labels,
                                     shard_batch=heads == 3)
    # the single-process checkpoint the 4 ranks load
    ckpt = CheckpointManager(str(tmp_path / "single"))
    ckpt.save(3, dict(single[4][2].state_dict(),
                      rng=generator_states(torch.Generator())))
    out = run_ranks(4, "gate1", data, str(tmp_path / "single"),
                    str(tmp_path / "ranks"), timeout=240)
    for r in (1, 2, 3):
        assert out[r]["writes"] == [], (r, out[r]["writes"])
    got = out[0]
    assert "data axis of 2 needs use_fsdp" in got["tp_without_fsdp"]
    assert any("2 of 4 heads" in line for line in got[4]["log"])
    assert any("replicated (3 heads" in line for line in got[3]["log"])
    for heads in (4, 3):
        losses, norms, state = single[heads]
        g = got[heads]
        np.testing.assert_allclose(g["losses"], losses, rtol=1e-6)
        np.testing.assert_allclose(g["norms"], norms, rtol=1e-6)
        _close(g["params"], state.model.state_dict(), 1e-5, "params")
        _close(g["ema"], state.ema_params, 1e-5, "ema")
        jl, jn, jparams, jema = ref[heads]
        np.testing.assert_allclose(g["losses"], jl, rtol=1e-5)
        np.testing.assert_allclose(g["norms"], jn, rtol=1e-5)
        _close(g["params"], jparams, 1e-5, "params vs JAX")
        _close(g["ema"], jema, 1e-5, "ema vs JAX")
        # the 4-rank checkpoint loads strictly into one process
        saved = CheckpointManager(str(tmp_path / "ranks" / f"h{heads}")).load()
        model = _vit(heads, saved["params"])
        one = single[heads][2]
        one.load_state_dict(saved)
        assert one.step == 3
        _close(model.state_dict(), g["params"], 0, "reloaded")
    # ... and the single-process one into the 4 ranks, exactly
    saved = ckpt.load()
    _close(got[4]["loaded"]["params"], saved["params"], 0, "loaded params")
    _close(got[4]["loaded"]["ema_params"], saved["ema_params"], 0, "loaded ema")
    for i, s in saved["opt_state"]["adamw"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(
                got[4]["loaded"]["opt_state"]["adamw"]["state"][i][k], s[k])


def _state_close(got, want, atol, what):
    """Two (nested) optimizer states: the same keys, tensors within atol."""
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got) ^ set(want))
        for k in want:
            _state_close(got[k], want[k], atol, f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _state_close(g, w, atol, f"{what}[{i}]")
    elif torch.is_tensor(want):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), atol=atol,
                                   rtol=0, err_msg=what)
    else:
        assert got == want, what


@pytest.mark.timeout(300)
def test_ddp_accumulation_mixup_rows_and_optimizers_at_fsdp2():
    """DDP at 2 ranks: the ViT step with ``accum_steps=2`` equals one
    process on the global batch; each rank's mixup pairs stay within its
    own rows (timm under the reference's DDP; JAX flips the global batch,
    ROADMAP.md Queue 3); and each of the port's nine optimizers takes at
    ``fsdp=2`` the single-process steps, its whole state included."""
    from _torch_dist import OPTIMIZERS, optimizer_run, toy_model

    rng = np.random.default_rng(9)
    _, params = _flax_params(4, seed=7)
    sd = _port_sd(params)
    vit = {"sd": sd,
           "images": rng.standard_normal((3, 8, 64, 64, 3)).astype(np.float32),
           "labels": rng.integers(0, 16, (3, 8)).astype(np.int32)}
    toy = {"sd": toy_model().state_dict(),
           "x": rng.standard_normal((3, 8, 128)).astype(np.float32),
           "y": rng.standard_normal((3, 8, 5)).astype(np.float32)}
    out = run_ranks(2, "ddp_and_optimizers", vit, toy, timeout=240)
    got = out[0]
    assert got["kind"] == ["DDP over 2 replicas"]
    losses, norms, state = vit_trajectory(_vit(4, sd), None, vit["images"],
                                          vit["labels"], accum_steps=2)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
    np.testing.assert_allclose(got["norms"], norms, rtol=1e-6)
    _close(got["params"], state.model.state_dict(), 1e-5, "params")
    _close(got["ema"], state.ema_params, 1e-5, "ema")
    for r, o in enumerate(out):
        own = set(o["mixup"]["rows"])
        assert own == set(range(4 * r, 4 * r + 4)), own
        mixed = 0
        for step in o["mixup"]["pairs"]:
            for classes in step:
                assert set(classes) <= own, (r, classes)
                mixed += len(classes) > 1
        assert mixed > 0
    for name in OPTIMIZERS:
        want_params, want_state = optimizer_run(
            name, toy_model(toy["sd"]), None, toy["x"], toy["y"])
        got_params, got_state = got["optim"][name]
        _close(got_params, want_params, 1e-5, name)
        _state_close(got_state, want_state, 1e-5, name)


@pytest.mark.parametrize("route", ["ddp", "fsdp2", "tp", "fsdp2+tp"])
def test_world_one_routes_match_the_unwrapped_bf16_step(route, monkeypatch):
    """At world size 1 (an in-process gloo group) each wrapper, applied on a
    mesh of ones, takes the unwrapped bf16 step: FSDP's mixed-precision
    policy against ``cast_modules``.  2 AdamW steps at lr 1e-3 without
    warmup, which move a weight by up to 2e-3: losses and gradient norms
    within 1e-6 relative, the parameters' change over the steps within
    1e-5 relative (the norm of the difference over the norm of the change)
    and every parameter within 1e-5 (the card's check at the headline's
    size is ``chip_smoke.py``'s scale-out phase)."""
    import torch.distributed as dist

    from _torch_dist import _vit_state
    from efficient_attention_torch.parallel import init_distributed, make_mesh, shard_model
    from efficient_attention_torch.parallel.distributed import free_port
    from efficient_attention_torch.training.train_state import make_vit_train_step

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    _, params = _flax_params(4, seed=11)
    sd = _port_sd(params)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((4, 64, 64, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 16, 4))
    step = make_vit_train_step(None, 16, 0.1, compute_dtype=torch.bfloat16)

    def run(model, sharding):
        state = _vit_state(model, sharding, lr=1e-3, warmup=0)
        metrics = [step(state, x, y, None) for _ in range(2)]
        return ([float(m.loss) for m in metrics],
                [float(m.grad_norm) for m in metrics])

    ref_model = _vit(4, sd)
    ref_losses, ref_norms = run(ref_model, None)
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device_type="cpu")
    try:
        use_fsdp, use_tp = {"ddp": (False, False), "fsdp2": (True, False),
                            "tp": (False, True), "fsdp2+tp": (True, True)}[route]
        model = _vit(4, sd)
        sharding = shard_model(model, make_mesh(device_type="cpu"), use_fsdp,
                               use_tp, compute_dtype=torch.bfloat16)
        losses, norms = run(model, sharding)
        got = sharding.state_dict()
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    np.testing.assert_allclose(norms, ref_norms, rtol=1e-6)
    want = ref_model.state_dict()
    keys = [k for k, v in sd.items() if v.is_floating_point()]
    d_want = torch.cat([(want[k] - sd[k]).flatten() for k in keys])
    d_got = torch.cat([(got[k] - sd[k]).flatten() for k in keys])
    assert d_want.abs().max() > 1e-3
    assert (d_got - d_want).norm() <= 1e-5 * d_want.norm()
    _close(got, want, 1e-5, route)

"""The JAX factory's optax optimizers ported to the PyTorch port
(``training/optim.py``): ``sgd``, ``adafactor``, ``adagrad``, ``adadelta``,
``adamax`` and ``lamb``, each behind the global-norm clip, step for step
against the JAX factory's optax chain on a small parameter tree with the
weight-decay mask (a factored 2-D and 3-D weight for adafactor, a
parameter of zeros for lamb's trust ratio), to 1e-6 relative; a
``state_dict`` round trip that resumes bit for bit; ``make_optimizer``
reaching every name from each CLI.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_port  # noqa: F401  (caps torch's threads)
from efficient_attention_torch.training import optim

NAMES = ("sgd", "adafactor", "adagrad", "adadelta", "adamax", "lamb")
STEPS = 6


def _tree(seed=1):
    """A nested param tree: a factored [130, 128] weight and its bias, a
    factored [3, 130, 129] weight, a small head, a LayerNorm scale, a
    pos_embed (no decay) and a weight of zeros."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"fc": {"kernel": f(130, 128), "bias": f(128)},
            "t3": {"kernel": f(3, 130, 129)},
            "head": {"kernel": f(5, 6)},
            "norm": {"scale": 1.0 + 0.1 * f(6)},
            "pos_embed": f(1, 4, 6),
            "zero": {"kernel": np.zeros((4, 6), np.float32)}}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _schedule(step):
    return 0.05 * (0.9 ** step)


def _run(name, clip, steps=STEPS, weight_decay=0.05, momentum=0.9,
         betas=(0.9, 0.99)):
    """(port params, JAX params) after ``steps`` updates of the same
    random gradients (scaled up so a clip of 0.5 engages)."""
    from efficient_attention_tpu.training.optim import make_optimizer

    init = _tree()
    rng = np.random.default_rng(7)
    grads = [{k: 3.0 * rng.standard_normal(v.shape).astype(np.float32)
              for k, v in _flat(init)} for _ in range(steps)]
    tx = make_optimizer(name, _schedule, weight_decay=weight_decay,
                        clip_grad=clip, params_for_mask=init, betas=betas,
                        momentum=momentum)
    params = jax.tree_util.tree_map(jnp.asarray, init)
    state = tx.init(params)
    named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, v in _flat(init)]
    opt = optim.make_optimizer(name, named, _schedule, weight_decay=weight_decay,
                               clip_grad=clip, betas=betas, momentum=momentum)
    step = jax.jit(lambda g, s, p: tx.update(g, s, p))
    for g in grads:
        nested = {}
        for k, v in g.items():
            *path, leaf = k.split(".")
            node = nested
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(v)
        upd, state = step(nested, state, params)
        params = optax.apply_updates(params, upd)
        for k, p in named:
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    return dict(named), dict(_flat(jax.tree_util.tree_map(np.asarray, params)))


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_optax(name, clip):
    got, want = _run(name, clip)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v, rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_lamb_decays_only_under_the_mask():
    """With and without weight decay, lamb moves the masked-off leaves
    (bias, scale, pos_embed) identically and the decayed ones not."""
    with_wd, _ = _run("lamb", None, steps=2, weight_decay=0.5)
    without, _ = _run("lamb", None, steps=2, weight_decay=0.0)
    for k in ("fc.bias", "norm.scale", "pos_embed"):
        assert torch.equal(with_wd[k], without[k]), k
    for k in ("fc.kernel", "head.kernel"):
        assert not torch.equal(with_wd[k], without[k]), k


def test_adafactor_factors_the_large_weights():
    """The factored moments' shapes are optax's: the [130, 128] and
    [3, 130, 129] weights factored, the small ones kept whole."""
    from optax._src.factorized import scale_by_factored_rms

    tree = _tree()
    want = scale_by_factored_rms().init(jax.tree_util.tree_map(jnp.asarray, tree))
    named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, v in _flat(tree)]
    opt = optim.make_optimizer("adafactor", named, _schedule)
    for key in ("v_row", "v_col", "v"):
        shapes = dict(_flat(jax.tree_util.tree_map(np.shape, getattr(want, key),
                                                   is_leaf=lambda x: hasattr(x, "shape"))))
        for (k, _), t in zip(named, opt.state[key]):
            assert tuple(t.shape) == tuple(shapes[k]), (key, k)
    assert tuple(opt.state["v_row"][0].shape) == (128,)
    assert tuple(opt.state["v"][named.index(named[0])].shape) == (1,)


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_resumes_bit_for_bit(name, tmp_path):
    """Three steps, a save through ``torch.save`` (as the checkpoint
    manager writes it), then three more steps, against a fresh optimizer
    restored from the file and given the same three gradients."""
    rng = np.random.default_rng(3)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in _flat(_tree())} for _ in range(6)]

    def make():
        named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
                 for k, v in _flat(_tree())]
        return named, optim.make_optimizer(name, named, _schedule,
                                           clip_grad=1.0, momentum=0.9)

    def run(named, opt, gs):
        for g in gs:
            for k, p in named:
                p.grad = torch.from_numpy(g[k].copy())
            opt.step()
            opt.zero_grad()

    named, opt = make()
    run(named, opt, grads[:3])
    torch.save({"params": {k: p.detach().clone() for k, p in named},
                "opt": opt.state_dict()}, tmp_path / "state.pt")
    run(named, opt, grads[3:])
    saved = torch.load(tmp_path / "state.pt", weights_only=True)
    named2, opt2 = make()
    with torch.no_grad():
        for k, p in named2:
            p.copy_(saved["params"][k])
    opt2.load_state_dict(saved["opt"])
    assert opt2.count == 3
    run(named2, opt2, grads[3:])
    for (k, a), (_, b) in zip(named, named2):
        assert torch.equal(a, b), k
    for key, vals in opt.state_dict().items():
        if key != "count":
            assert all(torch.equal(x, y) for x, y in zip(vals, opt2.state_dict()[key]))


def test_make_optimizer_reaches_every_name():
    """Every name of the JAX factory builds, the clip and schedule in
    place; an unknown one raises."""
    named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, v in _flat(_tree())]
    kinds = {"adamw": optim.ClippedAdamW, "adam": optim.ClippedAdam,
             "nag": optim.ClippedNAG, "sgd": optim.ClippedSGD,
             "adafactor": optim.ClippedAdafactor,
             "adagrad": optim.ClippedAdagrad,
             "adadelta": optim.ClippedAdadelta,
             "adamax": optim.ClippedAdamax, "lamb": optim.ClippedLamb}
    for name, kind in kinds.items():
        opt = optim.make_optimizer(name, named, _schedule, clip_grad=0.5)
        assert type(opt) is kind and opt.clip_grad == 0.5
    with pytest.raises(NotImplementedError, match="optimizer"):
        optim.make_optimizer("rmsprop", named, _schedule)


@pytest.mark.parametrize("cli,flag,default", [
    ("train_vit", "--opt", "adamw"), ("train_lm", "--optimizer", "nag"),
    ("train_mt", "--optimizer", "adam")])
def test_cli_flags_reach_every_optimizer(cli, flag, default):
    """Each training CLI parses every optimizer name its JAX twin takes
    (``train_lm``'s choices are JAX's five), with the JAX CLI's default, and
    ``check_ported`` passes each."""
    import importlib

    mod = importlib.import_module(f"efficient_attention_torch.cli.{cli}")
    base = ["--device", "cpu"]
    assert getattr(mod.parse_args(base),
                   "opt" if cli == "train_vit" else "optimizer") == default
    for name in (("sgd", "adafactor") if cli == "train_lm" else NAMES):
        args = mod.parse_args(base + [flag, name])
        assert getattr(args, "opt" if cli == "train_vit" else "optimizer") == name
        mod.check_ported(args)

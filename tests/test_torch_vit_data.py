"""The ImageNet recipe's data pipeline and model options in the PyTorch port,
against the JAX package on the CPU.

The data modules are numpy and PIL in both packages, so with the same
``np.random.Generator`` the port must return JAX's arrays bit for bit: the
image folder's train and eval transforms at each interpolation, with and
without RandAugment or colour jitter, each RandAugment op, the policy
parser and timm's dispatch rule, CIFAR-10/100 from their pickled archives,
the uint8 cache's two files byte for byte, the RASampler, and the
prefetching loader at one worker.  With three threads the loader keeps the
order and its window; the process backend keeps the order, with the
recipe's RandAugment, which JAX's cannot pickle.  ``step_schedule`` follows
JAX's float32 one; ``--checkpoint-activations`` gives the gradients of the
plain blocks bit for bit (drop-path and EVA noise on, one generator) and
JAX's remat gradients to 1e-4 at drop-path 0.  The tests write their own
images (PNG and JPEG) and archives.
"""
import os
import pickle
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import exact_float32, randomize, to_jax
from efficient_attention_tpu.data import cifar as jax_cifar
from efficient_attention_tpu.data import imagenet as jax_imagenet
from efficient_attention_tpu.data import randaugment as jax_ra
from efficient_attention_torch.data import cifar, imagenet, randaugment

AA = "rand-m9-mstd0.5-inc1"  # the recipe's --aa


def write_image_folder(root, classes=3, per_class=(2, 1), seed=0):
    """``root/{train,val}/n<wnid>/`` with smooth random images of about
    150 x 120 and 120 x 150 pixels, JPEG (quality 90) and PNG in turns."""
    rng = np.random.default_rng(seed)
    for split, n in zip(("train", "val"), per_class):
        for c in range(classes):
            d = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(d)
            for i in range(n):
                w, h = (150, 120) if (c + i) % 2 else (120, 150)
                small = rng.integers(0, 256, (h // 10, w // 10, 3), np.uint8)
                img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
                if i % 2 == 0:
                    img.save(os.path.join(d, f"{i}.JPEG"), quality=90)
                else:
                    img.save(os.path.join(d, f"{i}.png"))
    return root


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_image_folder(str(tmp_path_factory.mktemp("imagenet")))


def _augments(kind):
    """(port, JAX) train augment of each kind."""
    aa, cj = {"none": (None, 0.0), "rand": (AA, 0.4),
              "jitter": (None, 0.4)}[kind]
    return (randaugment.build_train_augment(aa, cj),
            jax_ra.build_train_augment(aa, cj))


def _same_loads(ours, ref, seed=0):
    assert len(ours) == len(ref)
    for i in range(len(ref)):
        a, la = ours.load(i, np.random.default_rng(seed + i))
        b, lb = ref.load(i, np.random.default_rng(seed + i))
        assert a.dtype == np.float32 and la == lb
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("interpolation", ["bicubic", "bilinear", "nearest",
                                           "random"])
@pytest.mark.parametrize("kind", ["none", "rand", "jitter"])
def test_image_folder_train_load_matches_jax(folder, interpolation, kind):
    aug, jaug = _augments(kind)
    root = os.path.join(folder, "train")
    ours = imagenet.ImageFolderDataset(root, 64, True, aug, interpolation)
    ref = jax_imagenet.ImageFolderDataset(root, 64, True, jaug, interpolation)
    assert ours.samples == ref.samples and ours.classes == ref.classes
    _same_loads(ours, ref, seed=3)


def test_image_folder_eval_load_matches_jax(folder):
    root = os.path.join(folder, "val")
    _same_loads(imagenet.ImageFolderDataset(root, 64, train=False),
                jax_imagenet.ImageFolderDataset(root, 64, train=False))


def _photo(seed=1, size=(40, 30)):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (size[1] // 5, size[0] // 5, 3), np.uint8)
    return Image.fromarray(small).resize(size, Image.BICUBIC)


@pytest.mark.parametrize("op", range(len(randaugment.OPS)))
def test_randaugment_op_matches_jax(op):
    name, fn = randaugment.OPS[op]
    jname, jfn = jax_ra._build_ops()[op]
    assert name == jname
    img = _photo()
    for m in (0.0, 3.7, 9.0, 10.0):
        for seed in range(3):
            a = fn(img, m, np.random.default_rng(seed))
            b = jfn(img, m, np.random.default_rng(seed))
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("config", [AA, "rand-m7-n3-p0.8", "rand-m10-mstd0",
                                    "rand-m5-mstd1.0-inc1-n1-p1.0"])
def test_randaugment_policy_matches_jax(config):
    ours = randaugment.RandAugment.from_config(config)
    ref = jax_ra.RandAugment.from_config(config)
    for attr in ("magnitude", "mstd", "num_layers", "prob"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    img = _photo(2)
    for seed in range(12):
        a = ours(img, np.random.default_rng(seed))
        b = ref(img, np.random.default_rng(seed))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("aa,cj,kind", [
    (AA, 0.4, "RandAugment"), (AA, 0.0, "RandAugment"),
    (None, 0.4, "jitter"), (None, 0.0, None), (None, None, None)])
def test_train_augment_dispatch_matches_jax(aa, cj, kind):
    """timm's rule: auto-augment wins over colour jitter."""
    ours = randaugment.build_train_augment(aa, cj)
    ref = jax_ra.build_train_augment(aa, cj)
    if kind is None:
        assert ours is None and ref is None
        return
    assert (type(ours).__name__ == "RandAugment") == (kind == "RandAugment")
    img = _photo(3)
    for seed in range(6):
        np.testing.assert_array_equal(
            np.asarray(ours(img, np.random.default_rng(seed))),
            np.asarray(ref(img, np.random.default_rng(seed))))


@pytest.mark.parametrize("aa,cj", [(AA, 0.4), (None, 0.4)])
def test_augments_pickle_unlike_jax(aa, cj):
    """The loader's process backend pickles the dataset with its augment:
    the port's augments pickle and act alike after; JAX's are closures over
    lambdas, so ``--decode-backend process`` with the recipe's ``--aa``
    fails there (ROADMAP.md Queue 3)."""
    ours = randaugment.build_train_augment(aa, cj)
    again = pickle.loads(pickle.dumps(ours))
    img = _photo(4)
    for seed in range(4):
        np.testing.assert_array_equal(
            np.asarray(again(img, np.random.default_rng(seed))),
            np.asarray(ours(img, np.random.default_rng(seed))))
    with pytest.raises((AttributeError, pickle.PicklingError)):
        pickle.dumps(jax_ra.build_train_augment(aa, cj))


def write_cifar(root, num_classes, per_file=3, seed=0):
    """A CIFAR archive of ``per_file`` images a file, in the python-pickle
    layout (``data`` [n, 3072] uint8 channel-major, byte-string keys)."""
    rng = np.random.default_rng(seed)
    if num_classes == 10:
        base = os.path.join(root, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
        key = b"labels"
    else:
        base = os.path.join(root, "cifar-100-python")
        files, key = ["train", "test"], b"fine_labels"
    os.makedirs(base)
    for fname in files:
        d = {b"data": rng.integers(0, 256, (per_file, 3072), np.uint8),
             key: [int(x) for x in rng.integers(0, num_classes, per_file)]}
        with open(os.path.join(base, fname), "wb") as f:
            pickle.dump(d, f)
    return root


@pytest.mark.parametrize("num_classes", [10, 100])
@pytest.mark.parametrize("train,size", [(True, 32), (True, 48), (False, 32),
                                        (False, 48)])
def test_cifar_matches_jax(tmp_path, num_classes, train, size):
    root = write_cifar(str(tmp_path), num_classes)
    aug, jaug = _augments("rand") if train else (None, None)
    ours = cifar.CIFARDataset(root, num_classes, size, train, aug)
    ref = jax_cifar.CIFARDataset(root, num_classes, size, train, jaug)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    assert len(ours) == (15 if train and num_classes == 10 else 3)
    _same_loads(ours, ref, seed=5)


def test_uint8_cache_matches_jax_byte_for_byte(folder, tmp_path):
    root = os.path.join(folder, "train")
    imagenet.CachedUint8Dataset.build(root, str(tmp_path / "ours"), 48,
                                      num_workers=3)
    jax_imagenet.CachedUint8Dataset.build(root, str(tmp_path / "ref"), 48)
    for suffix in (".imgs.npy", ".labels.npy"):
        assert ((tmp_path / f"ours{suffix}").read_bytes()
                == (tmp_path / f"ref{suffix}").read_bytes())
    aug, jaug = _augments("rand")
    for train in (True, False):
        ours = imagenet.CachedUint8Dataset(str(tmp_path / "ours"), 32, train,
                                           aug if train else None, "random")
        ref = jax_imagenet.CachedUint8Dataset(str(tmp_path / "ref"), 32, train,
                                              jaug if train else None, "random")
        _same_loads(ours, ref, seed=9)
        # a spawned worker maps the file: the pickle holds no image
        again = pickle.loads(pickle.dumps(ours))
        assert "images" not in ours.__getstate__()
        np.testing.assert_array_equal(again.images, ours.images)


@pytest.mark.parametrize("n", [100, 256, 1000, 1281])
@pytest.mark.parametrize("replicas", [1, 2, 4])
def test_ra_sampler_matches_jax(n, replicas):
    for epoch in (0, 1, 7):
        for rank in range(replicas):
            ours = imagenet.ra_sampler_indices(n, epoch, 3, replicas, rank)
            ref = jax_imagenet.ra_sampler_indices(n, epoch, 3, replicas, rank)
            np.testing.assert_array_equal(ours, ref)
            if n >= 256:
                assert len(ours) == n // 256 * 256 // replicas


def _loader_batches(mod, ds, **kw):
    return list(mod.PrefetchLoader(ds, **kw))


@pytest.mark.parametrize("drop_last", [True, False])
def test_prefetch_loader_one_thread_matches_jax(folder, drop_last):
    """At one worker the draws are a function of the seed: every batch of
    the recipe's train transform (RandAugment, random interpolation) equals
    JAX's."""
    aug, jaug = _augments("rand")
    root = os.path.join(folder, "train")
    ours = imagenet.ImageFolderDataset(root, 48, True, aug, "random")
    ref = jax_imagenet.ImageFolderDataset(root, 48, True, jaug, "random")
    idx = imagenet.ra_sampler_indices(len(ours), 2, 0)
    kw = dict(batch_size=4, indices=idx, num_threads=1, seed=2,
              drop_last=drop_last)
    got = _loader_batches(imagenet, ours, **kw)
    want = _loader_batches(jax_imagenet, ref, **kw)
    assert len(got) == len(want) == (4 if drop_last else 5)
    for (a, la), (b, lb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


class _SlowLabels:
    """Label ``idx``, a blank image; records which samples were loaded."""
    img_size = 4

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at
        self.loaded, self.lock = [], threading.Lock()

    def __len__(self):
        return self.n

    def load(self, idx, rng):
        if idx == self.fail_at:
            raise OSError(f"cannot decode sample {idx}")
        with self.lock:
            self.loaded.append(idx)
        time.sleep(0.001)
        return np.zeros((4, 4, 3), np.float32), idx


def test_prefetch_loader_three_threads_keeps_order_and_window():
    ds = _SlowLabels(64)
    idx = np.random.default_rng(0).permutation(64)
    batches = list(imagenet.PrefetchLoader(ds, 5, idx, num_threads=3,
                                           drop_last=False))
    np.testing.assert_array_equal(np.concatenate([b[1] for b in batches]), idx)
    ds = _SlowLabels(64)
    it = iter(imagenet.PrefetchLoader(ds, 1, np.arange(64), num_threads=3,
                                      prefetch=2))
    next(it)
    time.sleep(0.3)  # the workers run as far ahead as the window lets them
    # one batch taken, a window of prefetch + workers = 5 after it, and at
    # most one more a worker already past the gate
    assert len(ds.loaded) <= 1 + 5 + 3, ds.loaded
    it.close()


def test_prefetch_loader_raises_a_workers_error():
    """JAX's consumer waits forever for a batch whose worker raised; the
    port's raises the worker's error."""
    loader = imagenet.PrefetchLoader(_SlowLabels(16, fail_at=9), 4,
                                     np.arange(16), num_threads=2)
    with pytest.raises(OSError, match="sample 9"):
        list(loader)


class _DiesInAWorker(_SlowLabels):
    """Unpickles, in a spawned worker, into the worker's exit."""

    def __reduce__(self):
        return os._exit, (3,)


def test_prefetch_loader_raises_when_a_process_dies():
    """A worker that dies raises ``BrokenProcessPool``; JAX's
    ``multiprocessing.Pool`` starts another in its place and waits
    forever."""
    from concurrent.futures.process import BrokenProcessPool

    loader = imagenet.PrefetchLoader(_DiesInAWorker(8), 4, np.arange(8),
                                     num_threads=1, backend="process")
    with pytest.raises(BrokenProcessPool):
        list(loader)


def test_prefetch_loader_process_backend_keeps_order(folder):
    """Two spawned workers with the recipe's train transform: the labels in
    the sampler's order, every image transformed."""
    aug, _ = _augments("rand")
    ds = imagenet.ImageFolderDataset(os.path.join(folder, "train"), 32, True,
                                     aug)
    idx = imagenet.ra_sampler_indices(len(ds), 0, 0)
    batches = list(imagenet.PrefetchLoader(ds, 4, idx, num_threads=2,
                                           backend="process",
                                           drop_last=False))
    labels = np.array([ds.samples[i][1] for i in idx])
    np.testing.assert_array_equal(np.concatenate([b[1] for b in batches]),
                                  labels)
    assert all(b[0].shape[1:] == (32, 32, 3) and np.isfinite(b[0]).all()
               for b in batches)


@pytest.mark.parametrize("kw,rtol", [
    (dict(base_lr=5e-4, warmup_steps=10, decay_steps=30), 2e-7),
    (dict(base_lr=1e-3, warmup_steps=0, decay_steps=7, decay_rate=0.5), 1e-7),
    (dict(base_lr=2.5e-4, warmup_steps=40, decay_steps=25, decay_rate=0.1,
          warmup_init_lr=1e-7), 2e-7)])
def test_step_schedule_matches_jax(kw, rtol):
    """JAX evaluates in float32: at decay 0.1 its rounding reaches 1.6e-7 of
    the value, at decay 0.5 (exact in binary) under 1e-7."""
    from efficient_attention_tpu.training.optim import step_schedule
    from efficient_attention_torch.training.optim import step_schedule as ours

    s, ref = ours(**kw), step_schedule(**kw)
    np.testing.assert_allclose([s(i) for i in range(150)],
                               np.asarray(jax.jit(ref)(jnp.arange(150))),
                               rtol=rtol)


EVA_VIT = {"window_size": 7, "num_landmarks": 49, "attn_2d": True,
           "use_rpe": True, "adaptive_proj": "default"}
EVA_PVT = {"window_size": 2, "num_landmarks": 4, "attn_2d": True,
           "use_rpe": True, "adaptive_proj": "default"}
# (arch, attention args, input side, extra kwargs): the golden ViT geometry
# (112 px, patch 8, dim 48, 2 blocks of 4 heads) and pvt_nano at 64 px
REMAT_MODELS = {
    "vit": ("EfficientTransformer", EVA_VIT, 112,
            dict(patch_size=8, embed_dim=48, depth=2, num_heads=4)),
    "pvt": ("pvt_nano", EVA_PVT, 64, {}),
}


def _build(package, which, **kw):
    """``which`` from the port's (``efficient_attention_torch``) or JAX's
    registry or module, at ``REMAT_MODELS``' geometry."""
    import importlib

    arch, attn, side, extra = REMAT_MODELS[which]
    kw = dict(attn_name="eva", img_size=side, num_classes=10, **extra, **kw)
    kw["attn_args"] = dict(attn, impl=kw.pop("impl"))
    if which == "vit":
        mod = importlib.import_module(f"{package}.models.efficient_vit")
        return mod.EfficientTransformer(**kw)
    return importlib.import_module(f"{package}.models").create_model(arch, **kw)


def _port_model(which, remat, drop_path):
    return _build("efficient_attention_torch", which, impl="auto",
                  drop_path_rate=drop_path, checkpoint_activations=remat)


def _grads(model, x, generator):
    from efficient_attention_torch.models.layers import set_generator

    set_generator(model.train(), generator)
    with exact_float32():
        model(torch.from_numpy(x)).square().mean().backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("which", ["vit", "pvt"])
def test_remat_gradients_equal_plain_blocks(which):
    """Drop-path 0.3 and EVA's RF noise, both from one generator: the
    recompute replays the forward's draws, so every gradient is bit for bit
    the plain blocks' and the generator ends where theirs does."""
    side = REMAT_MODELS[which][2]
    x = np.random.default_rng(7).standard_normal((3, side, side, 3)).astype(
        np.float32)
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = _port_model(which, remat, 0.3)
        g = torch.Generator().manual_seed(11)
        runs.append((_grads(model, x, g), g.get_state()))
    (plain, g0), (remat, g1) = runs
    assert torch.equal(g0, g1)
    for name in plain:
        assert torch.equal(plain[name], remat[name]), name


@pytest.mark.parametrize("which", ["vit", "pvt"])
def test_remat_gradients_match_jax_remat(which, monkeypatch):
    """At drop-path 0 and zero RF noise, the port's remat gradients against
    JAX's ``nn.remat`` blocks' on the same weights, to 1e-4 of each
    gradient's peak."""
    from efficient_attention_tpu.attention.eva import EVA as JaxEVA
    from efficient_attention_torch.attention.eva import EVA
    from efficient_attention_torch.interop import (
        load_jax_params,
        state_dict_from_jax,
    )

    monkeypatch.setattr(EVA, "_sample_weights", lambda self, mu: mu)
    monkeypatch.setattr(JaxEVA, "_sample_weights",
                        lambda self, mu, deterministic: mu)
    side = REMAT_MODELS[which][2]
    x = np.random.default_rng(8).standard_normal((2, side, side, 3)).astype(
        np.float32)
    jm = _build("efficient_attention_tpu", which, impl="xla",
                drop_path_rate=0.0, checkpoint_activations=True)
    params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(x)), 21)
    key = jax.random.PRNGKey(1)

    def loss(p):
        out = jm.apply(p, jnp.asarray(x), deterministic=False,
                       rngs={"dropout": key, "sample": key})
        return jnp.mean(out ** 2)

    ref = state_dict_from_jax(jax.device_get(jax.jit(jax.grad(loss))(
        to_jax(params))))
    model = load_jax_params(_port_model(which, True, 0.0), params)
    got = _grads(model, x, torch.Generator().manual_seed(0))
    assert set(ref) <= set(got)
    for name, want in ref.items():
        peak = max(float(want.abs().max()), 1e-6)
        err = float((got[name] - want).abs().max())
        assert err <= 1e-4 * peak, (name, err, peak)

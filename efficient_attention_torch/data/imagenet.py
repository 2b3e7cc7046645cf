"""Image-classification input pipeline: image folders, the uint8 cache, the
synthetic dataset, the samplers and the prefetching loader.

Counterpart of ``efficient_attention_tpu/data/imagenet.py`` (reference
``vit/datasets.py``, ``vit/samplers.py``): JPEG decode, the DeiT train
transform (RandomResizedCrop, flip, RandAugment or colour jitter) and the
eval transform run on the host, in threads or in spawned processes, a
bounded window of batches ahead of the train step; erasing and mixup run on
the device in the train step.  Numpy and PIL only: the loader's workers need
neither torch nor a device, and PIL is imported only where a real image is
decoded, so the synthetic path runs without it.  With the same
``np.random.Generator`` every ``load`` returns the JAX package's array bit
for bit.

Where the port does not copy JAX's loader: a worker that raises ends the
iteration with its error, and a process that dies raises
``BrokenProcessPool`` (JAX's consumer waits for the missing batch
forever, and its ``multiprocessing.Pool`` restarts a worker that cannot
start, forever); the augment callables of ``data/randaugment.py`` pickle,
so the process backend takes the recipe's augmentation.
"""
from __future__ import annotations

import math
import os
import queue
import threading
from typing import Iterator, List, Sequence, Tuple

import numpy as np

IMAGENET_DEFAULT_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_DEFAULT_STD = np.array([0.229, 0.224, 0.225], np.float32)

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def find_classes(root: str) -> Tuple[List[str], dict]:
    """The sorted subdirectories of ``root`` and their class indices."""
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    return classes, {c: i for i, c in enumerate(classes)}


def _normalize(img, mean=IMAGENET_DEFAULT_MEAN,
               std=IMAGENET_DEFAULT_STD) -> np.ndarray:
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - mean) / std


def _train_transform(img, s: int, rng: np.random.Generator, interp,
                     augment) -> np.ndarray:
    """DeiT train transform: RandomResizedCrop (scale 0.08-1, ratio 3/4-4/3,
    10 tries, else the whole image), flip, the optional ``augment``, then
    normalisation."""
    from PIL import Image

    w, h = img.size
    for _ in range(10):
        area = w * h * rng.uniform(0.08, 1.0)
        ar = math.exp(rng.uniform(math.log(3 / 4), math.log(4 / 3)))
        cw = int(round(math.sqrt(area * ar)))
        ch = int(round(math.sqrt(area / ar)))
        if cw <= w and ch <= h:
            x0 = rng.integers(0, w - cw + 1)
            y0 = rng.integers(0, h - ch + 1)
            img = img.crop((x0, y0, x0 + cw, y0 + ch))
            break
    img = img.resize((s, s), interp)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if augment is not None:
        img = augment(img, rng)
    return _normalize(img)


def _eval_transform(img, s: int) -> np.ndarray:
    """Eval: resize the short side to ``s * 256 / 224`` (bicubic), centre
    crop ``s`` (``vit/datasets.py:60-81``), normalise."""
    from PIL import Image

    short = int(s * 256 / 224)
    w, h = img.size
    scale = short / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
    w, h = img.size
    x0, y0 = (w - s) // 2, (h - s) // 2
    img = img.crop((x0, y0, x0 + s, y0 + s))
    return _normalize(img)


class ImageFolderDataset:
    """``root/<class>/<image>``, classes sorted, images sorted in each
    (torchvision ``ImageFolder``).  ``augment`` is an optional
    ``fn(PIL.Image, rng) -> PIL.Image`` run after the crop and flip;
    ``interpolation`` is timm's ``--train-interpolation``: ``bicubic``,
    ``bilinear``, ``nearest``, or ``random`` (bicubic or bilinear, drawn per
    sample)."""

    def __init__(self, root: str, img_size: int = 224, train: bool = True,
                 augment=None, interpolation: str = "bicubic"):
        self.root = root
        self.img_size = img_size
        self.train = train
        self.augment = augment
        self.interpolation = interpolation
        classes, class_to_idx = find_classes(root)
        self.classes = classes
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append(
                        (os.path.join(cdir, fname), class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def _interp(self, rng):
        from PIL import Image

        table = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR,
                 "nearest": Image.NEAREST}
        name = self.interpolation
        if name == "random":
            name = "bicubic" if rng.random() < 0.5 else "bilinear"
        return table[name]

    def _transform(self, img, rng) -> np.ndarray:
        if self.train:
            return _train_transform(img, self.img_size, rng,
                                    self._interp(rng), self.augment)
        return _eval_transform(img, self.img_size)

    def load(self, idx: int, rng: np.random.Generator) -> Tuple[np.ndarray, int]:
        from PIL import Image

        path, label = self.samples[idx]
        with Image.open(path) as f:
            img = f.convert("RGB")
        return self._transform(img, rng), label


class CachedUint8Dataset(ImageFolderDataset):
    """An image folder decoded once into a uint8 array pair
    (``<path>.imgs.npy`` ``[N, side, side, 3]``, memory-mapped, and
    ``<path>.labels.npy``): each image's short side resized to ``side``
    (bicubic) and centre-cropped square.  ``load`` then crops and resizes
    an array, with no entropy decode, through the same transforms as
    :class:`ImageFolderDataset` (training on pre-resized images, the usual
    trade)."""

    def __init__(self, cache_path: str, img_size: int = 224,
                 train: bool = True, augment=None,
                 interpolation: str = "bicubic"):
        self.cache_path = cache_path
        self.img_size = img_size
        self.train = train
        self.augment = augment
        self.interpolation = interpolation
        self.images = np.load(cache_path + ".imgs.npy", mmap_mode="r")
        self.labels = np.load(cache_path + ".labels.npy")

    def __getstate__(self):
        # a spawned worker maps the file itself rather than receive a copy
        # of every image through the pickle
        return {k: v for k, v in self.__dict__.items() if k != "images"}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.images = np.load(self.cache_path + ".imgs.npy", mmap_mode="r")

    @staticmethod
    def build(root: str, cache_path: str, cache_side: int = 256,
              log_every: int = 0, num_workers: int = 1) -> None:
        """Decode the image folder ``root`` into the cache at
        ``cache_path`` on ``num_workers`` spawned processes (the JAX
        package's two files byte for byte, which it decodes in one
        process)."""
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        samples = ImageFolderDataset(root, img_size=cache_side,
                                     train=False).samples
        n = len(samples)
        imgs = np.lib.format.open_memmap(
            cache_path + ".imgs.npy", mode="w+", dtype=np.uint8,
            shape=(n, cache_side, cache_side, 3))
        del imgs  # the chunks map the file themselves
        chunks = [(cache_path + ".imgs.npy", start,
                   [path for path, _ in samples[start:start + 64]], cache_side)
                  for start in range(0, n, 64)]
        with ProcessPoolExecutor(max(1, num_workers),
                                 mp_context=mp.get_context("spawn")) as pool:
            for count in pool.map(_cache_chunk, chunks):
                if log_every and count % log_every < 64:
                    print(f"| cached {count}/{n}", flush=True)
        np.save(cache_path + ".labels.npy",
                np.array([label for _, label in samples], np.int32))

    def __len__(self):
        return len(self.labels)

    def load(self, idx: int, rng: np.random.Generator) -> Tuple[np.ndarray, int]:
        from PIL import Image

        img = Image.fromarray(np.asarray(self.images[idx]))
        return self._transform(img, rng), int(self.labels[idx])


def _cache_chunk(args) -> int:
    """Decode ``paths`` into rows ``start..`` of the cache file: the short
    side resized to ``side`` (bicubic, at least ``side``), centre-cropped
    square.  Returns the images cached up to the chunk's end."""
    from PIL import Image

    file, start, paths, side = args
    imgs = np.load(file, mmap_mode="r+")
    for i, path in enumerate(paths):
        with Image.open(path) as f:
            img = f.convert("RGB")
        w, h = img.size
        scale = side / min(w, h)
        img = img.resize((max(side, round(w * scale)),
                          max(side, round(h * scale))), Image.BICUBIC)
        w, h = img.size
        x0, y0 = (w - side) // 2, (h - side) // 2
        imgs[start + i] = np.asarray(
            img.crop((x0, y0, x0 + side, y0 + side)), np.uint8)
    imgs.flush()
    return start + len(paths)


class SyntheticImageDataset:
    """Deterministic random images (fairseq ``benchmark/dummy_*``
    analogue): image ``idx`` is drawn from ``default_rng(idx)``, label
    ``idx % num_classes``, for training and eval alike; ``rng`` is unused."""

    def __init__(self, num_samples: int = 1280, img_size: int = 224,
                 num_classes: int = 1000, train: bool = True):
        self.num_samples = num_samples
        self.img_size = img_size
        self.num_classes = num_classes
        self.classes = [str(i) for i in range(num_classes)]

    def __len__(self):
        return self.num_samples

    def load(self, idx: int, rng: np.random.Generator) -> Tuple[np.ndarray, int]:
        r = np.random.default_rng(idx)
        img = r.standard_normal(
            (self.img_size, self.img_size, 3)).astype(np.float32)
        return img, int(idx % self.num_classes)


def ra_sampler_indices(
    n: int, epoch: int, seed: int = 0, num_replicas: int = 1, rank: int = 0,
    repetitions: int = 3,
) -> np.ndarray:
    """One epoch of DeiT's repeated-augmentation sampler
    (``vit/samplers.py:13-64``) for replica ``rank``: a permutation seeded by
    ``seed + epoch``, each image ``repetitions`` times in a row, dealt
    round-robin over the replicas, then cut to
    ``floor(n / 256) * 256 / num_replicas`` samples (uncut where that is 0).
    So an epoch holds about ``n / num_replicas`` samples, not three times
    as many."""
    rng = np.random.default_rng(seed + epoch)
    order = rng.permutation(n)
    repeated = np.repeat(order, repetitions)
    total = int(math.ceil(len(repeated) / num_replicas)) * num_replicas
    repeated = np.concatenate([repeated, repeated[: total - len(repeated)]])
    shard = repeated[rank::num_replicas]
    num_selected = (n // 256) * 256 // num_replicas
    if num_selected > 0:
        shard = shard[:num_selected]
    return shard


def shard_indices(n: int, epoch: int, seed: int = 0, num_replicas: int = 1,
                  rank: int = 0, shuffle: bool = True) -> np.ndarray:
    """One epoch's sample order for replica ``rank`` (torch
    ``DistributedSampler``; JAX ``data/imagenet.py:238-245``): a permutation
    seeded by ``seed + epoch``, padded to a multiple of the replicas."""
    rng = np.random.default_rng(seed + epoch)
    order = rng.permutation(n) if shuffle else np.arange(n)
    total = int(math.ceil(n / num_replicas)) * num_replicas
    order = np.concatenate([order, order[: total - n]])
    return order[rank::num_replicas]


def _load_batch(dataset, idx, rng) -> Tuple[np.ndarray, np.ndarray]:
    imgs = np.empty((len(idx), dataset.img_size, dataset.img_size, 3),
                    np.float32)
    labels = np.empty((len(idx),), np.int32)
    for j, k in enumerate(idx):
        imgs[j], labels[j] = dataset.load(int(k), rng)
    return imgs, labels


def _pool_init(dataset, seed):
    """A spawned worker's initialiser: the dataset is unpickled once a
    worker, and the worker draws from its own generator (JAX's seeding,
    ``seed * 1000 + pid``, so the draws depend on the process ids)."""
    global _POOL_DS, _POOL_RNG
    _POOL_DS = dataset
    _POOL_RNG = np.random.default_rng(seed * 1000 + os.getpid())


def _pool_load(args):
    """Load batch ``i`` and spill its images to ``spill/<i>.npy``: on the
    H100 machine the page cache moves a batch many times faster than the
    pool's pipe (``scripts/torch_loader_transfer.py``, ``PERF.md`` §5)."""
    i, idx, spill = args
    imgs, labels = _load_batch(_POOL_DS, idx, _POOL_RNG)
    path = os.path.join(spill, f"{i}.npy")
    np.save(path, imgs)
    return i, path, labels


class PrefetchLoader:
    """Batches ``(images [b, S, S, 3] float32, labels [b] int32)`` of
    ``dataset`` over ``indices`` in order, loaded by ``num_threads``
    workers ahead of the consumer (the torch ``DataLoader`` workers of
    ``vit/main.py:236-257``).

    Scheduling is a bounded in-order window: no batch is started more than
    ``prefetch + num_threads`` batches ahead of the one last handed out.
    ``backend='thread'``: worker ``tid`` draws from
    ``default_rng(seed * 1000 + tid)`` and takes the next batch when free,
    so with one worker the draws are a function of ``seed`` alone.
    ``backend='process'``: a spawn-context ``ProcessPoolExecutor`` (fork is
    unsafe beside a CUDA context) whose workers unpickle ``dataset`` and
    import only this module's dependencies, and the main module where it
    is a file; the dataset and its augment must pickle.  Each batch's
    images pass through a ``.npy`` file in a temporary directory, read back
    on two threads and removed.
    ``drop_last`` drops a last partial batch."""

    def __init__(self, dataset, batch_size: int, indices: Sequence[int],
                 num_threads: int = 8, prefetch: int = 4, seed: int = 0,
                 drop_last: bool = True, backend: str = "thread"):
        if backend not in ("thread", "process"):
            raise ValueError(f"backend={backend}")
        if num_threads < 1:
            raise ValueError(f"num_threads={num_threads}: at least 1 worker")
        self.dataset = dataset
        self.batch_size = batch_size
        self.indices = np.asarray(indices)
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        self.backend = backend

    def __len__(self):
        if self.drop_last:
            return len(self.indices) // self.batch_size
        return math.ceil(len(self.indices) / self.batch_size)

    def _batches(self):
        return [
            self.indices[i * self.batch_size:(i + 1) * self.batch_size]
            for i in range(len(self))]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self.backend == "process":
            yield from self._iter_processes()
        else:
            yield from self._iter_threads()

    def _iter_threads(self):
        n_batches = len(self)
        window = self.prefetch + self.num_threads
        q: "queue.Queue" = queue.Queue()
        batches = self._batches()
        cond = threading.Condition()
        state = {"next": 0, "emit": 0}
        done = threading.Event()

        def worker(tid: int):
            rng = np.random.default_rng(self.seed * 1000 + tid)
            while not done.is_set():
                with cond:
                    while (state["next"] < n_batches
                           and state["next"] - state["emit"] >= window
                           and not done.is_set()):
                        cond.wait(0.1)
                    i = state["next"]
                    if i >= n_batches or done.is_set():
                        return
                    state["next"] = i + 1
                try:
                    q.put((i, _load_batch(self.dataset, batches[i], rng)))
                except Exception as err:  # raised by the consumer
                    q.put((i, err))
                    return

        threads = [threading.Thread(target=worker, args=(t,), daemon=True)
                   for t in range(self.num_threads)]
        for t in threads:
            t.start()
        try:
            next_emit = 0
            results: dict = {}
            while next_emit < n_batches:
                i, got = q.get()
                if isinstance(got, BaseException):
                    raise got
                results[i] = got
                while next_emit in results:
                    yield results.pop(next_emit)
                    next_emit += 1
                    with cond:
                        state["emit"] = next_emit
                        cond.notify_all()
        finally:
            done.set()
            with cond:
                cond.notify_all()

    def _iter_processes(self):
        import multiprocessing as mp
        import shutil
        import tempfile
        from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

        n_batches = len(self)
        batches = self._batches()
        window = self.prefetch + self.num_threads
        spill = tempfile.mkdtemp(prefix="prefetch-")
        pool = ProcessPoolExecutor(
            self.num_threads, mp_context=mp.get_context("spawn"),
            initializer=_pool_init, initargs=(self.dataset, self.seed))
        # two threads read the spilled batches back, off the consumer's
        # thread (a file read releases the GIL)
        reader = ThreadPoolExecutor(2)

        def read(future):
            i, path, labels = future.result()
            imgs = np.load(path)
            os.remove(path)
            return i, imgs, labels

        try:
            pending: dict = {}
            submitted = 0
            next_emit = 0
            while next_emit < n_batches:
                while submitted < n_batches and submitted - next_emit < window:
                    pending[submitted] = reader.submit(read, pool.submit(
                        _pool_load, (submitted, batches[submitted], spill)))
                    submitted += 1
                i, imgs, labels = pending.pop(next_emit).result()
                assert i == next_emit
                yield imgs, labels
                next_emit += 1
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
            reader.shutdown(wait=True, cancel_futures=True)
            shutil.rmtree(spill, ignore_errors=True)

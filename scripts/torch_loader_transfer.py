#!/usr/bin/env python3
"""How fast one loader batch moves from a spawned worker to the main process.

The image loader's process backend (``efficient_attention_torch/data/
imagenet.py::PrefetchLoader``) hands each batch of ``B x 224 x 224 x 3``
float32 images (77 MB at B=128) from a spawned worker to the consumer.  This
script times three ways of doing it, each over ``--batches`` batches, and
prints one JSON line of MB/s, timed from the first batch's arrival (the
worker's start-up left out) to the last's:

* ``pipe``: the array sent through a ``multiprocessing`` pipe, as a pool
  returns a result;
* ``shared_memory``: written into a ``SharedMemory`` block by the worker,
  copied out and unlinked by the consumer;
* ``file``: ``np.save`` to a file by the worker, ``np.load`` and remove by
  the consumer (what the loader does).

Run from the root of a checkout:  python3 scripts/torch_loader_transfer.py
"""
import argparse
import json
import os
import tempfile
import time


def _pipe_worker(conn, shape, n):
    import numpy as np

    batch = np.ones(shape, np.float32)
    for _ in range(n):
        conn.send(batch)
    conn.close()


def _shm_worker(queue, shape, n):
    import numpy as np
    from multiprocessing import resource_tracker, shared_memory

    batch = np.ones(shape, np.float32)
    for _ in range(n):
        shm = shared_memory.SharedMemory(create=True, size=batch.nbytes)
        np.ndarray(shape, np.float32, buffer=shm.buf)[...] = batch
        resource_tracker.unregister(shm._name, "shared_memory")  # the reader unlinks
        queue.put(shm.name)
        shm.close()


def _file_worker(queue, shape, n, directory):
    import numpy as np

    batch = np.ones(shape, np.float32)
    for i in range(n):
        path = os.path.join(directory, f"{i}.npy")
        np.save(path, batch)
        queue.put(path)


def main() -> int:
    import multiprocessing as mp
    from multiprocessing import shared_memory

    import numpy as np

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--batches", type=int, default=5)
    args = parser.parse_args()
    shape = (args.batch, args.size, args.size, 3)
    nbytes = int(np.prod(shape)) * 4 * (args.batches - 1)
    ctx = mp.get_context("spawn")
    rates = {}

    reader, writer = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_pipe_worker, args=(writer, shape, args.batches))
    proc.start()
    writer.close()
    for i in range(args.batches):
        reader.recv()
        t0 = time.perf_counter() if i == 0 else t0
    rates["pipe"] = nbytes / (time.perf_counter() - t0) / 1e6
    proc.join()

    queue = ctx.Queue()
    proc = ctx.Process(target=_shm_worker, args=(queue, shape, args.batches))
    proc.start()
    for i in range(args.batches):
        shm = shared_memory.SharedMemory(name=queue.get())
        np.ndarray(shape, np.float32, buffer=shm.buf).copy()
        shm.close()
        shm.unlink()
        t0 = time.perf_counter() if i == 0 else t0
    rates["shared_memory"] = nbytes / (time.perf_counter() - t0) / 1e6
    proc.join()

    with tempfile.TemporaryDirectory(prefix="transfer-") as directory:
        proc = ctx.Process(target=_file_worker,
                           args=(queue, shape, args.batches, directory))
        proc.start()
        for i in range(args.batches):
            path = queue.get()
            np.load(path)
            os.remove(path)
            t0 = time.perf_counter() if i == 0 else t0
        rates["file"] = nbytes / (time.perf_counter() - t0) / 1e6
        proc.join()
    print(json.dumps({"batch_bytes": nbytes // (args.batches - 1),
                      "MB_per_s": rates, "cpus": os.cpu_count()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

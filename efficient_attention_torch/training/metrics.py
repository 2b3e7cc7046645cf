"""Metric logging: smoothed meters and a logger with JSON-lines output.

The port's own copy of ``efficient_attention_tpu/training/metrics.py``
(itself a rebuild of ``vit/utils.py:24-167``, ``SmoothedValue`` and
``MetricLogger``), which is numpy-only.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict, deque
from typing import Dict

import numpy as np


class SmoothedValue:
    """Windowed + global average meter (``vit/utils.py:24-83``)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value)


class MetricLogger:
    """Iteration logger (``vit/utils.py:86-167``)."""

    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_fn = print_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(v)

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def log_every(self, iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        end = time.time()
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                msg = [header, f"[{i}" + (f"/{total}]" if total else "]"),
                       str(self), f"time: {iter_time}"]
                self.print_fn(self.delimiter.join(m for m in msg if m))
            i += 1
            end = time.time()
        elapsed = time.time() - start
        self.print_fn(f"{header} Total time: {elapsed:.1f}s")

    def global_avg_dict(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}


def write_log_line(path: str, record: dict) -> None:
    """Append a JSON line (``vit/main.py:375-377`` log.txt convention)."""
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")

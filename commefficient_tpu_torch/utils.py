"""LR schedules, loggers, timers and the run's log directory (port of
the parts of ``commefficient_tpu/utils.py`` the trainers use)."""

from __future__ import annotations

import os
import time
from collections import namedtuple
from datetime import datetime

import numpy as np


class PiecewiseLinear(namedtuple("PiecewiseLinear", ("knots", "vals"))):
    """Piecewise-linear schedule, e.g. the triangular CIFAR LR schedule
    PiecewiseLinear([0, pivot_epoch, num_epochs], [0, lr_scale, 0])."""

    def __call__(self, t):
        return float(np.interp([t], self.knots, self.vals)[0])


def make_logdir(args) -> str:
    """``runs/<time>_<workers>/<clients>_<mode>...``, relative to the
    working directory: the run's log directory, where ``gpt2_train``
    saves the final model and tokenizer (reference utils.py:85-93)."""
    rows, cols, k, mode = args.num_rows, args.num_cols, args.k, args.mode
    sketch_str = f"{mode}: {rows} x {cols}" if mode == "sketch" else f"{mode}"
    k_str = f"k: {k}" if mode in ["sketch", "true_topk", "local_topk"] else ""
    clients_str = f"{args.num_workers}/{args.num_clients}"
    current_time = datetime.now().strftime("%b%d_%H-%M-%S")
    return os.path.join(
        "runs",
        current_time + "_" + clients_str + "_" + sketch_str + "_" + k_str)


class TableLogger:
    """Fixed-width stdout table."""

    def append(self, output):
        if not hasattr(self, "keys"):
            self.keys = output.keys()
            print(*("{:>12s}".format(k) for k in self.keys))
        filtered = [output[k] for k in self.keys]
        print(*("{:12.4f}".format(v)
                if isinstance(v, (float, np.floating)) else "{:12}".format(v)
                for v in filtered))


class Timer:
    """Wall-clock phase timer."""

    def __init__(self):
        self.times = [time.time()]
        self.total_time = 0.0

    def __call__(self, include_in_total=True):
        self.times.append(time.time())
        delta_t = self.times[-1] - self.times[-2]
        if include_in_total:
            self.total_time += delta_t
        return delta_t


def steps_per_epoch(local_batch_size: int, dataset, num_workers: int) -> int:
    """Rounds per epoch: num_clients / num_workers when the local batch
    is the client's whole dataset, else ceil(len(ds) / (lbs * W))."""
    if local_batch_size == -1:
        return int(dataset.num_clients // num_workers)
    batch_size = local_batch_size * num_workers
    return int(np.ceil(len(dataset) / batch_size))

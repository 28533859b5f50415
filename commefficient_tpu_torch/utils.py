"""LR schedules, loggers, timers, the run's log directory and the
trainers' SIGTERM handling (port of the parts of
``commefficient_tpu/utils.py`` the trainers use), and the flags of the
repo's recipe scripts (``recipe_argv``)."""

from __future__ import annotations

import os
import shlex
import signal
import threading
import time
from collections import namedtuple
from contextlib import contextmanager
from datetime import datetime

import numpy as np


class GracefulShutdown(Exception):
    """Raised in the main thread when a termination signal arrives
    (``sigterm_raises``; reference utils.py:21-30). Unwinds the round
    loop so the trainer can drop the cut round (``FedModel.interrupted``)
    and close the store (``finalize``) instead of dying mid-write; the
    last round-cadence autosave is where the run resumes."""

    def __init__(self, signum: int):
        super().__init__(f"received signal {signum}")
        self.signum = signum


@contextmanager
def sigterm_raises(signums=(signal.SIGTERM,)):
    """Install handlers that raise ``GracefulShutdown``, restoring the
    previous ones on exit (reference utils.py:33-53). A no-op outside
    the main thread, where ``signal.signal`` is illegal."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def _handler(signum, frame):
        raise GracefulShutdown(signum)

    prev = {}
    for s in signums:
        prev[s] = signal.signal(s, _handler)
    try:
        yield
    finally:
        for s, h in prev.items():
            signal.signal(s, h)


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


def recipe_argv(script: str, values=None) -> list:
    """The trainer flags of a recipe script (``scripts/*.sh``): the
    arguments of its ``python -m ...`` command, continuation lines
    joined, ``"$@"`` dropped. A flag whose value is a shell variable
    (``--dataset_dir "$DATASET_DIR"``) takes ``values[name]``, or is
    dropped with its flag where ``values`` has no such name."""
    with open(script) as f:
        text = f.read().replace("\\\n", " ")
    (line,) = [ln for ln in text.splitlines()
               if ln.strip().startswith("python")]
    words = shlex.split(line)[3:]
    values = values or {}
    out = []
    for word in words:
        if word == "$@":
            continue
        if word.startswith("$"):
            flag = out.pop()
            if word[1:] in values:
                out += [flag, str(values[word[1:]])]
            continue
        out.append(word)
    return out

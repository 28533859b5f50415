"""Where the time of one full-width federated round goes, on the card.

    python -m commefficient_tpu_torch.profile_round [--rounds 8]
        [--model resnet9|gpt2|<CV model>] [--sketch_dtype f32|bf16|int8|fp8]
        [trainer flags ...]

Runs a main path's configuration through FedModel/FedOptimizer, on the
sketch table's wire dtype ``--sketch_dtype`` (default f32), and prints
JSON lines. Any other flags are the trainer's and go after the main
path's own, e.g. ``--mode local_topk --error_type local`` to profile
another mode's round. ``resnet9``: full width, bf16, Synthetic data, 8
clients x 8 samples, a 5 x 524 288 sketch, k = 50 000. ``gpt2``: GPT-2
124M double heads, bf16, fused cross-entropy, 4 clients x 8 PersonaChat
items of 2 candidates x 256 tokens (a vocabulary and corpus fabricated
offline in a temporary directory), the same sketch and k. Any other
CV model of the registry runs on the ``resnet9`` flags, built as
``cv_train.main`` builds it (running statistics under ``--batchnorm``,
the Fixup LR groups); an image dataset (``--dataset_name EMNIST``,
``CIFAR10``, ``CIFAR100``) without a ``--dataset_dir`` gets the smoke
fixture of ``data/fixtures.py`` in the temporary directory, e.g.
``--model ResNet101LN --dataset_name EMNIST`` (f32: the ResNet family
has no bf16). ``--model gpt2 --attn_impl flash [--remat]`` profiles
the GPT-2 round through the flash attention kernels (and with each
block recomputed in the backward):

- ``round_wall``: wall seconds per round, data pull included, with no
  added syncs and no profiler (the round ends when its metrics reach
  the host; pipelined, when it is dispatched and a due flush is done,
  so the mean is the figure to read);
- ``phases``: mean seconds per round of the data pull, the client
  half and the server half, each closed by ``torch.cuda.synchronize``
  (syncs serialise what would overlap, so these sum to more than a
  plain round), and of ``--pipeline_depth``'s flushes (the replayed
  accounting; 0 at depth 1);
- ``host_syncs``: the host syncs of one round's client half and of
  its server half, counted as the warnings that
  ``torch.cuda.set_sync_debug_mode("warn")`` raises in each; under
  ``--pipeline_depth N`` > 1 also the flushes over N rounds that waited
  on the card (one event wait each, which the debug mode does not
  count) and the syncs inside them;
- ``device``: ``torch.profiler`` over as many more rounds: device
  busy time per round, its share of the profiled wall time, and the
  kernels and copies with the most device time.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
import warnings

import numpy as np
import torch

from commefficient_tpu_torch.config import SKETCH_DTYPES, parse_args
from commefficient_tpu_torch.data.fixtures import write_fixture
from commefficient_tpu_torch.device import resolve_device
from commefficient_tpu_torch.ops.flce import resolve_fused_ce
from commefficient_tpu_torch.runtime import FedModel, FedOptimizer
from commefficient_tpu_torch.train import cv_train, gpt2_train

FIXTURE_DATASETS = ("EMNIST", "CIFAR10", "CIFAR100")
ARGV = ["--dataset_name", "Synthetic", "--mode", "sketch",
        "--error_type", "virtual", "--virtual_momentum", "0.9",
        "--local_momentum", "0", "--num_rows", "5", "--num_cols", "524288",
        "--k", "50000", "--num_workers", "8", "--local_batch_size", "8",
        "--bf16", "--seed", "21", "--num_devices", "1"]


def _device_us(evt) -> float:
    return float(evt.self_device_time_total)


def _host_syncs(fn) -> int:
    """Host syncs in fn(): the warnings that sync debug mode "warn"
    raises in it."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def gpt2_argv(data_dir, vocab_dir):
    """The GPT-2 main path: scripts/gpt2_personachat.sh's flags (exact
    top-k), one epoch of the corpus."""
    return ["--dataset_name", "PERSONA", "--dataset_dir", data_dir,
            "--model_checkpoint", vocab_dir, "--mode", "sketch",
            "--error_type", "virtual", "--local_momentum", "0",
            "--virtual_momentum", "0.9", "--num_workers", "4",
            "--local_batch_size", "8", "--valid_batch_size", "8",
            "--num_candidates", "2", "--max_history", "2",
            "--lr_scale", "4e-2", "--k", "50000", "--num_rows", "5",
            "--num_cols", "524288", "--bf16", "--fused_ce", "on",
            "--num_epochs", "1", "--num_devices", "1"]


def _cv(model, wire, extra, root):
    """FedModel/FedOptimizer built as ``cv_train.main`` builds them
    (running statistics under ``--batchnorm``, the Fixup LR groups) on
    the CV main path's flags with ``extra`` after them. An image dataset
    without a ``--dataset_dir`` gets its smoke fixture under ``root``
    (data/fixtures.py)."""
    argv = ARGV + ["--model", model, "--sketch_dtype", wire] + list(extra)
    args = parse_args(argv=argv)
    if args.dataset_name in FIXTURE_DATASETS and "--dataset_dir" not in argv:
        args.dataset_dir = write_fixture(args.dataset_name, root)
    device = resolve_device(args.device)
    train_loader, _, train_ds = cv_train.get_data_loaders(args)
    args.num_clients = int(train_ds.num_clients)
    module, params = cv_train.build_model(args, device)
    model = cv_train.make_fed_model(module, params, args, train_loader.B,
                                    device)
    model.attach_participant_feed(train_loader.peek_next_client_ids)
    groups = cv_train.param_groups_of(args, module)
    for g in groups:
        g["lr"] *= 0.01
    return model, FedOptimizer(groups, args), train_loader


def _gpt2(root, wire, extra=()):
    data_dir, vocab_dir = gpt2_train.fabricate_assets(root)
    args = parse_args(default_lr=4e-2,
                      argv=gpt2_argv(data_dir, vocab_dir)
                      + ["--sketch_dtype", wire] + list(extra))
    device = resolve_device(args.device)
    module, params, tok = gpt2_train.build_model_and_tokenizer(args,
                                                               device)
    fused = resolve_fused_ce(args.fused_ce, module.cfg.n_embd, device,
                             module.cfg.dtype)
    train_loader, _, train_ds = gpt2_train.get_data_loaders(args, tok)
    args.num_clients = int(train_ds.num_clients)
    model = FedModel(module, params,
                     gpt2_train.make_compute_loss_train(module, args, fused),
                     args, padded_batch_size=train_loader.B)
    model.attach_participant_feed(train_loader.peek_next_client_ids)
    return model, FedOptimizer([{"lr": 0.04}], args), train_loader


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--model", default="resnet9",
                    help="resnet9, gpt2, or a CV model of the registry "
                    "(e.g. ResNet101LN with --dataset_name EMNIST)")
    ap.add_argument("--sketch_dtype", choices=list(SKETCH_DTYPES),
                    default="f32")
    opts, extra = ap.parse_known_args(argv)
    with tempfile.TemporaryDirectory(prefix="profile_round_") as root:
        if opts.model == "gpt2":
            model, opt, train_loader = _gpt2(root, opts.sketch_dtype, extra)
        else:
            model, opt, train_loader = _cv(
                "ResNet9" if opts.model == "resnet9" else opts.model,
                opts.sketch_dtype, extra, root)
        return _profile(opts, model, opt, train_loader, extra)


def _profile(opts, model, opt, train_loader, extra=()):
    """Prints the JSON lines and returns them by phase."""
    report = {}

    def emit(obj):
        report[obj["phase"]] = obj
        print(json.dumps(obj), flush=True)

    def batches():
        while True:
            yield from train_loader

    it = batches()

    def one_round(sync=False):
        marks = [time.perf_counter()]
        batch = next(it)
        marks.append(time.perf_counter())
        model(batch)
        if sync:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        opt.step()
        if sync:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        model.flush(force=False)
        marks.append(time.perf_counter())
        return np.diff(marks)

    for _ in range(3):  # warm-up: cuDNN plans, kernel builds
        one_round(sync=True)
    torch.cuda.synchronize()

    phases = np.mean([one_round(sync=True) for _ in range(opts.rounds)], 0)
    emit({"phase": "phases", "model": opts.model,
          "sketch_dtype": opts.sketch_dtype, "trainer_flags": list(extra),
          "rounds": opts.rounds, "data_s": phases[0], "client_s": phases[1],
          "server_s": phases[2], "flush_s": phases[3]})

    depth = model.pipeline_depth
    model.flush()
    syncs = {"client": [], "server": [], "flush": []}
    waits = 0
    for _ in range(depth):
        batch = next(it)
        syncs["client"].append(_host_syncs(lambda: model(batch)))
        syncs["server"].append(_host_syncs(opt.step))
        out = []
        syncs["flush"].append(_host_syncs(
            lambda: out.extend(model.flush(force=False))))
        waits += bool(out)
    emit({"phase": "host_syncs", "pipeline_depth": depth,
          "client": syncs["client"][0], "server": syncs["server"][0],
          "per_round": syncs, "flush_waits_per_round": waits / depth})

    walls = []
    for _ in range(opts.rounds):
        r0 = time.perf_counter()
        one_round()
        walls.append(time.perf_counter() - r0)
    model.flush()
    emit({"phase": "round_wall", "seconds": walls,
          "median_s": float(np.median(walls)),
          "mean_s": float(np.mean(walls)),
          "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2**30})

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(opts.rounds):
            one_round()
        model.flush()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    # kernels and copies only: an aten op's row can repeat its
    # kernel's device time
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in events)
    events.sort(key=_device_us, reverse=True)
    emit({
        "phase": "device", "window_s": window,
        "busy_ms_per_round": busy_us / 1e3 / opts.rounds,
        "busy_share": busy_us / 1e6 / window,
        "top": [{"name": e.key[:90], "calls": e.count,
                 "ms_per_round": _device_us(e) / 1e3 / opts.rounds}
                for e in events[:opts.top]]})
    return report


if __name__ == "__main__":
    main()

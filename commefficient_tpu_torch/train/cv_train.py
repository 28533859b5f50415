"""CV trainer -- port of ``commefficient_tpu/train/cv_train.py``.

Same CLI (the flags the port has), same round loop: the LR scheduler
stepped *before* the round, the LR==0 "HACK STEP", the NaN abort,
fractional epochs, the byte-accounting totals and TableLogger rows;
under ``--pipeline_depth`` > 1 rounds are dispatched ahead and
processed as they are flushed (reference cv_train.py:249-266).
Runs on the card unless ``--device cpu`` is given.

Run e.g.:
    python -m commefficient_tpu_torch.train.cv_train \\
        --dataset_name Synthetic --mode sketch --error_type virtual \\
        --local_momentum 0 --virtual_momentum 0.9 --num_clients 10 \\
        --num_workers 2 --num_epochs 2 --bf16
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from commefficient_tpu_torch.config import (Config, num_classes_of_dataset,
                                            parse_args)
from commefficient_tpu_torch.data import (FedLoader, FedSampler, ValLoader,
                                          get_dataset_cls)
from commefficient_tpu_torch.device import resolve_device
from commefficient_tpu_torch.models import get_model
from commefficient_tpu_torch.runtime import (FedModel, FedOptimizer,
                                             LambdaLR, drain_rounds)
from commefficient_tpu_torch.utils import (PiecewiseLinear, TableLogger,
                                           Timer, steps_per_epoch)


def masked_mean(values, mask):
    """Mean over the last axis of the real (mask 1) entries."""
    return (torch.sum(values * mask, dim=-1)
            / torch.clamp(torch.sum(mask, dim=-1), min=1.0))


def make_compute_loss(module):
    """CE loss + accuracy (reference compute_loss_ce), masked mean over
    real samples. The batch may carry any leading axes before the
    sample axis: one forward runs over all of them, and the values
    come back per leading index (per client of a (W, B) round)."""

    def compute_loss(flat_params, batch, args):
        x = batch["x"]
        lead = batch["mask"].shape
        logits = module(flat_params, x.reshape((-1,) + x.shape[len(lead):]))
        return _ce_loss_and_acc(logits.reshape(lead + logits.shape[-1:]),
                                batch)

    return compute_loss


def _ce_loss_and_acc(logits, batch):
    labels = batch["y"].to(torch.int64)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    loss = masked_mean(nll, batch["mask"])
    acc = masked_mean((torch.argmax(logits, -1) == labels).to(torch.float32),
                      batch["mask"])
    return loss, (acc,)


def run_batches(model, opt, lr_scheduler, loader, args, training,
                epoch_fraction=1.0, round_times=None, round_losses=None):
    """(reference cv_train.py:177-292). ``round_times``, if given,
    receives each training round's wall seconds, from the scheduler
    step to the round's metrics on the host after ``opt.step()``
    queued the server half (so each interval also holds the previous
    round's server work); under ``--pipeline_depth`` > 1, from the
    scheduler step to the round's dispatch, and the flush that a
    dispatch triggers counts in its round. ``round_losses`` receives
    each round's sample-weighted train loss (rounds with no real
    sample give none). Pipelined rounds are processed as ``flush``
    brings them to the host, in dispatch order; the divergence stop
    fires at the flush that sees the bad loss."""
    if training:
        model.train(True)
        losses, accs = [], []
        download_total = np.zeros(model.num_clients)
        upload_total = np.zeros(model.num_clients)
        spe = len(loader)
        max_batches = max(1, int(spe * epoch_fraction))
        pending = []

        def process(metrics, i, w):
            loss, acc, download, upload = (metrics[0], metrics[1],
                                           metrics[-2], metrics[-1])
            download_total[:] += download
            upload_total[:] += upload
            if w.sum() > 0:
                losses.append(float(np.sum(loss * w) / w.sum()))
                accs.append(float(np.sum(acc * w) / w.sum()))
                if round_losses is not None:
                    round_losses.append(losses[-1])
                if not math.isfinite(losses[-1]) or \
                        losses[-1] > args.nan_threshold:
                    print(f"Stopping at batch {i}: diverged "
                          f"(loss {losses[-1]})")
                    return False
            return True

        for i, batch in enumerate(loader):
            if i >= max_batches:
                break
            t0 = time.perf_counter()
            lr_scheduler.step()
            if opt.param_groups[0]["lr"] == 0:
                # "HACK STEP": keep FedAvg's schedule aligned when the
                # triangular LR hits 0 (reference cv_train.py:198-203)
                for g in opt.param_groups:
                    g["lr"] = 1e-10
            metrics = model(batch)
            opt.step()
            w = np.asarray(batch["mask"]).sum(axis=1)
            if metrics is None:
                # pipelined: the round's results come with a flush
                pending.append((i, w))
                ok = drain_rounds(model, pending, process, force=False)
            else:
                ok = process(metrics, i, w)
            if round_times is not None:
                round_times.append(time.perf_counter() - t0)
            if not ok:
                return None
            if args.do_test:
                break
        if not drain_rounds(model, pending, process, force=True):
            return None
        if not losses:
            return (float("nan"), float("nan"),
                    download_total, upload_total)
        return (np.mean(losses), np.mean(accs),
                download_total, upload_total)
    model.train(False)
    losses, accs, counts = [], [], []
    for batch in loader:
        shard_metrics = model(batch)
        losses.extend(shard_metrics[0].tolist())
        accs.extend(shard_metrics[1].tolist())
        counts.extend(shard_metrics[-1].tolist())
        if args.do_test:
            break
    counts = np.asarray(counts)
    w = counts / max(counts.sum(), 1.0)
    return float(np.sum(losses * w)), float(np.sum(accs * w))


def train(model, opt, lr_scheduler, train_loader, val_loader, args,
          logger=None, timer=None):
    """Epoch loop (reference cv_train.py:295-361). Each result row
    also carries the epoch's per-round wall times (``round_times``) and
    train losses (``round_losses``), which the table does not print."""
    timer = timer or Timer()
    logger = logger or TableLogger()
    results = []
    for epoch in range(math.ceil(args.num_epochs)):
        epoch_fraction = min(1.0, args.num_epochs - epoch)
        round_times, round_losses = [], []
        out = run_batches(model, opt, lr_scheduler, train_loader, args,
                          training=True, epoch_fraction=epoch_fraction,
                          round_times=round_times, round_losses=round_losses)
        if out is None:
            print("NaN detected, aborting training")
            return results
        train_loss, train_acc, download, upload = out
        train_time = timer()
        val_loss, val_acc = run_batches(model, opt, lr_scheduler,
                                        val_loader, args, training=False)
        val_time = timer()
        row = {
            "epoch": epoch + 1,
            "lr": float(opt.param_groups[0]["lr"]),
            "train_time": train_time,
            "train_loss": float(train_loss),
            "train_acc": float(train_acc),
            "test_time": val_time,
            "test_loss": float(val_loss),
            "test_acc": float(val_acc),
            "down (MiB)": float(download.sum() / (1024 * 1024)),
            "up (MiB)": float(upload.sum() / (1024 * 1024)),
            "total_time": timer.total_time,
        }
        logger.append(row)
        results.append(dict(row, round_times=round_times,
                            round_losses=round_losses))
    return results


def get_data_loaders(args: Config):
    """(reference cv_train.py:364-403); Synthetic only."""
    cls = get_dataset_cls(args.dataset_name)
    common = dict(do_iid=args.do_iid, num_clients=args.num_clients,
                  seed=args.seed,
                  classes_per_client=args.classes_per_client,
                  per_class=args.synthetic_per_class,
                  separation=args.synthetic_separation,
                  num_val=args.synthetic_num_val)
    train_ds = cls(args.dataset_dir, args.dataset_name, train=True,
                   **common)
    val_ds = cls(args.dataset_dir, args.dataset_name, train=False,
                 **common)
    sampler = FedSampler(train_ds, args.num_workers,
                         args.local_batch_size, seed=args.seed)
    train_loader = FedLoader(train_ds, sampler)
    val_loader = ValLoader(val_ds, args.valid_batch_size,
                           shards_per_step=max(1, args.num_workers))
    return train_loader, val_loader, train_ds


def build_model(args: Config, device="cpu"):
    """(module, flat f32 parameters from ``args.seed``)."""
    model_cls = get_model(args.model)
    kw = dict(num_classes=num_classes_of_dataset(args.dataset_name))
    if args.do_bf16:
        kw["dtype"] = torch.bfloat16
    if args.do_test:
        kw.update(model_cls.test_config(kw["num_classes"]))
    module = model_cls(**kw)
    return module, module.init_flat(args.seed, device)


DEFAULT_LR = 0.4


def main(argv=None):
    args = parse_args(default_lr=DEFAULT_LR, argv=argv)
    device = resolve_device(args.device)
    np.random.seed(args.seed)

    if args.do_test:
        # tiny sketch like the reference smoke mode
        args.k = 10
        args.num_cols = 10
        args.num_rows = 1
        args.num_blocks = 1

    train_loader, val_loader, train_ds = get_data_loaders(args)
    if args.num_clients is None:
        args.num_clients = int(train_ds.num_clients)

    module, params = build_model(args, device)
    compute_loss = make_compute_loss(module)
    model = FedModel(module, params, compute_loss, args,
                     padded_batch_size=train_loader.B)
    opt = FedOptimizer([{"lr": 1.0}], args)

    spe = steps_per_epoch(args.local_batch_size, train_ds,
                          args.num_workers)
    horizon = args.schedule_epochs or args.num_epochs
    lambda_step = PiecewiseLinear(
        [0, args.pivot_epoch * spe, horizon * spe],
        [0, args.lr_scale, 0])
    lr_scheduler = LambdaLR(opt, lambda x: lambda_step(x))
    return train(model, opt, lr_scheduler, train_loader, val_loader, args)


if __name__ == "__main__":
    main(sys.argv[1:])

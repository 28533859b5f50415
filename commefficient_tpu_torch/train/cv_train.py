"""CV trainer -- port of ``commefficient_tpu/train/cv_train.py``.

Same CLI (the flags the port has), same round loop: the LR scheduler
stepped *before* the round, the LR==0 "HACK STEP", the NaN abort,
fractional epochs, the byte-accounting totals and TableLogger rows;
under ``--pipeline_depth`` > 1 rounds are dispatched ahead and
processed as they are flushed (reference cv_train.py:249-266). Every
CV model of the registry, sized for the dataset's samples; the Fixup LR
groups, ``--batchnorm``'s running-stats eval, ``--mixup``, and the
numpy transform stack of each dataset (Synthetic, CIFAR10/100, EMNIST).
``--finetune`` starts from ``finetune_path/<model>.pkl`` wherever its
leaves fit (``merge_finetune_params``); ``--checkpoint`` writes the
full round state ``checkpoint_path/ckpt_<model>.npz`` at the last epoch
(and every ``--checkpoint_every`` epochs, and every
``--checkpoint_every_rounds`` rounds with ``--checkpoint_keep``
snapshots; runtime/checkpoint.py), which ``--resume`` continues from,
and ends a run that did not diverge by writing
``checkpoint_path/<model>.pkl``, the pickled flax parameter tree, and
``<model>.pt``, the reference-named torch ``state_dict``
(``save_checkpoint``). A SIGTERM ends the run without a save; it
resumes from the last autosave. ``--clientstore host`` keeps the
per-client rows on the host, prefetched from the loader's lookahead
(runtime/fed_model.py). The round features
``--robust_agg``, ``--dp``, ``--do_dp`` and ``--dropout_prob`` live in
the round and the loader (core/rounds.py, data/loader.py).
Telemetry (reference cv_train.py:224-323, 581-601): the loader's wait
is the ledger's ``sampler`` span, ``--on_divergence abort`` stops the
run at the alarming round (``DivergenceAbort``, as a diverged loss
does), ``--tensorboard`` attaches the TensorBoard sink and
``--profile`` traces the first epoch (telemetry/profiler.py), both in
the run's log directory; a SIGTERM dumps the flight recorder's
``graceful_shutdown`` bundle.
Runs on the card unless ``--device cpu`` is given.

Run e.g.:
    python -m commefficient_tpu_torch.train.cv_train \\
        --dataset_name Synthetic --mode sketch --error_type virtual \\
        --local_momentum 0 --virtual_momentum 0.9 --num_clients 10 \\
        --num_workers 2 --num_epochs 2 --bf16
"""

from __future__ import annotations

import math
import os
import pickle
import re
import sys
import time
import warnings

import numpy as np
import torch

from commefficient_tpu_torch.config import (Config, num_classes_of_dataset,
                                            parse_args)
from commefficient_tpu_torch.data import (FedLoader, FedSampler, ValLoader,
                                          get_dataset_cls)
from commefficient_tpu_torch.data import transforms as T
from commefficient_tpu_torch.device import resolve_device
from commefficient_tpu_torch.models import get_model
from commefficient_tpu_torch.models.configs import get_model_config
from commefficient_tpu_torch.models.torch_export import (
    save_torch_state_dict, supports_torch_export)
from commefficient_tpu_torch.ops.vec import param_group_indices
from commefficient_tpu_torch.runtime import (FedModel, FedOptimizer,
                                             LambdaLR, drain_rounds)
from commefficient_tpu_torch.runtime.checkpoint import (
    resume_manifest_extra, setup_resume)
from commefficient_tpu_torch.parallel import mesh
from commefficient_tpu_torch.telemetry import registry
from commefficient_tpu_torch.telemetry.alarms import DivergenceAbort
from commefficient_tpu_torch.telemetry.profiler import profile_epoch
from commefficient_tpu_torch.telemetry.sinks import TensorBoardSink
from commefficient_tpu_torch.utils import (GracefulShutdown,
                                           PiecewiseLinear, TableLogger,
                                           Timer, make_logdir,
                                           sigterm_raises, steps_per_epoch)


def masked_mean(values, mask):
    """Mean over the last axis of the real (mask 1) entries."""
    return (torch.sum(values * mask, dim=-1)
            / torch.clamp(torch.sum(mask, dim=-1), min=1.0))


def _forward(module, flat_params, batch, **kw):
    """One forward over every leading axis of the batch (the W clients
    of a round, the S shards of a validation step, or none under the
    per-client ``vmap``), logits back in the batch's (..., B) shape.
    The leading axes are the groups that batch-statistics norms
    normalize on their own; a model whose norms track statistics
    (``--batchnorm``) also gets the (groups, B) mask, so padded rows
    stay out of them."""
    x, mask = batch["x"], batch["mask"]
    lead = mask.shape
    groups = math.prod(lead[:-1])
    if getattr(module, "tracks_stats", False):
        kw.setdefault("mask", mask.reshape(groups, lead[-1]))
    logits = module(flat_params, x.reshape((-1,) + x.shape[len(lead):]),
                    groups=groups, **kw)
    return logits.reshape(lead + logits.shape[-1:])


def make_compute_loss(module):
    """CE loss + accuracy (reference compute_loss_ce), masked mean over
    real samples. The batch may carry any leading axes before the
    sample axis: one forward runs over all of them, and the values
    come back per leading index (per client of a (W, B) round). Under
    ``--mixup`` the batch carries ``y_b`` and ``lam`` (``apply_mixup``)
    and the loss is lam*CE(y) + (1-lam)*CE(y_b)."""

    def compute_loss(flat_params, batch, args):
        return _ce_loss_and_acc(_forward(module, flat_params, batch), batch)

    return compute_loss


def make_compute_loss_eval(module):
    """Eval loss of a model whose norms track statistics: normalize by
    the server's running statistics ``model_state``, so the metrics do
    not depend on the eval batch's composition (reference
    cv_train.py:88-102)."""

    def compute_loss(flat_params, batch, args, model_state):
        return _ce_loss_and_acc(
            _forward(module, flat_params, batch, running=model_state), batch)

    return compute_loss


def make_bn_stats_fn(module):
    """``stats_fn(flat_params, batch) -> {site path: (W, C)}``: each
    client's raw batch statistics (masked mean and Bessel-corrected
    variance), from one train-mode forward over the round's (W, B)
    batch (reference ``make_bn_stats_fn``, cv_train.py:105-124, one
    forward a client under vmap there)."""

    def stats_fn(flat_params, batch):
        record = {}
        _forward(module, flat_params, batch, record=record)
        return record

    return stats_fn


def _ce_loss_and_acc(logits, batch):
    labels = batch["y"].to(torch.int64)
    logp = torch.log_softmax(logits, dim=-1)

    def nll_of(lab):
        return -torch.gather(logp, -1, lab[..., None])[..., 0]

    if "y_b" in batch:
        lam = batch["lam"]  # per sample: the round's lam
        y_b = batch["y_b"].to(torch.int64)
        nll = lam * nll_of(labels) + (1.0 - lam) * nll_of(y_b)
        dominant = torch.where(lam >= 0.5, labels, y_b)
    else:
        nll = nll_of(labels)
        dominant = labels
    loss = masked_mean(nll, batch["mask"])
    acc = masked_mean((torch.argmax(logits, -1) == dominant)
                      .to(torch.float32), batch["mask"])
    return loss, (acc,)


# Fixup scalar leaf names, matched as the exact final path segment
# (reference cv_train.py:127-150): the biases (bias1a/1b/2a/2b/3a/3b,
# bias1/bias2, add1a/1b/2a/2b, and the Dense head's bias) and the
# scales (scale, mul) train at 0.1x
_FIXUP_BIAS_RE = re.compile(r"\['(?:bias(?:[123][ab]?)?|add[12][ab])'\]$")
_FIXUP_SCALE_RE = re.compile(r"\['(?:scale|mul)'\]$")


def fixup_bias_name(name: str) -> bool:
    return _FIXUP_BIAS_RE.search(name) is not None


def fixup_scale_name(name: str) -> bool:
    return _FIXUP_SCALE_RE.search(name) is not None


def apply_mixup(batch, alpha, rng):
    """Host-side mixup (reference ``apply_mixup``, cv_train.py:153):
    one lam ~ Beta(alpha, alpha) a round; each client's real rows are
    mixed with a permutation of themselves (never across clients)."""
    lam = float(rng.beta(alpha, alpha)) if alpha > 0 else 1.0
    x = np.asarray(batch["x"]).copy()
    y = np.asarray(batch["y"])
    mask = np.asarray(batch["mask"])
    y_b = y.copy()
    for w in range(x.shape[0]):
        real = np.nonzero(mask[w] > 0)[0]
        if len(real) < 2:
            continue
        perm = real[rng.permutation(len(real))]
        x[w, real] = lam * x[w, real] + (1 - lam) * x[w, perm]
        y_b[w, real] = y[w, perm]
    out = dict(batch)
    out["x"] = x
    out["y_b"] = y_b
    out["lam"] = np.full_like(mask, lam)
    return out


def run_batches(model, opt, lr_scheduler, loader, args, training,
                epoch_fraction=1.0, round_times=None, round_losses=None,
                mixup_rng=None, round_hook=None, epoch=0):
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
    fires at the flush that sees the bad loss. ``mixup_rng`` (under
    ``--mixup``) mixes each round's batch before it is dispatched.
    ``round_hook(epoch)`` runs after every completed round (the
    round-cadence autosave, runtime/checkpoint.py). A
    ``DivergenceAbort`` (``--on_divergence abort``) stops it like a
    diverged loss: None, ``model.diverged`` set."""
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

        tel = model.telemetry
        it = enumerate(loader)
        try:
            while True:
                # a manual pull, so that the loader's wait is the
                # ledger's sampler span (on the previous round's record)
                with tel.span("sampler"):
                    nxt = next(it, None)
                if nxt is None:
                    break
                i, batch = nxt
                if i >= max_batches:
                    break
                t0 = time.perf_counter()
                if mixup_rng is not None:
                    batch = apply_mixup(batch, args.mixup_alpha, mixup_rng)
                lr_scheduler.step()
                if opt.param_groups[0]["lr"] == 0:
                    # "HACK STEP": keep FedAvg's schedule aligned when
                    # the triangular LR hits 0 (reference
                    # cv_train.py:198-203)
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
                if round_hook is not None:
                    round_hook(epoch)
                if args.do_test:
                    break
            if not drain_rounds(model, pending, process, force=True):
                return None
        except DivergenceAbort as e:
            # the alarm is flagged on the round's ledger record, which
            # becomes the run's last when the telemetry closes
            print(f"Stopping at round {e.round_index}: {e}")
            model.diverged = True
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
          logger=None, timer=None, start_epoch=0, epoch_hook=None,
          round_hook=None):
    """Epoch loop (reference cv_train.py:295-361) from ``start_epoch``.
    ``epoch_hook(ep)`` runs after each completed epoch and
    ``round_hook(epoch)`` after each completed round (checkpointing).
    Each result row also carries the epoch's per-round wall times
    (``round_times``) and train losses (``round_losses``), which the
    table does not print. ``--tensorboard`` and ``--profile`` write into
    the run's log directory (``make_logdir``); the telemetry closes at
    the end, an abort included."""
    timer = timer or Timer()
    logger = logger or TableLogger()
    results = []
    # one mixup stream across epochs (reference cv_train.py:316-318)
    mixup_rng = (np.random.RandomState(args.seed + 77)
                 if args.do_mixup else None)
    tel = model.telemetry
    logdir = (make_logdir(args)
              if args.use_tensorboard or args.do_profile else None)
    if args.use_tensorboard and mesh.rank() == 0:
        tel.add_sink(TensorBoardSink(logdir))
    try:
        for epoch in range(start_epoch, math.ceil(args.num_epochs)):
            epoch_fraction = min(1.0, args.num_epochs - epoch)
            round_times, round_losses = [], []
            with profile_epoch(args, epoch, start_epoch, logdir,
                               telemetry=tel):
                out = run_batches(
                    model, opt, lr_scheduler, train_loader, args,
                    training=True, epoch_fraction=epoch_fraction,
                    round_times=round_times, round_losses=round_losses,
                    mixup_rng=mixup_rng, round_hook=round_hook, epoch=epoch)
            if out is None:
                print("NaN detected, aborting training")
                # its weights are not a model: --checkpoint saves nothing
                model.diverged = True
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
            tel.epoch(row, epoch + 1)
            if epoch_hook is not None:
                epoch_hook(epoch + 1)
    finally:
        # the sinks flush and close even on an abort; finalize's close
        # is then a no-op
        tel.close()
    return results


# the datasets' sample shapes (H, W, C); the rest are 32 x 32 x 3
# (reference cv_train.py:424-427)
SAMPLE_SHAPES = {"EMNIST": (28, 28, 1), "ImageNet": (224, 224, 3)}


def get_transforms(name: str):
    """(train, val) numpy transform stacks of a dataset (reference
    cv_train.py:367-379); None for Synthetic."""
    if name in ("CIFAR10", "CIFAR100"):
        mean = T.CIFAR10_MEAN if name == "CIFAR10" else T.CIFAR100_MEAN
        std = T.CIFAR10_STD if name == "CIFAR10" else T.CIFAR100_STD
        return (T.cifar_train_transform(mean, std),
                T.cifar_val_transform(mean, std))
    if name == "EMNIST":
        return T.femnist_train_transform(), T.femnist_val_transform()
    if name == "ImageNet":
        return T.imagenet_train_transform(), T.imagenet_val_transform()
    return None, None


def get_data_loaders(args: Config):
    """(reference cv_train.py:364-403) with the numpy loader."""
    name = args.dataset_name
    cls = get_dataset_cls(name)
    train_t, val_t = get_transforms(name)
    common = dict(do_iid=args.do_iid, num_clients=args.num_clients,
                  seed=args.seed)
    if name == "Synthetic":
        common.update(classes_per_client=args.classes_per_client,
                      per_class=args.synthetic_per_class,
                      separation=args.synthetic_separation,
                      num_val=args.synthetic_num_val)
    train_ds = cls(args.dataset_dir, name, transform=train_t, train=True,
                   **common)
    val_ds = cls(args.dataset_dir, name, transform=val_t, train=False,
                 **common)
    sampler = FedSampler(train_ds, args.num_workers,
                         args.local_batch_size, seed=args.seed)
    train_loader = FedLoader(train_ds, sampler,
                             dropout_prob=args.dropout_prob,
                             dropout_seed=args.seed)
    val_loader = ValLoader(val_ds, args.valid_batch_size,
                           shards_per_step=max(1, args.num_workers))
    return train_loader, val_loader, train_ds


def build_model(args: Config, device="cpu"):
    """(module, flat f32 parameters from ``args.seed``), sized for the
    dataset's samples (reference cv_train.py:406-429)."""
    model_cls = get_model(args.model)
    kw = dict(num_classes=num_classes_of_dataset(args.dataset_name),
              sample_shape=SAMPLE_SHAPES.get(args.dataset_name, (32, 32, 3)))
    if args.model == "ResNet9":
        kw["do_batchnorm"] = args.do_batchnorm
    if args.do_bf16:
        if getattr(model_cls, "supports_bf16", False):
            kw["dtype"] = torch.bfloat16
        else:
            warnings.warn(f"--bf16 not supported by {args.model}; "
                          "training in float32")
    if args.do_test and hasattr(model_cls, "test_config"):
        kw.update(model_cls.test_config(kw["num_classes"]))
    module = model_cls(**kw)
    return module, module.init_flat(args.seed, device)


def make_fed_model(module, params, args: Config, padded_batch_size, device):
    """The FedModel of a CV model: the CE loss, and for a model whose
    norms track statistics (``--batchnorm``) the stats forward and the
    running-stats eval."""
    kw = {}
    if getattr(module, "tracks_stats", False):
        kw = dict(stats_fn=make_bn_stats_fn(module),
                  compute_loss_val=make_compute_loss_eval(module),
                  init_model_state=module.init_state(device))
    return FedModel(module, params, make_compute_loss(module), args,
                    padded_batch_size=padded_batch_size, **kw)


def param_groups_of(args: Config, module):
    """The Fixup LR groups (reference cv_train.py:537-556): bias and
    scale parameters at 0.1x, as flat-vector index groups, the
    nominal-LR group first so the logged LR is the schedule's. fedavg's
    clients run one scalar LR, so there the groups are not applied."""
    if args.model.startswith("Fixup"):
        if args.mode != "fedavg":
            bias_idx, scale_idx, other_idx = param_group_indices(
                module.leaf_shapes(), fixup_bias_name, fixup_scale_name)
            print("using fixup learning rates")
            return [{"lr": 1.0, "index": other_idx},
                    {"lr": 0.1, "index": bias_idx},
                    {"lr": 0.1, "index": scale_idx}]
        print("WARNING: fedavg uses a scalar LR; Fixup bias/scale "
              "0.1x groups are not applied")
    return [{"lr": 1.0}]


def merge_finetune_params(target: dict, source: dict):
    """Overlay ``source`` (a loaded checkpoint tree) onto ``target``
    (freshly initialised for the new dataset) wherever a leaf's path
    and shape match; the others, the classifier head when the class
    count changed, keep their fresh initialisation (reference
    ``merge_finetune_params``, cv_train.py:435-459). Returns (merged,
    the replaced paths)."""
    replaced = []

    def rec(t, s, path):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                if isinstance(s, dict) and k in s:
                    out[k] = rec(v, s[k], path + (k,))
                else:
                    replaced.append("/".join(path + (k,)))
                    out[k] = v
            return out
        if getattr(s, "shape", None) == getattr(t, "shape", None):
            return np.asarray(s)
        replaced.append("/".join(path))
        return t

    return rec(target, source, ()), replaced


def load_finetune_params(args: Config, module, params: torch.Tensor
                         ) -> torch.Tensor:
    """Load finetune_path/<model>.pkl (trained on --finetuned_from) and
    merge it into the fresh flat ``params`` (reference
    ``load_finetune_params``, cv_train.py:462-474)."""
    path = os.path.join(args.finetune_path, args.model + ".pkl")
    with open(path, "rb") as f:
        source = pickle.load(f)
    merged, replaced = merge_finetune_params(
        module.to_params_tree(params), source)
    print(f"finetune: loaded {path}; reinitialised: "
          f"{replaced or 'nothing'}")
    return module.from_jax_params(merged, params.device)


def save_checkpoint(model, args: Config):
    """The end-of-run ``--checkpoint`` (reference cv_train.py:614-637):
    ``checkpoint_path/<model>.pkl``, the pickled flax parameter tree of
    numpy arrays, and, for the families ``supports_torch_export``
    names, ``<model>.pt``, the reference-named torch ``state_dict``
    with the running statistics where the model tracks them."""
    os.makedirs(args.checkpoint_path, exist_ok=True)
    path = os.path.join(args.checkpoint_path, args.model + ".pkl")
    params = model.params()
    with open(path, "wb") as f:
        pickle.dump(params, f)
    print(f"saved checkpoint to {path}")
    if supports_torch_export(model.module):
        tpath = os.path.join(args.checkpoint_path, args.model + ".pt")
        save_torch_state_dict(model.module, params, model.model_state, tpath)
        print(f"saved torch state_dict to {tpath}")


DEFAULT_LR = 0.4


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(default_lr=DEFAULT_LR, argv=argv)
    if args.seq_devices > 1:
        # as the reference (cv_train.py:485-487)
        raise ValueError("--seq_devices is a GPT-2 trainer feature "
                         "(sequence parallelism); cv models have no "
                         "sequence axis")
    if mesh.needs_launch(args):
        # --num_devices N / --mesh CxM / several hosts: one rank a
        # device, each running this main; this host's first rank's
        # results come back (global rank 0's on host 0)
        return mesh.launch_run(args, main, argv)[0]
    device = resolve_device(args.device)
    np.random.seed(args.seed)

    model_cfg = None
    if not args.do_test:
        # per-model recommended hyperparameters onto fields left at
        # their defaults (models/configs.py)
        model_cfg = get_model_config(args.model)
        if model_cfg is not None:
            defaults = vars(parse_args(default_lr=DEFAULT_LR, argv=[]))
            applied = model_cfg.set_args(args, defaults)
            if applied:
                print(f"model config {type(model_cfg).__name__}: "
                      f"{applied}")

    if args.do_test:
        # tiny sketch like the reference smoke mode; a command-line
        # override before any round exists, so no variant can disagree
        # with it
        args.k = 10  # audit: allow(knob-mutation)
        args.num_cols = 10  # audit: allow(knob-mutation)
        args.num_rows = 1  # audit: allow(knob-mutation)
        args.num_blocks = 1

    train_loader, val_loader, train_ds = get_data_loaders(args)
    if args.num_clients is None:
        args.num_clients = int(train_ds.num_clients)

    module, params = build_model(args, device)
    if args.do_finetune:
        params = load_finetune_params(args, module, params)
    model = make_fed_model(module, params, args, train_loader.B, device)
    # the host store's prefetch follows the loader's lookahead (a no-op
    # under --clientstore device)
    model.attach_participant_feed(train_loader.peek_next_client_ids)
    opt = FedOptimizer(param_groups_of(args, module), args)

    spe = steps_per_epoch(args.local_batch_size, train_ds,
                          args.num_workers)
    if model_cfg is not None and model_cfg.lr_schedule_shape is not None:
        # the config's epoch-indexed shape x --lr_scale
        shape = model_cfg.lr_schedule_shape
        lr_scheduler = LambdaLR(opt, lambda x: args.lr_scale * shape(x / spe))
    else:
        horizon = args.schedule_epochs or args.num_epochs
        lambda_step = PiecewiseLinear(
            [0, args.pivot_epoch * spe, horizon * spe],
            [0, args.lr_scale, 0])
        lr_scheduler = LambdaLR(opt, lambda x: lambda_step(x))
    start_epoch, epoch_hook, round_hook = setup_resume(
        args, model, opt, lr_scheduler, train_loader, tag=args.model)
    interrupted = False
    try:
        with sigterm_raises():
            results = train(model, opt, lr_scheduler, train_loader,
                            val_loader, args, start_epoch=start_epoch,
                            epoch_hook=epoch_hook, round_hook=round_hook)
    except GracefulShutdown as e:
        # nothing is saved here: the last round-cadence autosave is the
        # consistent resume point, and a save now would hold a round
        # cut in half (reference cv_train.py:585-600)
        print(f"interrupted ({e}); resume from the last autosave")
        interrupted = True
        results = []
        if model.flightrec is not None:
            # the postmortem keeps the rounds the ledger may not have
            # flushed; dumped before interrupted() drops their state
            model.flightrec.dump("graceful_shutdown",
                                 context={"signal": str(e)})
        model.interrupted()
    model.finalize()
    # a manifest only for a run that wrote a ledger, never under --test
    # (reference cv_train.py)
    registry.maybe_write_manifest(
        args, mesh_shape=mesh.mesh_shape_dict(model.mesh),
        extra={"trainer": "cv_train", "epochs": len(results),
               "interrupted": interrupted,
               "diverged": bool(getattr(model, "diverged", False)),
               **resume_manifest_extra(model)})
    if (args.do_checkpoint and not interrupted and not model.diverged
            and model.rank == 0):
        # one writer on a mesh: every rank holds the same weights
        save_checkpoint(model, args)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])

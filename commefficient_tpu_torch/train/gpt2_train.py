"""GPT-2 / PersonaChat federated fine-tuning -- port of
``commefficient_tpu/train/gpt2_train.py``.

Same CLI (the flags the port has), same losses and round loop: the
double-heads training loss lm_coef*LM + mc_coef*MC per example,
validation NLL, multiple-choice accuracy and PPL over sharded
PersonaChat batches, the linear LR decay
PiecewiseLinear([0, epochs*spe], [lr_scale, 0]), the NaN abort. Runs on
the card unless ``--device cpu`` is given.

``--attn_impl flash`` runs the attention through the flash attention
kernels (``ops/attention.py``) and ``--remat`` recomputes each block in
the backward, as in the reference.

The LM term is the tied-head cross-entropy, computed without the
(tokens, vocab) logits: chunked (``models/gpt2.py``), or with
``--fused_ce on|auto`` by the fused kernels (``ops/flce.py``), one
forward over every token of the round (and one backward) where the
reference maps the loss over clients.

Pretrained weights come from ``--model_checkpoint``, as in the
reference: a ``transformers`` ``pytorch_model.bin`` (with the
directory's ``config.json``, if any, for the architecture), or a run
directory this trainer or the reference's saved (``config.json`` and
``flax_model.msgpack``); with neither the model starts from random
initialisation. Without ``--test`` the run ends by saving the model
and the tokenizer into its log directory (``runs/...``, ``make_logdir``):
``flax_model.msgpack`` and ``config.json``, and with ``--hf_export``
the HF ``config.json`` and ``pytorch_model.bin`` too. ``--finetune`` is
one validation pass and nothing else (reference gpt2_train.py:445-450);
``--dropout_prob`` drops clients in the loader. ``--checkpoint`` writes
the full round state ``checkpoint_path/ckpt_gpt2.npz`` at the last
epoch (and at ``--checkpoint_every`` / ``--checkpoint_every_rounds``),
from which ``--resume`` continues (runtime/checkpoint.py); a SIGTERM
ends the run without a save. The round ledger, probes, alarms, flight
recorder, ``--tensorboard`` and ``--profile`` are the CV trainer's
(telemetry/, train/cv_train.py).

``--robust_agg median|trimmed|clip``, ``--dp sketch`` and the legacy
``--do_dp`` run through the per-client round (``core/rounds.py``), every
client sketching its own table; the noise streams are the port's
``torch.Generator`` streams seeded by (seed, round, tag)
(privacy/mechanism.py). ``--async_buffer_size`` runs the buffered
asynchronous rounds (asyncfed/) through the FedModel, as in the CV
trainer.

``--seq_devices N --seq_impl ring|ulysses`` (with ``--num_devices``,
or every visible card) shards each client's sequences over N ranks
(``runtime/fed_model_sp.py SeqParallelFedModel``, the clients x seq
round of ``core/rounds_sp.py``), in uncompressed, sketch and true_topk
mode.

Every ``--mode`` runs. ``true_topk`` and ``uncompressed`` with virtual
state run the fused round (one forward and backward over every token);
``local_topk``, ``fedavg`` and any local state run the per-client
round, and ``--clientstore host`` keeps their per-client rows on the
host (PersonaChat's 17 568 clients hold 8.7 TB of GPT-2 error rows).

``--pipeline_depth N`` lets the host run N rounds ahead of the card
(``run_batches`` drains them, ``runtime/fed_model.py drain_rounds``).
The per-client round (``core/rounds.py``; also under ``--max_grad_norm``
and ``--microbatch_size``) runs every client's gradient under
``torch.func.vmap``, with the fused CE's and the flash attention's own
vmap rules (``ops/flce.py``, ``ops/attention.py``) or the chunked CE
without its checkpoints; beside ``--remat`` it runs the clients one
after another in plain autograd (core/grad.py ``map_clients``).

Assets are made offline (``fabricate_assets``): a full-size GPT-2-layout
vocabulary and a learnable PersonaChat-format corpus. Run e.g.:

    python -c "from commefficient_tpu_torch.train.gpt2_train import \\
        fabricate_assets; print(fabricate_assets('/tmp/persona'))"
    python -m commefficient_tpu_torch.train.gpt2_train \\
        --dataset_name PERSONA --dataset_dir /tmp/persona/data \\
        --model_checkpoint /tmp/persona/vocab --mode sketch \\
        --error_type virtual --local_momentum 0 --virtual_momentum 0.9 \\
        --num_workers 4 --local_batch_size 8 --num_rows 5 \\
        --num_cols 524288 --k 50000 --bf16 --fused_ce on
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from commefficient_tpu_torch.config import Config, parse_args
from commefficient_tpu_torch.data.fed_persona import (
    FedPERSONA, generate_learnable_personachat,
    generate_synthetic_personachat)
from commefficient_tpu_torch.data.fed_sampler import FedSampler
from commefficient_tpu_torch.data.loader import (PersonaFedLoader,
                                                 PersonaValLoader)
from commefficient_tpu_torch.data.tokenizer import (SPECIAL_TOKENS,
                                                    fabricate_bpe_vocab,
                                                    load_tokenizer)
from commefficient_tpu_torch.device import resolve_device
from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                 GPT2DoubleHeads,
                                                 config_from_saved,
                                                 convert_torch_gpt2,
                                                 lm_nll_sums_chunked,
                                                 token_nll)
from commefficient_tpu_torch.ops.attention import \
    unsupported_reason as attention_unsupported_reason
from commefficient_tpu_torch.ops.flce import (lm_nll_sums_fused,
                                              resolve_fused_ce)
from commefficient_tpu_torch.runtime import (FedModel, FedOptimizer,
                                             LambdaLR, drain_rounds)
from commefficient_tpu_torch.runtime.fed_model_sp import (
    SeqParallelFedModel, check_seq_parallel)
from commefficient_tpu_torch.runtime.checkpoint import (
    resume_manifest_extra, setup_resume)
from commefficient_tpu_torch.parallel import mesh
from commefficient_tpu_torch.telemetry import registry
from commefficient_tpu_torch.serialization import msgpack_restore
from commefficient_tpu_torch.telemetry.alarms import DivergenceAbort
from commefficient_tpu_torch.telemetry.profiler import profile_epoch
from commefficient_tpu_torch.telemetry.sinks import TensorBoardSink
from commefficient_tpu_torch.utils import (GracefulShutdown,
                                           PiecewiseLinear, TableLogger,
                                           Timer, make_logdir,
                                           sigterm_raises, steps_per_epoch)

MAX_SEQ_LEN = 256  # static pad length (persona sequences are short)


def _lm_nll_sums(module, flat, batch, tokens_per_chunk=0, fused=False):
    """Forward shared by the train and val losses over a batch with
    any leading axes before (B, N, T): hidden states and MC logits
    from the module, then the tied-head cross-entropy over every
    sequence at once. Returns per-sequence (Σnll, Σvalid), each
    (L*B*N,), the (L*B, N) MC logits and the leading shape (L, B)."""
    ids = batch["input_ids"]
    n, t = ids.shape[-2:]
    lead = tuple(ids.shape[:-2])
    h, wte, mc_logits = module(flat, ids.reshape(-1, n, t),
                               batch["mc_token_ids"].reshape(-1, n),
                               batch["token_type_ids"].reshape(-1, n, t),
                               return_hidden=True)
    labels = batch["lm_labels"].reshape(-1, t)
    kw = dict(ignore_index=-1, tokens_per_chunk=tokens_per_chunk or 1024)
    if fused:
        sn, sv = lm_nll_sums_fused(h[:, :-1], wte, labels[:, 1:],
                                   module.cfg.dtype, **kw)
    else:
        sn, sv = lm_nll_sums_chunked(h[:, :-1], wte, labels[:, 1:],
                                     module.cfg.dtype, **kw)
    return sn, sv, mc_logits, lead


def make_compute_loss_train(module, args, fused=False):
    """(reference gpt2_train.py:90-122) per example: lm_coef * its
    token-mean NLL over its valid positions + mc_coef * the MC
    cross-entropy; per client: the mask-weighted mean over its
    examples, (W,) (or one client's scalar, under the per-client
    round's ``torch.func.vmap``)."""

    def compute_loss(flat, batch, cfg):
        sn, sv, mc_logits, lead = _lm_nll_sums(
            module, flat, batch, args.tokens_per_chunk, fused)
        n = mc_logits.shape[-1]
        lm_i = sn.reshape(-1, n).sum(1) \
            / torch.clamp(sv.reshape(-1, n).sum(1), min=1.0)
        mc_nll, _ = token_nll(mc_logits[..., None, :],
                              batch["mc_labels"].reshape(-1, 1),
                              ignore_index=-1)
        losses = (cfg.lm_coef * lm_i + cfg.mc_coef * mc_nll[:, 0])
        m = batch["mask"]
        losses = losses.reshape(lead)
        loss = torch.sum(losses * m, -1) \
            / torch.clamp(torch.sum(m, -1), min=1.0)
        return loss, ()

    return compute_loss


def make_compute_loss_val(module, args, fused=False):
    """(reference gpt2_train.py:125-154) per shard: token-mean NLL over
    its real examples and MC accuracy over its real candidate slots."""

    def compute_loss(flat, batch, cfg):
        sn, sv, mc_logits, lead = _lm_nll_sums(
            module, flat, batch, args.tokens_per_chunk, fused)
        n = mc_logits.shape[-1]
        m = batch["mask"]
        w = m[..., None].expand(lead + (n,))
        nll = torch.sum((sn.reshape(lead + (n,)) * w).reshape(lead[0], -1),
                        -1) / torch.clamp(torch.sum(
                            (sv.reshape(lead + (n,)) * w).reshape(
                                lead[0], -1), -1), min=1.0)
        mc = mc_logits.reshape(lead + (n,))
        cand = batch.get("cand_mask")
        if cand is not None:
            # padded candidate slots must never win the argmax
            mc = torch.where(cand > 0, mc, float("-inf"))
        pred = torch.argmax(mc, dim=-1)
        acc = torch.sum((pred == batch["mc_labels"]) * m, -1) \
            / torch.clamp(torch.sum(m, -1), min=1.0)
        return nll, (acc,)

    return compute_loss


def run_batches(model, opt, lr_scheduler, loader, args, training,
                stats=None, round_hook=None, epoch=0):
    """(reference gpt2_train.py:157-228). Training returns the mean
    round loss (None on divergence) and, when ``stats`` is a dict,
    fills it with each round's wall seconds (``round_times``: from the
    scheduler step to the round's metrics on the host after
    ``opt.step()`` queued the server half; under ``--pipeline_depth``
    > 1, to the round's dispatch and any flush it made due), its train
    loss (``round_losses``) and the per-client download/upload byte
    totals. ``round_hook(epoch)`` runs after every completed round (the
    round-cadence autosave). Validation returns (nll, acc, ppl). The
    loader's wait is the ledger's ``sampler`` span; a
    ``DivergenceAbort`` (``--on_divergence abort``) stops training like
    a diverged loss (None, ``model.diverged`` set)."""
    if training:
        model.train(True)
        losses, round_times = [], []
        download = np.zeros(model.num_clients)
        upload = np.zeros(model.num_clients)
        pending = []

        def process(metrics, i, w):
            download[:] += metrics[-2]
            upload[:] += metrics[-1]
            # fully dropped rounds trained on nothing: excluded
            if w.sum() == 0:
                return True
            loss = float(np.sum(metrics[0] * w) / w.sum())
            losses.append(loss)
            if not math.isfinite(loss) or loss > args.nan_threshold:
                print(f"diverged at round {i} (loss {loss})")
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
                t0 = time.perf_counter()
                lr_scheduler.step()
                metrics = model(batch)
                opt.step()
                w = np.asarray(batch["mask"]).sum(axis=1)
                if metrics is None:
                    # pipelined: the round's results come with a flush
                    pending.append((i, w))
                    ok = drain_rounds(model, pending, process, force=False)
                else:
                    ok = process(metrics, i, w)
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
            print(f"Stopping at round {e.round_index}: {e}")
            model.diverged = True
            return None
        if stats is not None:
            stats.update(round_times=round_times, round_losses=losses,
                         download=download, upload=upload)
        return float(np.mean(losses)) if losses else float("nan")
    model.train(False)
    nlls, accs, counts = [], [], []
    for batch in loader:
        shard_metrics = model(batch)
        nlls.extend(shard_metrics[0].tolist())
        accs.extend(shard_metrics[1].tolist())
        counts.extend(shard_metrics[-1].tolist())
        if args.do_test:
            break
    counts = np.asarray(counts)
    w = counts / max(counts.sum(), 1.0)
    nll = float(np.sum(nlls * w))
    return nll, float(np.sum(accs * w)), float(np.exp(nll))


def train_gpt2(model, opt, lr_scheduler, train_loader, val_loader, args,
               logger=None, start_epoch=0, epoch_hook=None, round_hook=None,
               logdir=None):
    """Epoch loop (reference gpt2_train.py:231-281) from
    ``start_epoch``; ``epoch_hook(ep)`` runs after each completed epoch
    and ``round_hook(epoch)`` after each completed round. Each result row
    also carries the epoch's per-round wall times (``round_times``),
    train losses (``round_losses``) and byte totals (``down (MiB)``,
    ``up (MiB)``), which the table does not print. A divergence stops
    the loop and marks ``model.diverged``. ``--tensorboard`` and
    ``--profile`` (the first epoch's trace) write into ``logdir``
    (reference gpt2_train.py:235-251); the telemetry closes at the end,
    an abort included."""
    logger = logger or TableLogger()
    timer = Timer()
    results = []
    tel = model.telemetry
    if (args.use_tensorboard or args.do_profile) and logdir is None:
        logdir = make_logdir(args)
    if args.use_tensorboard and mesh.rank() == 0:
        tel.add_sink(TensorBoardSink(logdir))
    try:
        for epoch in range(start_epoch, math.ceil(args.num_epochs)):
            stats = {}
            with profile_epoch(args, epoch, start_epoch, logdir,
                               telemetry=tel):
                train_loss = run_batches(model, opt, lr_scheduler,
                                         train_loader, args, training=True,
                                         stats=stats, round_hook=round_hook,
                                         epoch=epoch)
            if train_loss is None:
                print("NaN detected, aborting")
                model.diverged = True
                return results
            train_time = timer()
            nll, acc, ppl = run_batches(model, opt, lr_scheduler,
                                        val_loader, args, training=False)
            val_time = timer()
            row = {"epoch": epoch + 1,
                   "lr": float(opt.param_groups[0]["lr"]),
                   "train_time": train_time, "train_loss": train_loss,
                   "val_time": val_time, "val_nll": nll, "val_acc": acc,
                   "val_ppl": ppl, "total_time": timer.total_time}
            logger.append(row)
            results.append(dict(
                row, round_times=stats["round_times"],
                round_losses=stats["round_losses"],
                **{"down (MiB)": float(stats["download"].sum() / 2**20),
                   "up (MiB)": float(stats["upload"].sum() / 2**20)}))
            tel.epoch(row, epoch + 1)
            if epoch_hook is not None:
                epoch_hook(epoch + 1)
    finally:
        tel.close()
    return results


def build_model_and_tokenizer(args: Config, device="cpu"):
    """(reference gpt2_train.py:284-351) -> (module, flat f32
    parameters, tokenizer). The architecture: ``config.json`` in the
    ``--model_checkpoint`` directory (without ``attn_impl``; a
    ``transformers`` config's vocabulary grown to the tokenizer's, so
    that the special tokens have rows, where the reference's gather
    clamps them to the last row), else the full GPT-2 geometry with
    the vocabulary's size, or with ``--test`` (or the byte tokenizer)
    the tiny config; ``--bf16``, ``--remat``
    and ``--attn_impl`` set on it (reference gpt2_train.py:313-319).
    The weights: the directory's ``pytorch_model.bin``
    (``convert_torch_gpt2``), else its ``flax_model.msgpack``, which
    needs the ``config.json`` beside it, else random ones from
    ``args.seed``. ``--attn_impl flash`` on a card at a head dim or
    compute type the kernels lack raises."""
    tokenizer = load_tokenizer(args.model_checkpoint)
    tokenizer.add_special_tokens(SPECIAL_TOKENS)
    ckpt = args.model_checkpoint if os.path.isdir(args.model_checkpoint) \
        else None
    cfg_json = os.path.join(ckpt, "config.json") if ckpt else ""
    if os.path.exists(cfg_json):
        # a saved run's (or an HF export's) config defines the
        # architecture its weights fit
        with open(cfg_json) as f:
            blob = json.load(f)
        cfg = config_from_saved(blob)
        if "model_type" in blob:
            # a transformers config (the hub's gpt2 counts 50 257 ids)
            # knows nothing of the special tokens: wte grows to the
            # tokenizer's ids, as without a config.json
            cfg = dataclasses.replace(
                cfg, vocab_size=max(cfg.vocab_size, len(tokenizer)))
    elif args.do_test or type(tokenizer).__name__ == "ByteTokenizer":
        cfg = GPT2Config.tiny()
        cfg = dataclasses.replace(
            cfg, vocab_size=max(len(tokenizer), cfg.vocab_size),
            n_positions=max(MAX_SEQ_LEN, cfg.n_positions))
    else:
        cfg = GPT2Config(vocab_size=len(tokenizer), n_positions=1024)
    if args.do_bf16:
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    if args.do_remat:
        cfg = dataclasses.replace(cfg, remat=True)
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    if cfg.attn_impl == "flash" and torch.device(device).type == "cuda":
        reason = attention_unsupported_reason(cfg.n_embd // cfg.n_head,
                                              cfg.dtype)
        if reason is not None:
            raise ValueError(f"--attn_impl flash: {reason}")
    module = GPT2DoubleHeads(cfg)
    params = load_pretrained(module, ckpt, device) if ckpt else None
    if params is None:
        params = module.init_flat(args.seed, device)
    return module, params, tokenizer


def load_pretrained(module, ckpt: str, device="cpu"):
    """The flat weights in directory ``ckpt`` for ``module``, or None
    where it holds none (reference gpt2_train.py:327-350):
    ``pytorch_model.bin`` (a ``transformers`` GPT-2 state dict of
    tensors, read with ``weights_only``), else ``flax_model.msgpack``,
    which raises without the ``config.json`` that gives its
    architecture."""
    torch_ckpt = os.path.join(ckpt, "pytorch_model.bin")
    flax_ckpt = os.path.join(ckpt, "flax_model.msgpack")
    if os.path.exists(torch_ckpt):
        sd = torch.load(torch_ckpt, map_location="cpu", weights_only=True)
        tree = convert_torch_gpt2({k: v.numpy() for k, v in sd.items()},
                                  module.cfg)
        print(f"loaded GPT-2 weights from {torch_ckpt}")
    elif os.path.exists(flax_ckpt):
        if not os.path.exists(os.path.join(ckpt, "config.json")):
            raise FileNotFoundError(
                f"{flax_ckpt} has no config.json beside it; cannot "
                "reconstruct the saved architecture")
        with open(flax_ckpt, "rb") as f:
            tree = msgpack_restore(f.read())
        print(f"loaded GPT-2 weights from {flax_ckpt}")
    else:
        return None
    return module.from_jax_params(tree, device)


def get_data_loaders(args: Config, tokenizer):
    """(reference gpt2_train.py:354-392)"""
    if args.do_test and not os.path.exists(
            os.path.join(args.dataset_dir,
                         "personachat_self_original.json")):
        if not os.path.exists(os.path.join(args.dataset_dir,
                                           "stats.json")):
            generate_synthetic_personachat(args.dataset_dir)

    common = dict(do_iid=args.do_iid, num_clients=args.num_clients,
                  seed=args.seed)
    train_ds = FedPERSONA(tokenizer, args.num_candidates, args.max_history,
                          args.personality_permutations, args.dataset_dir,
                          "PERSONA", train=True, **common)
    val_ds = FedPERSONA(tokenizer, -1, args.max_history, 1,
                        args.dataset_dir, "PERSONA", train=False, **common)
    pad_id = tokenizer.convert_tokens_to_ids(["<pad>"])[0]
    sampler = FedSampler(train_ds, args.num_workers, args.local_batch_size,
                         seed=args.seed)
    train_loader = PersonaFedLoader(train_ds, sampler, args.num_candidates,
                                    MAX_SEQ_LEN, pad_id,
                                    dropout_prob=args.dropout_prob,
                                    dropout_seed=args.seed)
    # full-candidate validation: every candidate a val item carries
    n_val = args.val_candidates
    if n_val <= 0:
        n_val = max((len(u["candidates"]) for d in val_ds.raw_val_set
                     for u in d["utterances"]), default=2)
    val_loader = PersonaValLoader(val_ds, args.valid_batch_size,
                                  max(n_val, 2), MAX_SEQ_LEN, pad_id,
                                  shards_per_step=max(1, args.num_workers))
    return train_loader, val_loader, train_ds


def fabricate_assets(root: str, num_personalities: int = 16,
                     dialogs_per_personality: int = 2,
                     utterances_per_dialog: int = 4, num_candidates: int = 2,
                     num_val_dialogs: int = 8, seed: int = 0):
    """Write a full-size GPT-2-layout vocabulary (50 257 entries) under
    ``root/vocab`` and a learnable PersonaChat-format archive over its
    words under ``root/data``; returns (dataset_dir, vocab_dir). The
    defaults give 16 clients of 8 items each: 4 rounds of 4 clients x
    8 items per epoch."""
    vocab_dir = os.path.join(root, "vocab")
    data_dir = os.path.join(root, "data")
    words = fabricate_bpe_vocab(vocab_dir, seed=seed)
    generate_learnable_personachat(
        data_dir, words, num_personalities=num_personalities,
        dialogs_per_personality=dialogs_per_personality,
        utterances_per_dialog=utterances_per_dialog,
        num_candidates=num_candidates, num_val_dialogs=num_val_dialogs,
        seed=seed)
    return data_dir, vocab_dir


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(default_lr=4e-2, argv=argv)
    if args.seq_devices > 1:
        # the sequence-parallel run's refusals, before any rank starts
        check_seq_parallel(args, mesh.resolve_world(args))
    if mesh.needs_launch(args):
        # --num_devices N / --mesh CxM / several hosts: one rank a
        # device, each running this main; this host's first rank's
        # results come back (global rank 0's on host 0)
        return mesh.launch_run(args, main, argv)[0]
    device = resolve_device(args.device)
    np.random.seed(args.seed)
    # as the reference (gpt2_train.py:401); nothing reads it
    args.num_results_train = 1

    if args.do_test:
        # tiny sketch like the reference smoke mode; a command-line
        # override before any round exists, so no variant can disagree
        # with it
        args.k = 10  # audit: allow(knob-mutation)
        args.num_cols = 100  # audit: allow(knob-mutation)
        args.num_rows = 1  # audit: allow(knob-mutation)
        args.num_blocks = 1

    module, params, tokenizer = build_model_and_tokenizer(args, device)
    # remat from --remat or from a saved config.json: the per-client
    # round reads it from the flags (core/grad.py map_clients)
    args.do_remat = module.cfg.remat
    args.validate_runtime()
    fused = resolve_fused_ce(args.fused_ce, module.cfg.n_embd, device,
                             module.cfg.dtype)
    print(f"fused_ce {args.fused_ce}: "
          f"{'fused kernels' if fused else 'chunked'} LM loss")
    train_loader, val_loader, train_ds = get_data_loaders(args, tokenizer)
    if args.num_clients is None:
        args.num_clients = int(train_ds.num_clients)

    loss = make_compute_loss_train(module, args, fused)
    kw = dict(compute_loss_val=make_compute_loss_val(module, args, fused),
              padded_batch_size=train_loader.B)
    if args.seq_devices > 1:
        # the clients x seq round (its LM term is always the chunked
        # CE); validation and the server step are the base FedModel's
        model = SeqParallelFedModel(module, params, loss, args,
                                    gpt2_cfg=module.cfg, **kw)
    else:
        model = FedModel(module, params, loss, args, **kw)
    # the host store's prefetch follows the loader's lookahead
    model.attach_participant_feed(train_loader.peek_next_client_ids)
    opt = FedOptimizer([{"lr": 1.0}], args)

    spe = steps_per_epoch(args.local_batch_size, train_ds, args.num_workers)
    horizon = args.schedule_epochs or args.num_epochs
    lambda_step = PiecewiseLinear([0, horizon * spe], [args.lr_scale, 0])
    lr_scheduler = LambdaLR(opt, lambda x: lambda_step(x))

    if args.do_finetune:
        # --finetune is evaluation only (reference gpt2_train.py:445-450)
        out = run_batches(model, opt, lr_scheduler, val_loader, args,
                          training=False)
        print({"val_nll": out[0], "val_acc": out[1], "val_ppl": out[2]})
        return out

    start_epoch, epoch_hook, round_hook = setup_resume(
        args, model, opt, lr_scheduler, train_loader, tag="gpt2")
    if args.eval_before_start and start_epoch == 0:
        # skipped on resume: the restored model is not "before start"
        out = run_batches(model, opt, lr_scheduler, val_loader, args,
                          training=False)
        print({"epoch": 0, "val_nll": out[0], "val_acc": out[1],
               "val_ppl": out[2]})
    # one log directory a run, for the final save (reference
    # gpt2_train.py:466-468)
    # (rank 0's alone on a mesh)
    logdir = (make_logdir(args) if not args.do_test and mesh.rank() == 0
              else None)
    interrupted = False
    try:
        with sigterm_raises():
            results = train_gpt2(model, opt, lr_scheduler, train_loader,
                                 val_loader, args, start_epoch=start_epoch,
                                 epoch_hook=epoch_hook,
                                 round_hook=round_hook, logdir=logdir)
    except GracefulShutdown as e:
        # no save here: the last round-cadence autosave is the resume
        # point (reference gpt2_train.py:478-486)
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
    # (reference gpt2_train.py)
    registry.maybe_write_manifest(
        args, mesh_shape=mesh.mesh_shape_dict(model.mesh),
        extra={"trainer": "gpt2_train", "epochs": len(results),
               "interrupted": interrupted,
               "diverged": bool(getattr(model, "diverged", False)),
               **resume_manifest_extra(model)})
    if logdir is not None and not getattr(model, "diverged", False) \
            and not interrupted:
        # the final model and tokenizer, HF-style (reference
        # gpt2_train.py:500-508); diverged weights are not a model
        model.save_pretrained(logdir, hf_format=args.do_hf_export)
        tokenizer.save_pretrained(logdir)
        print(f"saved model + tokenizer to {logdir}"
              + (" (HF torch format)" if args.do_hf_export else ""))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])

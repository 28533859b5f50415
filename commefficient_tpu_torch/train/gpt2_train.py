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

Telemetry, checkpoint resume, autosave and the final save of the model
and tokenizer are not ported (their flags raise); neither is loading
pretrained weights: with no weights in ``--model_checkpoint`` the
model starts from random initialisation, as the reference does.

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
import math
import os
import sys
import time

import numpy as np
import torch

from commefficient_tpu_torch.config import Config, parse_args
from commefficient_tpu_torch.core.rounds import fused_grad_eligible
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
                                                 lm_nll_sums_chunked,
                                                 token_nll)
from commefficient_tpu_torch.ops.attention import \
    unsupported_reason as attention_unsupported_reason
from commefficient_tpu_torch.ops.flce import (lm_nll_sums_fused,
                                              resolve_fused_ce)
from commefficient_tpu_torch.runtime import FedModel, FedOptimizer, LambdaLR
from commefficient_tpu_torch.utils import (PiecewiseLinear, TableLogger,
                                           Timer, steps_per_epoch)

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
    lm = lm_nll_sums_fused if fused else lm_nll_sums_chunked
    sn, sv = lm(h[:, :-1], wte, labels[:, 1:], module.cfg.dtype,
                ignore_index=-1, tokens_per_chunk=tokens_per_chunk or 1024)
    return sn, sv, mc_logits, lead


def make_compute_loss_train(module, args, fused=False):
    """(reference gpt2_train.py:90-122) per example: lm_coef * its
    token-mean NLL over its valid positions + mc_coef * the MC
    cross-entropy; per client: the mask-weighted mean over its
    examples, (W,)."""

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
                stats=None):
    """(reference gpt2_train.py:157-228). Training returns the mean
    round loss (None on divergence) and, when ``stats`` is a dict,
    fills it with each round's wall seconds (``round_times``: from the
    scheduler step to the round's metrics on the host after
    ``opt.step()`` queued the server half) and the per-client
    download/upload byte totals. Validation returns (nll, acc, ppl)."""
    if training:
        model.train(True)
        losses, round_times = [], []
        download = np.zeros(model.num_clients)
        upload = np.zeros(model.num_clients)
        for i, batch in enumerate(loader):
            t0 = time.perf_counter()
            lr_scheduler.step()
            metrics = model(batch)
            opt.step()
            round_times.append(time.perf_counter() - t0)
            download += metrics[-2]
            upload += metrics[-1]
            w = np.asarray(batch["mask"]).sum(axis=1)
            if w.sum() > 0:
                loss = float(np.sum(metrics[0] * w) / w.sum())
                losses.append(loss)
                if not math.isfinite(loss) or loss > args.nan_threshold:
                    print(f"diverged at round {i} (loss {loss})")
                    return None
            if args.do_test:
                break
        if stats is not None:
            stats.update(round_times=round_times, download=download,
                         upload=upload)
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
               logger=None):
    """Epoch loop (reference gpt2_train.py:231-281). Each result row
    also carries the epoch's per-round wall times (``round_times``)
    and byte totals (``down (MiB)``, ``up (MiB)``), which the table
    does not print."""
    logger = logger or TableLogger()
    timer = Timer()
    results = []
    for epoch in range(math.ceil(args.num_epochs)):
        stats = {}
        train_loss = run_batches(model, opt, lr_scheduler, train_loader,
                                 args, training=True, stats=stats)
        if train_loss is None:
            print("NaN detected, aborting")
            return results
        train_time = timer()
        nll, acc, ppl = run_batches(model, opt, lr_scheduler, val_loader,
                                    args, training=False)
        val_time = timer()
        row = {"epoch": epoch + 1,
               "lr": float(opt.param_groups[0]["lr"]),
               "train_time": train_time, "train_loss": train_loss,
               "val_time": val_time, "val_nll": nll, "val_acc": acc,
               "val_ppl": ppl, "total_time": timer.total_time}
        logger.append(row)
        results.append(dict(
            row, round_times=stats["round_times"],
            **{"down (MiB)": float(stats["download"].sum() / 2**20),
               "up (MiB)": float(stats["upload"].sum() / 2**20)}))
    return results


def build_model_and_tokenizer(args: Config, device="cpu"):
    """(reference gpt2_train.py:284-351) -> (module, flat f32
    parameters from ``args.seed``, tokenizer). The full GPT-2 geometry
    with the vocabulary's size, or with ``--test`` (or the byte
    tokenizer) the tiny config; ``--remat`` and ``--attn_impl`` set on
    it (reference gpt2_train.py:316-319). ``--attn_impl flash`` on a
    card at a head dim or compute type the kernels lack raises."""
    tokenizer = load_tokenizer(args.model_checkpoint)
    tokenizer.add_special_tokens(SPECIAL_TOKENS)
    if os.path.isdir(args.model_checkpoint):
        for name in ("config.json", "pytorch_model.bin",
                     "flax_model.msgpack"):
            if os.path.exists(os.path.join(args.model_checkpoint, name)):
                raise NotImplementedError(
                    f"loading {name} from --model_checkpoint is not "
                    "ported; the port starts from random weights")
    if args.do_test or type(tokenizer).__name__ == "ByteTokenizer":
        cfg = GPT2Config.tiny()
        cfg = dataclasses.replace(
            cfg, vocab_size=max(len(tokenizer), cfg.vocab_size),
            n_positions=max(MAX_SEQ_LEN, cfg.n_positions))
    else:
        cfg = GPT2Config(vocab_size=len(tokenizer), n_positions=1024)
    if args.do_bf16:
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    cfg = dataclasses.replace(cfg, remat=args.do_remat,
                              attn_impl=args.attn_impl)
    if cfg.attn_impl == "flash" and torch.device(device).type == "cuda":
        reason = attention_unsupported_reason(cfg.n_embd // cfg.n_head,
                                              cfg.dtype)
        if reason is not None:
            raise ValueError(f"--attn_impl flash: {reason}")
    module = GPT2DoubleHeads(cfg)
    return module, module.init_flat(args.seed, device), tokenizer


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
                                    MAX_SEQ_LEN, pad_id)
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
    args = parse_args(default_lr=4e-2, argv=argv)
    if args.mode != "sketch":
        # at PersonaChat's 17 568 clients their per-client state needs
        # the host client store
        raise NotImplementedError(
            f"gpt2_train --mode {args.mode} is not ported")
    if args.pipeline_depth > 1:
        # the sparse re-sketch branch compacts its support with
        # torch.nonzero (ops/sketch.py unsketch), a host read: such a
        # round cannot run ahead of the card
        raise NotImplementedError(
            "gpt2_train --pipeline_depth > 1 is not ported")
    if not fused_grad_eligible(args):
        # the per-client round runs the loss under torch.func.vmap;
        # GPT-2's loss launches the fused CE kernels or checkpoints its
        # chunks, and neither composes with torch.func yet
        raise NotImplementedError(
            "gpt2_train's per-client round (--max_grad_norm, "
            "--microbatch_size) is not ported")
    device = resolve_device(args.device)
    np.random.seed(args.seed)

    if args.do_test:
        # tiny sketch like the reference smoke mode
        args.k = 10
        args.num_cols = 100
        args.num_rows = 1
        args.num_blocks = 1

    module, params, tokenizer = build_model_and_tokenizer(args, device)
    fused = resolve_fused_ce(args.fused_ce, module.cfg.n_embd, device,
                             module.cfg.dtype)
    print(f"fused_ce {args.fused_ce}: "
          f"{'fused kernels' if fused else 'chunked'} LM loss")
    train_loader, val_loader, train_ds = get_data_loaders(args, tokenizer)
    if args.num_clients is None:
        args.num_clients = int(train_ds.num_clients)

    model = FedModel(module, params,
                     make_compute_loss_train(module, args, fused), args,
                     compute_loss_val=make_compute_loss_val(module, args,
                                                            fused))
    opt = FedOptimizer([{"lr": 1.0}], args)

    spe = steps_per_epoch(args.local_batch_size, train_ds, args.num_workers)
    horizon = args.schedule_epochs or args.num_epochs
    lambda_step = PiecewiseLinear([0, horizon * spe], [args.lr_scale, 0])
    lr_scheduler = LambdaLR(opt, lambda x: lambda_step(x))

    if args.eval_before_start:
        out = run_batches(model, opt, lr_scheduler, val_loader, args,
                          training=False)
        print({"epoch": 0, "val_nll": out[0], "val_acc": out[1],
               "val_ppl": out[2]})
    return train_gpt2(model, opt, lr_scheduler, train_loader, val_loader,
                      args)


if __name__ == "__main__":
    main(sys.argv[1:])

"""Sequence-parallel federated runtime for GPT-2 (``--seq_devices N``).

Port of ``commefficient_tpu/runtime/fed_model_sp.py``
(``SeqParallelFedModel`` :51): a FedModel whose training round is the
``clients`` x ``seq`` round of core/rounds_sp.py, each client's forward
and backward sharded over N ranks with ring (or Ulysses) attention, so
that context length grows with the cards. Validation, the byte
accounting and the FedOptimizer server step are the base FedModel's:
it keeps its 1-D mesh over the world, every rank runs the replicated
server step on the same aggregate, and the weights stay bit-identical
across ranks.

The round yields the round's dense aggregate. ``uncompressed`` and
``true_topk`` take it as it is; ``sketch`` sketches it once (kernel 1,
at f32 whatever ``--sketch_dtype`` bills: by linearity the table equals
the sum of the clients' sketches), so the server math is the 1-D
round's. Weight decay is added at the 1-D round's effective
coefficient, ``weight_decay / num_workers``. Modes with per-client
state (local momentum or error, local_topk, fedavg, ``--topk_down``),
``--max_grad_norm`` and DP (per-client operations before the
aggregate) are refused with ``ValueError``, as are a ``seq_devices``
that does not divide the world, a round whose W does not divide over
the ``clients`` axis, ``--mesh CxM`` with M > 1 (the reference's 2-D
server fails on this round's aggregate) and, on the card, fewer ranks
than visible cards (the reference's sequence mesh takes every device,
its validation then fails). ``--dp sketch``, which the reference's
sequence-parallel round would skip without a word (no clip, no
noise), is refused too. ``--async_buffer_size`` and the host store
run as there: the round is synchronous and holds no client state.
``pipeline_depth`` is 1. Clients weigh
equally and a client's LM loss is a token mean over all its valid
tokens (core/rounds_sp.py): toggling ``--seq_devices`` changes the
training dynamics slightly at equal LR, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.core.rounds import _agg_probes, args2sketch
from commefficient_tpu_torch.core.rounds_sp import (build_sp_gpt2_round,
                                                    shift_lm_labels,
                                                    sp_shard)
from commefficient_tpu_torch.parallel.mesh import (hosts_of, make_sp_mesh,
                                                   resolve_world)
from commefficient_tpu_torch.runtime.fed_model import (FedModel,
                                                       _probe_values)
from commefficient_tpu_torch.telemetry import clock, trace

SP_MODES = ("uncompressed", "sketch", "true_topk")


def check_seq_parallel(args: Config, world: int):
    """The reference's refusals of a sequence-parallel run
    (fed_model_sp.py:52-68), each a ``ValueError``; the trainer calls it
    before it launches the ranks."""
    if args.mode not in SP_MODES:
        raise ValueError(f"--seq_devices does not support mode={args.mode} "
                         "(needs per-client local state)")
    if (args.local_momentum > 0 or args.error_type == "local"
            or args.do_topk_down):
        raise ValueError("--seq_devices requires local_momentum 0, "
                         "error_type none/virtual, no topk_down")
    if args.max_grad_norm is not None or args.do_dp or args.dp != "off":
        raise ValueError(
            "--seq_devices does not support --max_grad_norm/--dp "
            "(per-client clipping/noise happens before aggregation and "
            "cannot be applied afterwards)")
    if world % args.seq_devices:
        raise ValueError(f"seq_devices={args.seq_devices} must divide "
                         f"device count {world}")
    n_clients = world // args.seq_devices
    if args.num_workers % n_clients:
        # the reference finds it at its first round (fed_model_sp.py:128)
        raise ValueError(f"num_workers {args.num_workers} must be "
                         f"divisible by the client axis {n_clients}")
    shape = args.mesh2d
    if shape is not None and shape[1] > 1:
        # the reference's 2-D server takes no replicated aggregate (its
        # shard_map raises a ValueError); Cx1 is the 1-D mesh and runs
        raise ValueError(f"--seq_devices with --mesh {args.mesh}: the "
                         "model-sharded server does not take the "
                         "sequence-parallel round's aggregate")
    if (torch.device(args.device).type == "cuda"
            and hosts_of(args) is None
            and world < torch.cuda.device_count()):
        # the reference's sequence-parallel mesh spans every device
        # while its server and validation keep the --num_devices (or
        # --mesh Cx1) subset, and its validation raises a ValueError
        raise ValueError(f"--seq_devices shards over every visible card "
                         f"({torch.cuda.device_count()}); the run asks "
                         f"for {world} (--num_devices/--mesh)")


class SeqParallelFedModel(FedModel):
    def __init__(self, module, params, compute_loss, args: Config,
                 gpt2_cfg, compute_loss_val=None, padded_batch_size=None):
        check_seq_parallel(args, resolve_world(args))
        if (args.seq_impl == "ulysses"
                and gpt2_cfg.n_head % args.seq_devices):
            raise ValueError(f"ulysses attention: n_head {gpt2_cfg.n_head}"
                             " is not a multiple of the seq axis size "
                             f"{args.seq_devices}")
        super().__init__(module, params, compute_loss, args,
                         compute_loss_val=compute_loss_val,
                         padded_batch_size=padded_batch_size)
        world = self.mesh.world.size
        # this round accounts synchronously
        self.pipeline_depth = 1
        self._sp_mesh = make_sp_mesh(world // args.seq_devices,
                                     args.seq_devices, self.device.type)
        sp_round = build_sp_gpt2_round(
            dataclasses.replace(gpt2_cfg, seq_impl=args.seq_impl),
            self._sp_mesh, lm_coef=args.lm_coef, mc_coef=args.mc_coef,
            ignore_index=-1, tokens_per_chunk=args.tokens_per_chunk)
        sketch = args2sketch(args)
        wd = args.weight_decay / max(args.num_workers, 1)
        probes_on = self.probe_period > 0

        def make_round(with_recovery):
            def round_and_compress(ps, shard):
                agg, losses = sp_round(ps, shard)
                if wd > 0:
                    agg = agg + wd * ps
                dense = agg
                if sketch is not None:
                    agg = sketch.sketch(dense)
                pr = None
                if probes_on:
                    pr = _agg_probes(agg)
                    if with_recovery and sketch is not None:
                        # the dense aggregate exists before the sketch on
                        # this path: the ground truth is free
                        pr["recovery_error"] = sketch.recovery_error(
                            agg, dense, args.k)
                return agg, losses, pr
            return round_and_compress

        self._sp_round = make_round(False)
        self._sp_round_probed = (make_round(True)
                                 if probes_on and sketch is not None
                                 else None)

    def _call_train(self, batch):
        tel = self.telemetry
        ridx = self.round_index
        if (self._cost_model is None and tel.enabled
                and self.args.do_profile and trace.tracing()):
            self._emit_cost_model(batch)
        tel.begin_round(ridx)
        trace.begin_round_marker(ridx)
        eng = self.alarm_engine
        step_t0 = (clock.tick()
                   if eng is not None and eng.step_time_ratio > 0 else None)
        ids_np = np.asarray(batch["client_ids"])
        with tel.span("h2d"), trace.phase("h2d"):
            host = dict(batch, shifted_labels=shift_lm_labels(
                batch["lm_labels"]))
            shard = self._to_device(sp_shard(host, self._sp_mesh))
        round_fn = self._sp_round
        if (self._sp_round_probed is not None
                and ridx % self.probe_period == 0):
            round_fn = self._sp_round_probed
        with tel.span("round_dispatch"), trace.phase("round_dispatch"):
            agg, losses, probes = round_fn(self.ps_weights, shard)
        self.pending_aggregated = agg
        self.pending_client_ids = torch.as_tensor(
            ids_np.astype(np.int64)).to(self.device)
        self.round_index += 1
        # the (W,) per-client losses, as the 1-D round's metrics: the
        # trainer weights them by real sample counts
        with tel.span("metrics_host"), trace.phase("metrics_host"):
            metrics = [losses.to("cpu").numpy().astype(np.float64)]
            probe_vals = None if probes is None else _probe_values(probes)
        if probe_vals is not None:
            tel.merge_round_probes(ridx, probe_vals)
            self._probe_host[ridx] = probe_vals
        if step_t0 is not None:
            eng.check_step_time(ridx, clock.tick() - step_t0)
        down, up = self._account_bytes(ids_np, batch["mask"])
        tel.set_round_bytes(ridx, float(down.sum()), float(up.sum()))
        return metrics + [down, up]

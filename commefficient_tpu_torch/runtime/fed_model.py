"""High-level federated runtime: FedModel + FedOptimizer.

Port of ``commefficient_tpu/runtime/fed_model.py`` (``FedModel`` :107,
``FedOptimizer`` :1214, ``LambdaLR`` :1412), single device, with the
reference's protocol:

    model = FedModel(module, flat_params, compute_loss, args)
    opt   = FedOptimizer(param_groups, args)
    scheduler = LambdaLR(opt, lambda_fn)
    ...
    scheduler.step()
    metrics = model(batch)     # one federated round (client pass)
    opt.step()                 # server update

the per-client state of the modes that keep one (``client_states``,
on the device), fedavg's local-SGD LR handed from each server step to
the next round's clients, and the reference's per-client
communication accounting: uploads bill what one participating client
sends (one sketch table at the wire dtype, ``--sketch_dtype``, with
per-row f32 scales for int8/fp8; k values under local_topk; d values
otherwise); downloads bill, per client, the coordinates updated since
it last participated, tracked as per-coordinate ``last_updated`` round
indices from the update's support (its index vector; the indices whose
lr-scaled value is nonzero of an (indices, values) support; every
coordinate of a dense update): 4 bytes each under
``--downlink_encoding dense``, and under ``delta`` the value at wire
width plus an int32 index for each coordinate that does not repeat
the previous update's support, with a bitmap over that support for a
client that saw it (``_account_bytes``, ``note_update``). A support
crosses to the host as the server made it on the device: a packed
bitmap of the changed coordinates (the dense-update modes and the
threshold-select paths), or k (index, value) pairs.

``--pipeline_depth N`` > 1 (reference fed_model.py:340-348, ``flush``
:828, ``drain_rounds`` :1203): ``model(batch)`` returns None and keeps
the round's metrics on the device; the round's accounting and the
server's note wait in a log, in dispatch order. ``flush`` brings up to
N rounds' metrics and supports to the host at once (pinned buffers,
one event wait) and replays the log, so a round makes no host sync
and the host runs up to N rounds ahead of the device. The per-round
math, bytes and losses are those of depth 1.
With ``stats_fn`` (``--batchnorm``) the round also records the
clients' batch statistics, which the model blends into running
statistics on the device (``model_state``) that eval normalizes by.
``FedOptimizer`` takes one LR group, or index groups (the Fixup bias
and scale LRs), whose per-coordinate LR the server applies.
``params()`` is the current weights as the module's flax tree and
``save_pretrained`` writes them as the reference's run directory
(``flax_model.msgpack`` through ``serialization.py``, ``config.json``;
with ``hf_format`` the HF ``transformers`` files; with ``torch_format``
a CV model's reference-named ``state_dict.pt``).
Each round gets its index (``round_index``), which seeds its noise
streams (privacy/mechanism.py); under ``--dp sketch`` the run's RDP
accountant (privacy/accountant.py, reference fed_model.py:372-378,
868-918) is charged once a dispatched round at σ = ``--dp_noise_mult``
and weight scale 1 (under weighted asynchronous rounds the largest
alive staleness weight), and ``privacy_epsilon()`` reads the ε spent. ``FedOptimizer`` draws the
legacy ``--do_dp --dp_mode server`` noise from a seed + 1 stream, one a
server step (reference fed_model.py:1267-1270, 1306-1308).
``--clientstore host`` (reference fed_model.py:170-201, 477-561)
keeps the per-client rows in ``clientstore.HostClientStore`` instead of
on the card: each round gathers its W participants' rows (prefetched a
round ahead by ``StorePrefetcher`` from the sampler's lookahead,
``attach_participant_feed``, into page-locked buffers), copies them up
as a (W + 1, ...) stack (the last row the dead-slot row), runs the
round on slot positions (``dense_rows``), and after the server step
copies the rows down and writes the live ones back (``_store_writeback``).
``store_timings`` keeps each round's gather, H2D, D2H, write-back and
spill times. ``finalize`` closes the prefetcher and the store (its last
``stats`` kept in ``store_stats``);
``interrupted`` drops a round that a signal cut short.
``--async_buffer_size K`` (reference fed_model.py:210-223, 487-493,
527-536, 656-662, 813-826, 868-905) puts ``asyncfed.AsyncRoundDriver``
in front of the round: ``model(batch)`` issues the sampled cohort into
the arrival queue and runs the round on the fold batch of up to K
arrived updates (dead pad slots after them) with their staleness; the
host store's issue stamps come from the driver, its prefetch follows
the driver's exact next-fold ids where the backlog holds a full buffer
(the sampler's lookahead otherwise), only alive fold slots are billed,
and each round's ``round_stats()`` is kept in ``async_round_stats``.
``attach_arrival_process`` attaches a seeded arrival schedule (tests
and scripts).
The round ledger (reference fed_model.py:355-422, 549-713, 771-858,
938): ``self.telemetry`` (telemetry/core.py; disabled without
``--ledger``/``--telemetry_console``, then every call below is a flag
check) gets the spans ``async_fold``, ``h2d``, ``gather``,
``h2d_state``, ``round_dispatch``, ``metrics_host``, ``server`` and
``writeback``, the ``prefetch_hit``/``prefetch_miss`` counters, each
round's bytes (``set_round_bytes``) and DP trail, and the meta record.
``--probe_every N``/``--probe_full`` build the rounds with probes: the
plain variant (cheap probes) and, in sketch mode, the probed one (with
the recovery error) for rounds where ``round % N == 0``. Synchronous
rounds read their probe scalars in one copy in ``metrics_host``;
pipelined rounds keep them on the device in ``_probe_log`` until the
flush, which copies them with the metrics and supports.
``_finish_probes`` adds the residual growth ratio, merges the probes
onto the ledger and runs the alarm engine (telemetry/alarms.py; under
``--on_divergence abort`` it raises ``DivergenceAbort``);
``--flightrec_rounds`` attaches the flight recorder as a sink
(``self.flightrec``). ``trace`` markers bracket each round and its
device phases while a ``--profile`` window is open.
The live plane (reference fed_model.py:393-409): ``telemetry/live.py
attach_live_plane`` attaches the ``--live_port`` exporter's sink
(``self.live_sink``, labelled with the process, the run key and, on a
job service's ``.job<j>`` shard, the job) and the ``--flightrec_rounds``
flight recorder (``self.flightrec``) before the meta record. With a
``--slo_*`` target the run's SLO engine (``self._slo``) observes every
synchronous round (``_observe_slo``, reference :918-936); with
``--causal_trace`` every telemetry span is also a causal frame of the
round's DAG (``telemetry/causal.py``), which the round record carries.
The round variants (reference :84-105, 274-296, 681-692, 957-1017): the
client rounds live in a bounded LRU (``autopilot/cache.py``) of
``_RoundVariant`` bundles keyed by the knob lattice point
(``autopilot/lattice.py``); the base variant's config is ``args``
itself, so with ``--autopilot off`` the round is the one the port ran
before variants. A variant is a knob-substituted Config and its eager
round closures (``build_client_round`` of the plain and the probed
flavor, each with its ``CountSketch`` hash and sign state), plus the
server round ``FedOptimizer`` builds on first use; nothing is compiled.
Under ``--autopilot on`` the controller observes each finished round's
probes and moves the dispatch point (``_switch_variant``);
``FedOptimizer`` runs the server round of the variant that emitted the
aggregate and re-seeds its tables when a geometry move changes their
shape. The first dispatch of each flavor of each variant stamps
``vcompile_events:<key>`` (kernel libraries loaded during it),
``vcompile_secs:<key>`` (its host wall seconds) and
``vcompile_programs:<key>`` (1) on the round's record, with the
autopilot off too; a flavor built ahead under ``--autopilot_warm_ahead``
is stamped on the switch round instead, with its build, as the
reference stamps its ahead-of-time compile.
On a mesh (``--num_devices N`` / ``--mesh CxM``, reference
fed_model.py:141-153, 424-429, 1241-1265) each launched rank builds its
FedModel (``parallel/mesh.py build_mesh``: the run's devices outside a
launched group raise), sends its contiguous slice of the round's
clients to its card, runs the round (fused or per client) with the
whole round's datapoint total, and gets every client's metrics back;
the per-client state rows are sharded over ``clients`` (each rank its
block, parallel/rows.py), the server state is (r, c/M) column shards
or ceil(d/M) windows of the dense vector on a model axis; the ledger's
meta record carries ``num_devices`` and ``mesh_shape``, and only rank 0
writes the ledger and the live plane. Every rank keeps the same host
accounting (the whole round's ids and masks). Under the host store on
a mesh (reference fed_model.py:170-205, 495-515, 540-565) each rank's
store owns ``shard_range(num_clients, rank, world)``; the gather sums
the ranks' gathers over the mesh and the write-back all-gathers the
slot rows over ``clients`` (``_gather_states``, ``_store_writeback``),
both on the main thread, with no prefetch thread on more than one rank;
``store_timings`` adds each round's exchange seconds and bytes.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from commefficient_tpu_torch import accounting
from commefficient_tpu_torch.asyncfed import AsyncRoundDriver
from commefficient_tpu_torch.autopilot import (RoundVariantCache, apply_knobs,
                                               build_controller, key_of,
                                               key_str)
from commefficient_tpu_torch.clientstore import (HostClientStore,
                                                 StorePrefetcher,
                                                 resolve_clientstore,
                                                 shard_range, state_fields)
from commefficient_tpu_torch.clientstore.prefetch import staging_buffers
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.core.rounds import (ClientStates, _dead_row,
                                                 _state_ids,
                                                 build_client_round,
                                                 build_server_round,
                                                 round_plan)
from commefficient_tpu_torch.core.server import (ServerState,
                                                 staleness_weights)
from commefficient_tpu_torch.device import resolve_device
from commefficient_tpu_torch.ops.vec import packbits
from commefficient_tpu_torch.parallel import rows as rowx
from commefficient_tpu_torch.parallel.mesh import (build_mesh, client_slice,
                                                   is_sharded,
                                                   mesh_shape_dict,
                                                   model_axis_size,
                                                   topology_summary)
from commefficient_tpu_torch.privacy.accountant import build_accountant
from commefficient_tpu_torch.privacy.mechanism import (SERVER_NOISE_TAG,
                                                       noise_generator)
from commefficient_tpu_torch.serialization import msgpack_serialize
from commefficient_tpu_torch.telemetry import clock, trace
from commefficient_tpu_torch.telemetry.alarms import build_alarm_engine
from commefficient_tpu_torch.telemetry.causal import build_causal_tracer
from commefficient_tpu_torch.telemetry.core import (build_telemetry,
                                                    compile_delta,
                                                    compile_mark)
from commefficient_tpu_torch.telemetry.live import attach_live_plane
from commefficient_tpu_torch.telemetry.registry import config_hash
from commefficient_tpu_torch.telemetry.sinks import job_index_of_ledger
from commefficient_tpu_torch.telemetry.slo import build_slo_engine

# the most recently constructed FedModel, found by FedOptimizer(args)
# as in the reference
_CURRENT_MODEL: Optional["FedModel"] = None


class _RoundVariant:
    """One lattice point's round bundle (reference fed_model.py:84-105):
    the knob-substituted Config and its eager client rounds, the plain
    flavor and (sketch mode with probes) the probed one. ``server_fn``
    is built by FedOptimizer on first use; ``compiled`` holds the
    flavors whose first dispatch is already stamped on the ledger."""

    __slots__ = ("key", "cfg", "round_fn", "round_probed", "server_fn",
                 "compiled")

    def __init__(self, key, cfg, round_fn, round_probed):
        self.key = key
        self.cfg = cfg
        self.round_fn = round_fn
        self.round_probed = round_probed
        self.server_fn = None
        self.compiled = set()


class FedModel:
    """One federated model and its client-side runtime.

    ``params`` is the flat f32 parameter vector (ravel_pytree order,
    ops/vec.py). ``compute_loss(flat, batch, args) -> (loss,
    metrics)`` returns masked-mean values over the last batch axis, so
    a (W, B, ...) round batch gives per-client (W,) values and an
    (S, B, ...) validation batch per-shard ones (CV images, or
    PersonaChat shards)."""

    def __init__(self, module, params: torch.Tensor,
                 compute_loss: Callable, args: Config,
                 compute_loss_val: Optional[Callable] = None,
                 padded_batch_size: Optional[int] = None,
                 stats_fn: Optional[Callable] = None,
                 init_model_state: Optional[dict] = None):
        global _CURRENT_MODEL
        args.validate_runtime()
        self.module = module
        self.args = args
        self.device = resolve_device(args.device)
        # the mesh of the launched ranks (parallel/mesh.py), None for a
        # one-device run; more than one device asked for outside a
        # launched group raises
        self.mesh = build_mesh(args)
        self.rank = 0 if self.mesh is None else self.mesh.rank
        self.compute_loss_train = compute_loss
        self.compute_loss_val = compute_loss_val or compute_loss
        # --batchnorm: ``stats_fn(ps_weights, batch)`` records every
        # client's batch statistics; the round's sample-weighted mean
        # is blended into ``model_state`` (torch BatchNorm's momentum
        # 0.1, on the device), and eval normalizes by it:
        # ``compute_loss_val`` then takes (params, batch, args, state)
        self.stats_fn = stats_fn
        self.model_state = None
        if stats_fn is not None:
            self.model_state = {k: v.to(self.device, torch.float32)
                                for k, v in init_model_state.items()}
        args.grad_size = int(params.numel())
        self.ps_weights = params.detach().to(self.device,
                                             torch.float32).clone()

        num_clients = args.resolved_num_clients
        assert num_clients is not None, "num_clients unresolved"
        self.num_clients = num_clients

        def loss_fn(flat, batch):
            return compute_loss(flat, batch, args)

        # per-client state placement: on the device (rows of the
        # clients, plus the dead-slot row), or in the host store with
        # only the round's participants on the device
        self.clientstore = resolve_clientstore(args, num_clients)
        self.client_store = None
        self._prefetcher = None
        self._participant_feed = None
        self._store_pending = None
        self._staging = {}
        self._d2h = {}
        self._h2d_events = None
        self._xchg_events = None
        self.store_timings = []
        self.store_stats = None
        if self.clientstore == "host":
            if int(args.pipeline_depth) > 1:
                raise ValueError(
                    "--clientstore host requires --pipeline_depth 1: "
                    "round N's write-back must land before round "
                    "N+1's gather reads the store")
            # on a mesh this rank's store owns its block of the ids
            lo, hi = shard_range(num_clients)
            fields = state_fields(
                args, init_weights=(self.ps_weights.to("cpu").numpy()
                                    if args.do_topk_down else None))
            self.client_store = HostClientStore(
                num_clients, fields, budget_bytes=args.clientstore_bytes,
                spill_dir=(args.clientstore_dir or None), owned=(lo, hi))
            self.client_states = ClientStates(None, None, None)
            # the prefetch thread serves one process: on a mesh of more
            # the rows' exchange is a collective of the main thread
            # (reference fed_model.py:197-201)
            if fields and (self.mesh is None or self.mesh.world.size == 1):
                self._prefetcher = StorePrefetcher(
                    self.client_store, pin=self.device.type == "cuda")
        else:
            # on a mesh each rank holds its clients block of the rows
            self.client_states = ClientStates.init(args, num_clients,
                                                   self.ps_weights,
                                                   self.device, self.mesh)
        # --async_buffer_size K: the buffered-arrival front end; the
        # host store's participants get issue-round stamps
        self.async_k = int(args.async_buffer_size)
        self._async_driver = None
        self.async_round_stats = []
        if self.async_k > 0:
            self._async_driver = AsyncRoundDriver(
                args, stamp=(self.client_store.stamp_rounds
                             if self.client_store is not None else None))
        if padded_batch_size is None:
            padded_batch_size = (args.local_batch_size
                                 if args.local_batch_size > 0 else 1)
        self.padded_batch_size = padded_batch_size
        # --probe_every/--probe_full: the probes are built into the
        # round; in sketch mode a second variant with the recovery
        # probe runs the cadence rounds
        self.probe_period = int(args.probe_period)
        probes_on = self.probe_period > 0

        def build_round(cfg, with_recovery):
            return build_client_round(
                cfg, loss_fn, padded_batch_size, stats_fn,
                dense_rows=self.client_store is not None,
                client_weights=self.async_k > 0, probes=probes_on,
                probe_recovery=with_recovery, mesh=self.mesh)

        # the round variants, keyed by the knob lattice point; the base
        # variant's config IS ``args`` (apply_knobs returns the same
        # object at the base key), so with the autopilot off the round
        # is built from exactly the config a build without variants
        # would use
        def build_variant(key):
            cfg = apply_knobs(args, key)
            return _RoundVariant(
                key, cfg, build_round(cfg, False),
                (build_round(cfg, True)
                 if probes_on and cfg.mode == "sketch" else None))

        self._variants = RoundVariantCache(
            build_variant, max_size=int(args.autopilot_cache_size))
        self._variant_key = key_of(args)
        self._autopilot = build_controller(args)
        if self._autopilot is not None:
            # --autopilot_pin starts (and holds) at the pinned point
            self._variant_key = self._autopilot.key
            if self._variant_key != key_of(args):
                self.args = args = apply_knobs(args, self._variant_key)
        # the config the variants' knobs are applied to
        self._autopilot_base = args
        self.pending_variant_key = self._variant_key
        # the dispatch point's bundle is built now, as the round was
        # before variants (a misconfigured round fails at construction)
        self._variants.get(self._variant_key)
        self.pending_aggregated = None
        # the round's state ids, dead slots at the dead-slot row: the
        # server round's velocity rewrite (true_topk) scatters there
        self.pending_client_ids = None
        # fedavg's local-SGD LR: zero until the first FedOptimizer.step
        # sets it, as the reference's shared g_lr; clients read the
        # value the previous round's step set
        self.fedavg_lr = 0.0
        self.round_index = 0
        # --dp sketch: the run's RDP accountant, charged once a
        # dispatched round; None with --dp off
        self._accountant = build_accountant(args)
        self.training = True
        # set by the trainer when a round's loss diverged: its weights
        # are not a final model
        self.diverged = False

        # communication accounting
        self.last_updated = np.full(args.grad_size, -1, np.int64)
        self.client_last_seen = np.full(num_clients, -1, np.int64)
        self._update_round = 0
        self._rebuild_round_counts()
        # --downlink_encoding delta bookkeeping: how many of the latest
        # update's support indices repeat the update before it, and
        # that previous update's support size (the bitmap a
        # round-fresh client holds)
        self._repeat_count = 0
        self._bitmap_bits = 0
        # --pipeline_depth: rounds dispatched but not yet flushed, their
        # device metrics, and the log of deferred ("account", ids, mask)
        # and ("note", support) host ops
        self.pipeline_depth = int(args.pipeline_depth)
        self._inflight = []
        self._oplog = []

        # the round ledger; _probe_host holds a synchronous round's
        # client-pass probe values until the server pass completes its
        # dict, _probe_log a pipelined round's device scalars until the
        # flush. The alarm engine (None with no rule armed) evaluates
        # without sinks too, so --on_divergence abort works ledgerless
        # every rank of a mesh run writes its ledger, rank k > 0 to its
        # ``.p<k>`` shard (its own host spans); rank 0 alone has the
        # console summary, the live plane and the flight recorder
        tel_args = args if self.rank == 0 else args.replace(
            telemetry_console=False, live_port=0, flightrec_rounds=0)
        self.telemetry = build_telemetry(tel_args, device=self.device)
        self._probe_host = {}
        self._probe_log = {}
        self._prev_residual = None
        self.alarm_engine = build_alarm_engine(args, self.telemetry)
        if self.alarm_engine is not None:
            self.telemetry.on_device_time = \
                self.alarm_engine.check_device_time
        # the live plane: exporter sink and flight recorder attach
        # before the meta record is emitted (the live sink derives
        # clients/s from the plan, the recorder stamps the bundle's
        # meta); both stay None with the knobs unset. The job label is
        # the job service's ledger shard index; the registry lineage
        # arms only when the run writes a ledger, as the manifest does
        job = job_index_of_ledger(args.ledger)
        labels = {"process": 0, "run": config_hash(args)[:8]}
        if job is not None:
            labels["job"] = job
        self.live_sink, self.flightrec = attach_live_plane(
            self.telemetry, tel_args, labels=labels,
            runs_dir="runs" if tel_args.ledger else "")
        # the run's SLO engine (None unless a --slo_* target is set),
        # observed once a synchronous round
        self._slo = build_slo_engine(args)
        # the causal tracer (None unless --causal_trace): every span
        # also records a causal frame, keyed by the job index so the
        # job service's grant spans stitch in by id
        self.telemetry.set_causal_tracer(build_causal_tracer(args, job=job))
        if self._async_driver is not None:
            self._async_driver.causal = self.telemetry.causal
        # the roofline cost model (analysis/cost.py), made on the first
        # --profile'd round
        self._cost_model = None
        topo = topology_summary()
        self.telemetry.emit_meta(
            num_clients=num_clients, num_devices=topo["device_count"],
            process_index=topo["process_index"],
            process_count=topo["process_count"],
            clientstore=self.clientstore,
            mesh_shape=mesh_shape_dict(self.mesh), plan=round_plan(args))
        _CURRENT_MODEL = self

    def train(self, training: bool):
        self.training = training

    def __call__(self, batch):
        return (self._call_train(batch) if self.training
                else self._call_val(batch))

    def _to_device(self, batch) -> dict:
        out = {}
        for key, val in batch.items():
            if key == "client_ids":
                continue
            t = torch.as_tensor(np.asarray(val))
            if not t.is_floating_point():
                t = t.to(torch.int64)
            out[key] = t.to(self.device, non_blocking=True)
        return out

    def _call_train(self, batch):
        tel = self.telemetry
        ridx = self.round_index
        if (self._cost_model is None and tel.enabled
                and self.args.do_profile and trace.tracing()):
            # the roofline expectation, once a run, from the first
            # traced round's batch; before its round range opens, so
            # the count's work falls in no round's window
            self._emit_cost_model(batch)
        tel.begin_round(ridx)
        # the profiler's round range, on the ledger record's lifecycle
        # (a flag check with no trace window open)
        trace.begin_round_marker(ridx)
        eng = self.alarm_engine
        step_t0 = (clock.tick()
                   if eng is not None and eng.step_time_ratio > 0
                   and self.pipeline_depth <= 1 else None)
        # an SLO latency sample needs a wall clock on every synchronous
        # round (pipelined dispatch times measure the host, not the
        # round)
        slo_t0 = (clock.tick()
                  if self._slo is not None and self.pipeline_depth <= 1
                  else None)
        staleness = None
        if self._async_driver is not None:
            # issue the sampled cohort, then fold what has arrived: the
            # round runs on the buffer's head, dead-padded to W
            with tel.span("async_fold"):
                batch, staleness = self._async_driver.step(batch)
        ids_np = np.asarray(batch["client_ids"])
        mesh_kw, part = {}, slice(None)
        if self.mesh is not None:
            # this rank's slice of the round's clients goes to its card;
            # every rank holds the whole host batch, whose datapoint
            # total normalises each rank's loss
            W = ids_np.shape[0]
            part = client_slice(W, self.mesh)
            mesh_kw = dict(total=_round_total(batch["mask"], staleness,
                                              self.args),
                           global_w=W)
        with tel.span("h2d"), trace.phase("h2d"):
            dev_batch = self._to_device(
                batch if self.mesh is None else
                {k: np.asarray(v)[part] for k, v in batch.items()})
            ids = torch.as_tensor(ids_np[part].astype(np.int64)).to(
                self.device, non_blocking=True)
            # on a mesh this rank's slice of the round's staleness
            stale_dev = (None if staleness is None else torch.from_numpy(
                np.ascontiguousarray(staleness[part])).to(
                    self.device, non_blocking=True))
        cs_in = self.client_states
        if self.client_store is not None:
            # normally a no-op: opt.step() already wrote the previous
            # round's rows back
            self._store_writeback()
            cs_in = self._gather_states(ids_np)
        var = self._variants.get(self._variant_key)
        probed = (var.round_probed is not None
                  and ridx % self.probe_period == 0)
        flavor = "probed" if probed else "plain"
        round_fn = var.round_probed if probed else var.round_fn
        # the server pass consumes this aggregate with the SAME
        # variant's round: the dispatch-time key, not whatever the
        # controller moves to afterwards
        self.pending_variant_key = var.key
        first = flavor not in var.compiled
        cmark = compile_mark() if first else None
        t0 = clock.tick() if first else None
        with tel.span("round_dispatch"), trace.phase("round_dispatch"):
            res = round_fn(self.ps_weights, dev_batch, cs_in, ids,
                           self.fedavg_lr, round_index=ridx,
                           staleness=stale_dev, **mesh_kw)
        if first:
            var.compiled.add(flavor)
            self._stamp_vcompile(var.key, cmark, clock.tick() - t0)
        self.client_states = res.client_states
        self.pending_aggregated = res.aggregated
        if self.client_store is not None:
            # state rows are slot positions (dense_rows), this rank's
            # slots on a mesh: the server round's velocity rewrite
            # scatters there too
            W = ids_np.shape[0]
            wl = dev_batch["mask"].shape[0]
            self.pending_client_ids = _state_ids(
                torch.arange(wl, dtype=torch.int64, device=self.device),
                dev_batch, wl)
            alive = np.asarray(batch["mask"]).reshape(W, -1).sum(1) > 0
            self._store_pending = (ids_np.astype(np.int64), alive)
            self._submit_prefetch()
        elif self.mesh is not None:
            # the whole round's rows this rank owns (true_topk's
            # velocity rewrite runs on every rank's own rows); the
            # others and the dead slots at its dead row
            W = ids_np.shape[0]
            alive = np.asarray(batch["mask"]).reshape(W, -1).sum(1) > 0
            xids = np.where(alive, ids_np.astype(np.int64), rowx.DEAD)
            self.pending_client_ids = rowx.local_ids(
                torch.as_tensor(xids).to(self.device, non_blocking=True),
                _dead_row(self.client_states), self.mesh.clients)
        else:
            self.pending_client_ids = _state_ids(
                ids, dev_batch, _dead_row(self.client_states))
        if self._accountant is not None:
            # the round released its noised table whether or not its
            # metrics ever reach the host
            self._charge_privacy(ridx, var.cfg, staleness, batch["mask"])
        self.round_index += 1
        if res.bn_stats is not None:
            # running-stats blend; a round with no real sample leaves
            # them as they were. Device ops, no host read
            new_stats, alive = res.bn_stats
            self.model_state = {
                k: torch.where(alive > 0, 0.9 * ra + 0.1 * new_stats[k], ra)
                for k, ra in self.model_state.items()}
        acct_ids, acct_mask = ids_np, np.asarray(batch["mask"])
        astats = None
        if self._async_driver is not None:
            astats = self._async_driver.round_stats()
            self.async_round_stats.append(astats)
            # dead pad slots (id 0, mask 0) are queue padding, not
            # participants: they must not bill client 0 a download
            alive = acct_mask.reshape(len(ids_np), -1).sum(axis=1) > 0
            acct_ids, acct_mask = ids_np[alive], acct_mask[alive]
        if self.pipeline_depth > 1:
            # the bytes attach at the flush replay, the probes stay on
            # the device until then: no host read here
            self._inflight.append(list(res.metrics))
            self._oplog.append(("account", acct_ids.copy(),
                                np.array(acct_mask), ridx, var.cfg))
            if res.probes is not None:
                self._probe_log.setdefault(ridx, {}).update(res.probes)
            return None
        with tel.span("metrics_host"), trace.phase("metrics_host"):
            metrics = [m.to("cpu").numpy() for m in res.metrics]
            probe_vals = (None if res.probes is None
                          else _probe_values(res.probes))
        if probe_vals is not None:
            # merged now; the server pass completes the dict and runs
            # the alarms (_finish_probes)
            tel.merge_round_probes(ridx, probe_vals)
            self._probe_host[ridx] = probe_vals
        if astats is not None:
            # the asynchronous driver's round stats ride the ledger and
            # reach the alarms with the round's probes, or alone when
            # no probes are built
            tel.merge_round_probes(ridx, astats)
            if probe_vals is not None:
                self._probe_host[ridx].update(astats)
            elif eng is not None:
                eng.check(ridx, astats)
        if step_t0 is not None:
            # wall step time through the metrics read, checked before
            # the bytes so an aborting alarm lands on a record the
            # close still flushes
            eng.check_step_time(ridx, clock.tick() - step_t0)
        if slo_t0 is not None:
            self._observe_slo(ridx, clock.tick() - slo_t0, astats)
        down, up = self._account_bytes(acct_ids, acct_mask, var.cfg)
        tel.set_round_bytes(ridx, float(down.sum()), float(up.sum()))
        return metrics + [down, up]

    def flush(self, force=True):
        """Bring the dispatched rounds' metrics, the server's supports
        and the rounds' probes to the host in one batch, and replay the
        deferred accounting and notes in dispatch order (each round's
        probes finished before its bytes, which make its ledger record
        ready to emit). Returns each round's outputs as a synchronous
        ``model(batch)`` returns them; nothing until ``pipeline_depth``
        rounds wait, unless ``force``."""
        if self.pipeline_depth <= 1 or not self._inflight:
            return []
        if not force and len(self._inflight) < self.pipeline_depth:
            return []
        notes = [op[1] for op in self._oplog if op[0] == "note"]
        metric_ts = [t for ms in self._inflight for t in ms]
        support_ts = [t for sup in notes for t in _support_tensors(sup)]
        rounds_probed = [op[3] for op in self._oplog
                         if op[0] == "account" and op[3] in self._probe_log]
        probe_keys = [(r, k) for r in rounds_probed
                      for k in self._probe_log[r]]
        with self.telemetry.span("metrics_host"):
            host = _to_host(metric_ts + support_ts
                            + [self._probe_log[r][k] for r, k in probe_keys])
        probe_vals = {}
        for (r, k), v in zip(probe_keys,
                             host[len(metric_ts) + len(support_ts):]):
            probe_vals.setdefault(r, {})[k] = float(v)
        for r in rounds_probed:
            del self._probe_log[r]
        it_m = iter(host[:len(metric_ts)])
        it_s = iter(host[len(metric_ts):len(metric_ts) + len(support_ts)])
        rounds = [[next(it_m) for _ in ms] for ms in self._inflight]
        self._inflight = []
        oplog, self._oplog = self._oplog, []
        results = []
        for op in oplog:
            if op[0] == "account":
                ridx = op[3]
                if ridx in probe_vals:
                    self._finish_probes(ridx, probe_vals[ridx])
                down, up = self._account_bytes(op[1], op[2], op[4])
                self.telemetry.set_round_bytes(ridx, float(down.sum()),
                                               float(up.sum()))
                results.append(rounds[len(results)] + [down, up])
            else:
                sup = op[1]
                if isinstance(sup, dict):
                    sup = {"bitmap": next(it_s)}
                elif sup is not None:
                    sup = (next(it_s), next(it_s))
                self._apply_note(sup)
        return results

    def _finish_probes(self, ridx: int, vals: dict):
        """Complete round ``ridx``'s probe dict on the host (reference
        ``_finish_probes``, fed_model.py:938): the client-pass values
        kept for it, the residual growth ratio against the previous
        round's residual norm (rounds finish in dispatch order on both
        paths, so the ratio is always of consecutive rounds), merged
        onto the ledger record, then the alarm rules, which raise
        ``DivergenceAbort`` under ``--on_divergence abort``."""
        full = self._probe_host.pop(ridx, {})
        full.update(vals)
        rn = full.get("residual_norm")
        if rn is not None:
            prev = self._prev_residual
            if prev is not None and prev > 0:
                full["residual_growth"] = rn / prev
            self._prev_residual = rn
        self.telemetry.merge_round_probes(ridx, full)
        if self.alarm_engine is not None:
            self.alarm_engine.check(ridx, full)
        if self._autopilot is not None:
            # one observation a finished round, in dispatch order on
            # both the synchronous and the flush-replay path: the
            # controller (and its trajectory) sees the run's probe
            # stream exactly. On a mesh every rank observes rank 0's
            # values, so every rank moves on the same round to the same
            # point and their collectives keep matching
            obs = (full if self.mesh is None
                   else _from_rank0(full, AUTOPILOT_PROBES, self.mesh))
            new_key = self._autopilot.observe(ridx, obs)
            if new_key is not None:
                self._switch_variant(new_key)

    def _observe_slo(self, ridx: int, round_s: float, astats=None):
        """One SLO observation a synchronous round (reference
        fed_model.py:918-936): latency is the dispatch-through-metrics
        wall time, staleness the asynchronous driver's round stats, ε
        the accountant's after its charge. The burn probes ride the
        ledger record (where the live plane's ``slo_burn`` gauges read
        them), the per-objective stamp lands on the v6 ``slo`` key, and
        the slo_burn rule runs through ``check_slo``, never ``check``,
        which is stateful and already ran this round."""
        slo = self._slo
        eps = (self._accountant.epsilon()
               if self._accountant is not None else None)
        smax = (astats or {}).get("async_staleness_max")
        probes = slo.observe(ridx, round_s=round_s, staleness_max=smax,
                             dp_epsilon=eps)
        self.telemetry.merge_round_probes(ridx, probes)
        self.telemetry.set_round_slo(ridx, slo.stamp())
        if self.alarm_engine is not None:
            self.alarm_engine.check_slo(ridx, probes)

    def _switch_variant(self, key):
        """Move the dispatch point to lattice point ``key`` (reference
        fed_model.py:966-1001) and swap ``self.args`` to its config, so
        the byte accounting reprices from the next round on. With
        ``--autopilot_warm_ahead`` (the default) the variant is built
        now, in the current round's host phase, under the span
        ``autopilot_warm`` where it is not cached, and the flavor the
        next round dispatches is stamped here, as the reference stamps
        its ahead-of-time compile; only the point the controller just
        committed to is ever built. Without it an uncached variant is
        built at the next round's dispatch."""
        tel = self.telemetry
        warm = bool(self.args.autopilot_warm_ahead)
        if key in self._variants or warm:
            cmark, t0 = compile_mark(), clock.tick()
            if key in self._variants:
                var = self._variants.get(key)
            else:
                with tel.span("autopilot_warm"):
                    var = self._variants.get(key)
            nridx = self.round_index  # the next round to dispatch
            probed = (var.round_probed is not None
                      and nridx % self.probe_period == 0)
            flavor = "probed" if probed else "plain"
            if warm and flavor not in var.compiled:
                var.compiled.add(flavor)
                self._stamp_vcompile(key, cmark, clock.tick() - t0)
            self.args = var.cfg
        else:
            self.args = apply_knobs(self._autopilot_base, key)
        self._variant_key = key
        tel.count("autopilot_moves")

    def _stamp_vcompile(self, key, mark, secs):
        """Charge a variant flavor's first dispatch (or its warm-ahead
        build) to lattice point ``key`` on the current ledger record
        (reference fed_model.py:1003-1015): the kernel libraries loaded
        during it (``_build.load``), its host wall seconds, and one
        program."""
        ev, _ = compile_delta(mark)
        ks = key_str(key)
        tel = self.telemetry
        tel.count(f"vcompile_events:{ks}", ev)
        tel.count(f"vcompile_secs:{ks}", round(secs, 6))
        tel.count(f"vcompile_programs:{ks}", 1)

    def autopilot_record(self):
        """The controller's replayable trajectory record (a manifest's
        ``autopilot`` block), or None with the autopilot off."""
        return (None if self._autopilot is None
                else self._autopilot.record())

    def _call_val(self, batch):
        extra = () if self.stats_fn is None else (self.model_state,)
        with torch.no_grad():
            loss, metrics = self.compute_loss_val(
                self.ps_weights, self._to_device(batch), self.args, *extra)
        # the eval read is attributed like the train one (a no-op span
        # with no round open)
        with self.telemetry.span("metrics_host"):
            out = [m.to("cpu").numpy() for m in (loss,) + tuple(metrics)]
        mask = np.asarray(batch["mask"])
        counts = mask.reshape(mask.shape[0], -1).sum(axis=1)
        return out + [counts]

    # --- the host client store -------------------------------------------

    def attach_participant_feed(self, feed: Callable):
        """``feed() -> next round's participant client ids (or None)``:
        the sampler's one-round lookahead (``FedLoader.
        peek_next_client_ids``), which drives the prefetch thread so
        round N+1's gather overlaps round N (reference
        fed_model.py:477-484). A no-op under ``--clientstore device``."""
        self._participant_feed = feed

    def attach_arrival_process(self, fn):
        """A seeded arrival schedule for the asynchronous driver,
        ``fn(round_index, n) -> delays`` (tests and scripts, e.g.
        ``data/chaos.py ArrivalSchedule``; runs keep punctual arrival).
        Needs ``--async_buffer_size`` (reference fed_model.py:487)."""
        assert self._async_driver is not None, \
            "attach_arrival_process needs --async_buffer_size > 0"
        self._async_driver.attach_arrival_process(fn)

    def _submit_prefetch(self):
        if self._prefetcher is None:
            return
        # the driver knows the next fold's ids exactly when its backlog
        # holds a full buffer; the sampler's lookahead covers the rest,
        # and a wrong guess is a prefetch miss (a synchronous gather)
        ids = (self._async_driver.peek_next_ids()
               if self._async_driver is not None else None)
        if ids is None and self._participant_feed is not None:
            ids = self._participant_feed()
        if ids is not None:
            self._prefetcher.submit(np.asarray(ids, np.int64))

    def _gather_states(self, ids_np) -> ClientStates:
        """The round's participants' rows from the store (prefetched
        when the lookahead predicted them, else gathered now into
        page-locked staging on the card's runs), copied up as (W + 1,
        ...) tensors, the last row the dead-slot row (zeros). On a mesh
        every rank gathers all W from its own store (zeros where another
        rank owns the row), copies them up, and the sum over the ranks
        (``parallel/rows.py sum_owned_rows``, on the main thread) leaves
        this rank its slots' rows (``client_slice``), then the dead-slot
        row."""
        ids64 = np.asarray(ids_np, np.int64)
        W = len(ids64)
        tel = self.telemetry
        mesh = self.mesh
        t0 = time.perf_counter()
        with tel.span("gather"):
            rows = None
            if self._prefetcher is not None:
                rows = self._prefetcher.take(ids64)
                tel.count("prefetch_hit" if rows is not None
                          else "prefetch_miss")
            hit = rows is not None
            if rows is None:
                bufs = staging_buffers(self.client_store, W,
                                       self.device.type == "cuda",
                                       self._staging)
                rows, _ = self.client_store.gather(ids64, out=bufs)
        t1 = time.perf_counter()
        cuda = self.device.type == "cuda"
        timing = {"gather_s": t1 - t0, "h2d_s": None, "prefetch_hit": hit}
        with tel.span("h2d_state"):
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
            out = {}
            for name, arr in rows.items():
                n = W + 1 if mesh is None else W
                t = torch.empty((n,) + arr.shape[1:],
                                dtype=torch.float32, device=self.device)
                t[:W].copy_(torch.from_numpy(arr), non_blocking=True)
                if mesh is None:
                    t[W].zero_()
                out[name] = t
            if cuda:
                end.record()
                self._h2d_events = (start, end)
            else:
                timing["h2d_s"] = time.perf_counter() - t1
        if mesh is not None and out:
            with tel.span("store_exchange"):
                t2 = time.perf_counter()
                if cuda:
                    x0, x1 = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                    x0.record()
                sharded = is_sharded(W, mesh)
                for name, t in out.items():
                    mine = rowx.sum_owned_rows(t, mesh, sharded)
                    out[name] = torch.cat([mine, mine.new_zeros(
                        (1,) + tuple(mine.shape[1:]))])
                timing["exchange_bytes"] = sum(
                    4 * a.size for a in rows.values())
                if cuda:
                    x1.record()
                    self._xchg_events = (x0, x1)
                else:
                    timing["exchange_s"] = time.perf_counter() - t2
        self.store_timings.append(timing)
        return ClientStates(out.get("velocities"), out.get("errors"),
                            out.get("weights"))

    def _store_writeback(self):
        """Copy the pending round's participant rows down and write the
        live ones into the store (reference fed_model.py:530-561). Runs
        from ``FedOptimizer.step`` after the server round's velocity
        rewrite (true_topk's momentum masking lands in the store), and
        before the next gather, at a checkpoint save and at shutdown.
        Dead slots (dropout, padding) are not written, as the device
        path's dead-slot row keeps them out of every client's row. On a
        mesh the ranks' slot rows are all-gathered over ``clients``
        (``parallel/rows.py all_slot_rows``) and each rank copies down
        and writes only the live rows its store owns; every rank must
        call it (a collective)."""
        if self.client_store is None or self._store_pending is None:
            return
        with self.telemetry.span("writeback"):
            ids_np, alive = self._store_pending
            self._store_pending = None
            cs = self.client_states
            self.client_states = ClientStates(None, None, None)
            W = len(ids_np)
            dev = {name: val[:-1] for name, val in
                   (("velocities", cs.velocities), ("errors", cs.errors),
                    ("weights", cs.weights)) if val is not None}
            if not dev:
                return
            timing = self.store_timings[-1] if self.store_timings else {}
            cuda = self.device.type == "cuda"
            mesh = self.mesh
            if mesh is not None:
                t0 = time.perf_counter()
                if cuda:
                    x0, x1 = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                    x0.record()
                sharded = is_sharded(W, mesh)
                dev = {name: rowx.all_slot_rows(t, mesh, sharded)
                       for name, t in dev.items()}
                timing["wb_exchange_bytes"] = sum(
                    4 * t.numel() for t in dev.values())
                if cuda:
                    x1.record()
                else:
                    timing["wb_exchange_s"] = time.perf_counter() - t0
            # the live rows this rank's store owns (off a mesh, every
            # live row), alone copied down
            lo, hi = self.client_store.owned
            keep = np.nonzero(alive & (ids_np >= lo) & (ids_np < hi))[0]
            if len(keep) < W:
                sel = torch.as_tensor(keep).to(self.device)
                dev = {name: t.index_select(0, sel)
                       for name, t in dev.items()}
            t0 = time.perf_counter()
            if cuda:
                # page-locked buffers of W rows, reused: a round copies
                # down its kept rows into their head
                bufs = self._d2h
                for name, t in dev.items():
                    shape = (W,) + tuple(t.shape[1:])
                    buf = bufs.get(name)
                    if buf is None or tuple(buf.shape) != shape:
                        bufs[name] = torch.empty(
                            shape, dtype=torch.float32, pin_memory=True)
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                rows = {}
                for name, t in dev.items():
                    head = bufs[name][:t.shape[0]]
                    head.copy_(t, non_blocking=True)
                    rows[name] = head.numpy()
                end.record()
                end.synchronize()
                timing["d2h_s"] = start.elapsed_time(end) / 1e3
                if self._h2d_events is not None:
                    h0, h1 = self._h2d_events
                    timing["h2d_s"] = h0.elapsed_time(h1) / 1e3
                    self._h2d_events = None
                if self._xchg_events is not None:
                    e0, e1 = self._xchg_events
                    timing["exchange_s"] = e0.elapsed_time(e1) / 1e3
                    self._xchg_events = None
                if mesh is not None:
                    timing["wb_exchange_s"] = x0.elapsed_time(x1) / 1e3
            else:
                rows = {name: t.numpy() for name, t in dev.items()}
                timing["d2h_s"] = time.perf_counter() - t0
            if self._prefetcher is not None:
                # the staged gather of the next round reads the store
                # first: its LRU touches, then the write-back's
                # evictions, in one order whatever the threads do
                self._prefetcher.settle()
            t1 = time.perf_counter()
            spill0 = self.client_store.spill_s
            if len(keep):
                self.client_store.write(ids_np[keep], rows)
            timing["writeback_s"] = time.perf_counter() - t1
            timing["spill_s"] = self.client_store.spill_s - spill0

    def finalize(self):
        """Shutdown (reference fed_model.py:445-456): the open profiler
        round range closed, the pending round's write-back, then the
        prefetch thread joined, the store closed (its temporary spill
        directory removed) and the telemetry flushed and closed."""
        trace.end_round_marker()
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None
        self._store_writeback()
        if self.client_store is not None:
            self.store_stats = dict(self.client_store.stats)
            self.client_store.close()
            self.client_store = None
        self.telemetry.close()

    def interrupted(self):
        """After a signal cut a round short (reference
        fed_model.py:458-475): drop every dispatched round's host-side
        state, so ``finalize`` writes nothing the last autosave did not
        see (a half-written-back round would put the store's rows out
        of step with the saved server state)."""
        self._inflight = []
        self._oplog = []
        self._probe_log = {}
        self._probe_host = {}
        self.pending_aggregated = None
        self.pending_client_ids = None
        self._store_pending = None

    def _charge_privacy(self, ridx, cfg, staleness, mask):
        """Charge the round's ``--dp sketch`` release (reference
        ``_charge_privacy``, fed_model.py:868-905). A staleness-weighted
        round charges the reduced sensitivity ``weight_scale = (1 +
        s_min)^-alpha``, the largest fold weight among the round's
        alive slots: the DP fold divides by the static W·B, so a
        client's released share is genuinely scaled by its weight. A
        round with no alive slot charges 1. The round's ledger record
        gets the ε after the charge, its δ and σ / w (schema v5); with
        a budget (``--dp_epsilon`` > 0) the ε goes to the alarm engine,
        so ``--on_divergence abort`` stops the run at the round that
        spent it. σ is the dispatched variant's ``dp_noise_mult`` (a
        geometry move recalibrates it: autopilot/lattice.py)."""
        w = 1.0
        alpha = float(cfg.async_staleness_weight)
        if staleness is not None and alpha > 0.0:
            s = np.asarray(staleness, np.float64)
            alive = np.asarray(mask).reshape(s.shape[0], -1).sum(axis=1) > 0
            if alive.any():
                w = float(min((1.0 + float(s[alive].min())) ** (-alpha),
                              1.0))
        acc = self._accountant
        sigma = float(cfg.dp_noise_mult)
        acc.step(weight_scale=w, sigma=sigma)
        eps = acc.epsilon()
        self.telemetry.set_round_privacy(ridx, eps, acc.delta, sigma / w)
        budget = float(cfg.dp_epsilon)
        if self.alarm_engine is not None and budget > 0:
            self.alarm_engine.check(ridx, {
                "dp_epsilon": eps, "dp_delta": acc.delta,
                "dp_sigma": sigma / w,
                # projected at weight scale 1: later rounds' staleness
                # weights are not known yet
                "dp_rounds_left": acc.rounds_left(budget, sigma=sigma)})

    def privacy_epsilon(self) -> Optional[float]:
        """The ε spent so far at ``--dp_delta`` under ``--dp sketch``
        (0.0 before the first round); None with ``--dp off``."""
        if self._accountant is None:
            return None
        return self._accountant.epsilon()

    # --- the final model ---------------------------------------------------

    def params(self) -> dict:
        """The current server weights as the module's flax parameter
        tree of numpy f32 arrays, keys sorted as the reference's
        ``unravel`` gives them (reference ``params``,
        fed_model.py:565)."""
        return self.module.to_params_tree(self.ps_weights)

    def save_pretrained(self, save_dir: str, hf_format: bool = False,
                        torch_format: bool = False):
        """The final model as a run directory (reference
        ``save_pretrained``, fed_model.py:570-634): the weights as
        ``flax_model.msgpack`` (byte-equal to the reference's for the
        same weights) and, for GPT-2, the module's config as
        ``config.json``, its fields whose values are int, float, str,
        bool or None (``models/gpt2.py saved_config``; the port's CV
        modules carry no config object). ``hf_format`` (GPT-2 only)
        writes the HF ``transformers`` ``config.json`` in its place and
        ``pytorch_model.bin`` beside it, so the directory loads with
        ``GPT2DoubleHeadsModel.from_pretrained`` and with this
        package's and the reference's reload. ``torch_format`` (a CV
        model) also writes ``state_dict.pt``, a torch ``state_dict``
        with the reference torch modules' key names and layouts
        (``models/torch_export.py``), with the running statistics where
        the model tracks them."""
        from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                         convert_gpt2_to_hf,
                                                         saved_config)
        from commefficient_tpu_torch.models.torch_export import \
            save_torch_state_dict
        cfg = getattr(self.module, "cfg", None)
        if hf_format and not isinstance(cfg, GPT2Config):
            raise ValueError("hf_format export is defined for GPT-2 "
                             "modules only")
        os.makedirs(save_dir, exist_ok=True)
        params = self.params()
        if torch_format:
            save_torch_state_dict(self.module, params, self.model_state,
                                  os.path.join(save_dir, "state_dict.pt"))
        # config first: weights without a config would rebuild the
        # wrong architecture on reload
        if hf_format:
            sd, hf_cfg = convert_gpt2_to_hf(params, cfg)
            with open(os.path.join(save_dir, "config.json"), "w") as f:
                json.dump(hf_cfg, f, indent=2)
            torch.save({k: torch.from_numpy(np.array(v, copy=True))
                        for k, v in sd.items()},
                       os.path.join(save_dir, "pytorch_model.bin"))
        elif isinstance(cfg, GPT2Config):
            with open(os.path.join(save_dir, "config.json"), "w") as f:
                json.dump(saved_config(cfg), f, indent=2)
        with open(os.path.join(save_dir, "flax_model.msgpack"), "wb") as f:
            f.write(msgpack_serialize(params))

    def _emit_cost_model(self, batch):
        """Roofline expectation for this run's round (analysis/cost.py):
        the model's forward and backward once on ``batch`` under the
        FLOP counter (the reference lowers its round program instead),
        then the cost model as a ledger meta record. Registers
        ``expected_round_s`` on the telemetry, so the trace window's
        device-time buckets carry ``roofline_utilization``. The pass
        writes no state and steps nothing: its gradient is dropped and
        the random generators are restored. A failure degrades to a
        warning and is not retried."""
        self._cost_model = {}
        try:
            from commefficient_tpu_torch.analysis.cost import (
                build_cost_model, flop_inventory)
            dev_batch = self._to_device(batch)
            mask = dev_batch["mask"]

            def client_pass():
                # a leaf of its own, whose .grad is dropped with it
                # (the counter's module hooks refuse autograd.grad)
                p = self.ps_weights.detach().requires_grad_(True)
                loss, _ = self.compute_loss_train(p, dev_batch, self.args)
                torch.sum(loss * torch.sum(mask, dim=-1)).backward()

            on_gpu = self.device.type == "cuda"
            with torch.random.fork_rng(
                    devices=[self.device] if on_gpu else []):
                flops = flop_inventory(client_pass)
            if on_gpu:
                torch.cuda.synchronize(self.device)
            cost = build_cost_model(
                flops, backend="gpu" if on_gpu else "cpu",
                device_kind=(torch.cuda.get_device_name(self.device)
                             if on_gpu else "cpu"),
                n_devices=1,
                allreduce_payload_bytes=float(
                    self.args.upload_wire_bytes_per_client),
                wire_dtype=self.args.sketch_dtype,
                label=f"{self.args.mode}/{self.clientstore}/1dev")
            cost["kernel_flops"] = flops["kernel_flops"]
            self._cost_model = cost
            self.telemetry.expected_round_s = cost["expected_round_s"]
            self.telemetry.emit_meta(cost_model=cost)
        except Exception as e:  # noqa: BLE001 -- observability only
            print(f"WARNING: roofline cost model skipped "
                  f"({type(e).__name__}: {e})")

    # --- communication accounting ----------------------------------------

    def _rebuild_round_counts(self):
        """Histogram of ``last_updated`` by round (index = round + 1):
        #coords changed since a client last synced at round s is the
        suffix sum from index s + 2."""
        self._round_counts = np.bincount(
            self.last_updated + 1,
            minlength=self._update_round + 2).astype(np.int64)

    def _account_bytes(self, ids_np, mask=None, cfg=None):
        """Per-round download/upload bytes per client. Clients whose
        mask rows are all zero uploaded nothing. ``cfg`` is the
        dispatched round variant's config (its wire dtype and sketch
        geometry price the round); ``self.args`` by default."""
        cfg = self.args if cfg is None else cfg
        download_bytes = np.zeros(self.num_clients)
        suffix = np.cumsum(self._round_counts[::-1])[::-1]
        q = self.client_last_seen[ids_np] + 2
        changed = np.where(
            q < len(suffix), suffix[np.minimum(q, len(suffix) - 1)], 0)
        if cfg.downlink_encoding == "delta":
            # a client that saw the previous broadcast holds its support
            # list, so repeats delta-code against it; anyone staler
            # downloads every changed coordinate as (idx, val)
            fresh = (self.client_last_seen[ids_np]
                     == self._update_round - 1)
            download_bytes[ids_np] = [
                accounting.delta_downlink_bytes(
                    c, self._repeat_count, self._bitmap_bits,
                    cfg.sketch_dtype, have_prev=bool(hp))
                for c, hp in zip(changed, fresh)]
        else:
            download_bytes[ids_np] = changed * accounting.bytes_of(1, "f32")
        self.client_last_seen[ids_np] = self._update_round
        upload_bytes = np.zeros(self.num_clients)
        up_ids = ids_np
        if mask is not None:
            up_ids = ids_np[np.asarray(mask).sum(axis=1) > 0]
        upload_bytes[up_ids] = float(cfg.upload_wire_bytes_per_client)
        return download_bytes, upload_bytes

    def note_update(self, support):
        """Record the server update's support for download accounting
        (reference ``note_update``, ``_apply_note`` and
        ``_note_delta_support``, fed_model.py:1128-1212), at once or,
        pipelined, at the next ``flush``: {"bitmap": (ceil(d/8),)
        uint8}, the packed mask of the coordinates it changed (big-endian
        bits, ``ops/vec.py packbits``); or ((k,) indices, (k,) lr-scaled
        values), of which the indices with a nonzero value changed; or
        None, a dense update: every coordinate changed.

        The --downlink_encoding delta bookkeeping rolls forward with
        it: how many of this update's indices repeat the previous
        update's support (they ship as bitmap bits, not int32 indices,
        to a client that saw the previous broadcast), and that
        support's size (the bitmap's bit count). The previous support
        is exactly the coordinates whose ``last_updated`` is the
        previous update, so both are counts taken here -- the
        reference's ``intersect1d`` with a kept index array gives the
        same numbers, in a sort of both supports."""
        if self.pipeline_depth > 1:
            self._oplog.append(("note", support))
            return
        self._apply_note(support)

    def _apply_note(self, support):
        self._update_round += 1
        r = self._update_round
        if len(self._round_counts) < r + 2:
            self._round_counts = np.concatenate(
                [self._round_counts,
                 np.zeros(r + 2 - len(self._round_counts) + 64, np.int64)])
        # coordinates last changed by update r - 1 sit at index r
        self._bitmap_bits = int(self._round_counts[r])
        if support is None:
            self._repeat_count = self._bitmap_bits
            self.last_updated[:] = r
            self._round_counts[:] = 0
            self._round_counts[r + 1] = self.args.grad_size
            return
        if isinstance(support, dict):
            # unpacked and trimmed to d (fed_model.py:1170-1172); the
            # 0/1 bytes read as bool, where np.flatnonzero is fastest
            bits = np.unpackbits(_np(support["bitmap"]),
                                 count=self.args.grad_size)
            idx = np.flatnonzero(bits.view(bool))
        else:
            idx, vals = (_np(t) for t in support)
            idx = idx[vals != 0].astype(np.int64)
        old = self.last_updated[idx] + 1
        self._repeat_count = int(np.count_nonzero(old == r))
        self._round_counts -= np.bincount(
            old, minlength=len(self._round_counts))
        self._round_counts[r + 1] += len(idx)
        self.last_updated[idx] = r


def _round_total(mask, staleness, cfg) -> float:
    """The whole round's fold denominator, which a mesh rank holding a
    slice of the clients cannot sum alone: its datapoints, or under the
    staleness-weighted fold Σ cw·n in f32 as one device sums it
    (core/rounds.py), at least 1."""
    mask = np.asarray(mask)
    alpha = float(cfg.async_staleness_weight)
    if staleness is None or alpha == 0.0:
        return max(float(np.sum(mask)), 1.0)
    n = torch.from_numpy(mask.reshape(mask.shape[0], -1).astype(
        np.float32)).sum(1)
    cw = staleness_weights(torch.from_numpy(np.asarray(staleness)), alpha)
    return float(torch.clamp(torch.sum(cw * n), min=1.0))


#: the probes the autopilot's controller reads (autopilot/controller.py
#: ``observe``)
AUTOPILOT_PROBES = ("recovery_error", "agg_nan", "agg_inf")


def _from_rank0(vals: dict, keys, mesh) -> dict:
    """``vals``' ``keys`` as rank 0 holds them, broadcast over the
    world group (a key rank 0 lacks is absent on every rank)."""
    x = torch.tensor([float(vals[k]) if vals.get(k) is not None
                      else float("nan") for k in keys],
                     dtype=torch.float64, device=mesh.device)
    present = torch.tensor([vals.get(k) is not None for k in keys],
                           dtype=torch.float64, device=mesh.device)
    both = torch.stack([x, present])
    dist.broadcast(both, src=0, group=mesh.world.group)
    out = dict(vals)
    for k, v, on in zip(keys, both[0].tolist(), both[1].tolist()):
        if on:
            out[k] = v
        else:
            out.pop(k, None)
    return out


def _probe_values(probes: dict) -> dict:
    """A round's probe scalars (0-dim device tensors) as floats, copied
    to the host in one batch."""
    keys = list(probes)
    return {k: float(v) for k, v in
            zip(keys, _to_host([probes[k] for k in keys]))}


def _np(x) -> np.ndarray:
    return x.to("cpu").numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _support_tensors(support) -> list:
    if support is None:
        return []
    if isinstance(support, dict):
        return [support["bitmap"]]
    return list(support)


def _to_host(tensors) -> list:
    """Tensors -> numpy arrays, in one batch: on the card each is
    copied into a pinned buffer with ``non_blocking=True``, then one
    event wait (the pipelined rounds' one host sync)."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for buf, t in zip(bufs, tensors):
        buf.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return [buf.numpy() for buf in bufs]


def drain_rounds(model, pending, process, force) -> bool:
    """The trainer's side of the pipeline (reference ``drain_rounds``,
    fed_model.py:1203): ``model.flush(force)``'s rounds in dispatch
    order, each passed to ``process(metrics, *context)`` with the
    context its dispatch queued in ``pending``. False as soon as
    ``process`` returns False (a divergence stop)."""
    for metrics in model.flush(force=force):
        if not process(metrics, *pending.pop(0)):
            return False
    return True


class FedOptimizer:
    """Server-side optimizer. ``param_groups`` is torch-shaped so LR
    schedulers port unchanged. One group gives a scalar LR; several,
    each with an ``index`` array of flat coordinates
    (``ops/vec.py param_group_indices``: the Fixup bias and scale
    groups), a per-coordinate LR: one indicator vector per group on the
    device, built once, and ``get_lr`` their LR-weighted sum (reference
    fed_model.py:1230-1288), so a step ships only scalars."""

    def __init__(self, param_groups=None, args: Config = None,
                 model: Optional[FedModel] = None):
        self.model = model or _CURRENT_MODEL
        assert self.model is not None, "construct FedModel first"
        self.args = args or self.model.args
        if param_groups is None:
            param_groups = [{"lr": 1.0}]
        if isinstance(param_groups, dict):
            param_groups = [param_groups]
        self.param_groups = param_groups
        self._lr_indicators = None
        if len(param_groups) > 1:
            assert all("index" in g for g in param_groups), \
                "multi-group LR needs each group's flat 'index'"
            inds = []
            for group in param_groups:
                ind = torch.zeros(self.args.grad_size, dtype=torch.float32)
                ind[torch.as_tensor(np.asarray(group["index"], np.int64))] = 1
                inds.append(ind.to(self.model.device))
            self._lr_indicators = inds
        # on a model axis the momentum and error are this rank's column
        # shards or coordinate windows from the start (1/M of the state
        # a rank)
        mesh = self.model.mesh
        self.server_state = ServerState.init(
            self.args, self.model.device, model_axis_size(mesh),
            0 if mesh is None else mesh.model.index)
        # the geometry the live server state was allocated for: a knob
        # move that changes transmit_shape (--autopilot_geometry)
        # re-seeds the momentum/error tables at the new shape
        self._server_geom = tuple(self.args.transmit_shape)
        self._probes = self.model.probe_period > 0
        self._server_round = build_server_round(self.args,
                                                probes=self._probes,
                                                mesh=mesh)
        # the legacy --do_dp server noise: step s draws from the
        # (seed + 1, s) stream
        self._server_noise = (self.args.do_dp
                              and self.args.dp_mode == "server"
                              and self.args.noise_multiplier != 0)
        self._step_count = 0

    def get_lr(self):
        """A float, or with index groups a (d,) tensor on the device."""
        if self._lr_indicators is None:
            return self.param_groups[0]["lr"]
        return sum(float(g["lr"]) * ind for g, ind in
                   zip(self.param_groups, self._lr_indicators))

    def step(self):
        m = self.model
        assert m.pending_aggregated is not None, \
            "call model(batch) before opt.step()"
        lr = self.get_lr()
        vector_lr = isinstance(lr, torch.Tensor)
        if not vector_lr:
            lr = float(lr)
        if all(float(g["lr"]) == 0 for g in self.param_groups):
            print("WARNING: LR is 0")
        if self.args.mode == "fedavg":
            assert not vector_lr, "fedavg supports scalar lr only"
            # the next round's clients run their local SGD at this LR;
            # the server step itself takes lr = 1
            m.fedavg_lr = lr
        self._step_count += 1
        gen = (noise_generator(self.args.seed + 1, self._step_count,
                               SERVER_NOISE_TAG, m.device)
               if self._server_noise else None)
        server_fn, svar = self._server_round, None
        if m._autopilot is not None:
            # the pending aggregate was emitted by one round variant:
            # its server round (the wire dequant and the unsketch
            # geometry) must match (reference fed_model.py:1305-1350)
            svar = m._variants.get(m.pending_variant_key)
            mesh = m.mesh
            if svar.server_fn is None:
                svar.server_fn = build_server_round(svar.cfg,
                                                    probes=self._probes,
                                                    mesh=mesh)
            geom = tuple(svar.cfg.transmit_shape)
            if geom != self._server_geom:
                # a geometry move: the sketch-shaped server tables are
                # re-seeded at the new shape (momentum restarts; the
                # geometry steps are opt-in for this reason), this
                # rank's shard of them on a model axis
                self.server_state = ServerState.init(
                    svar.cfg, m.device, model_axis_size(mesh),
                    0 if mesh is None else mesh.model.index)
                self._server_geom = geom
            server_fn = svar.server_fn
        sfirst = svar is not None and "server" not in svar.compiled
        cmark = compile_mark() if sfirst else None
        t0 = clock.tick() if sfirst else None
        # the round's ledger record is still current (the next round's
        # begin closes it), so the span lands on the round whose
        # aggregate it consumes
        with m.telemetry.span("server"), trace.phase("server"):
            out = server_fn(m.ps_weights, self.server_state,
                            m.pending_aggregated, lr,
                            m.client_states.velocities,
                            m.pending_client_ids, gen)
        if sfirst:
            svar.compiled.add("server")
            m._stamp_vcompile(svar.key, cmark, clock.tick() - t0)
        sprobes = out[5] if self._probes else None
        new_ps, self.server_state, new_vel, update, support = out[:5]
        m.ps_weights = new_ps
        m.client_states = m.client_states._replace(velocities=new_vel)
        m.pending_aggregated = None
        # the host store: the round's rows (with the velocity rewrite
        # above) go back to the host now
        m._store_writeback()
        if support is None:
            # a dense update (uncompressed, local_topk, fedavg). A zero
            # LR moves nothing; local_topk's update holds only the union
            # of past top-k selections, and fedavg's first one is zero
            # (its clients ran at LR 0), so both take the reference's
            # value-compare, packed on the device
            # (fed_model.py:1384-1391), as does a per-coordinate LR
            # (a group at LR 0 changes nothing); otherwise every
            # coordinate changed
            if self.args.mode != "fedavg" and not vector_lr and lr == 0:
                none = torch.zeros(0, device=m.device)
                support = (none.to(torch.int64), none)
            elif self.args.mode in ("local_topk", "fedavg") or vector_lr:
                support = {"bitmap": packbits(update != 0)}
        m.note_update(support)
        if sprobes is not None:
            # the round this server pass belongs to (_call_train already
            # advanced round_index)
            sridx = m.round_index - 1
            if m.pipeline_depth > 1:
                # stays on the device: read at the flush, in round
                # order, with the client-pass probes
                m._probe_log.setdefault(sridx, {}).update(sprobes)
            else:
                with m.telemetry.span("metrics_host"):
                    svals = _probe_values(sprobes)
                m._finish_probes(sridx, svals)


class LambdaLR:
    """Minimal torch-compatible LR scheduler: lr = base_lr *
    lr_lambda(step)."""

    def __init__(self, optimizer: FedOptimizer, lr_lambda, base_lrs=None):
        self.optimizer = optimizer
        self.lr_lambda = lr_lambda
        self.base_lrs = base_lrs or [g["lr"]
                                     for g in optimizer.param_groups]
        self._step = 0

    def step(self):
        for g, base in zip(self.optimizer.param_groups, self.base_lrs):
            g["lr"] = base * self.lr_lambda(self._step)
        self._step += 1

"""FedService: the long-lived multi-tenant federation daemon.

Port of ``commefficient_tpu/fedservice/service.py``: ``admit``, ``tick``
under the ``fair`` and ``backlog`` policies, ``run``, ``_run_round``,
``_fairness_probes``, ``migrate``, ``slo_burning_jobs`` and ``close``,
with ``_LOCK_MAP``'s locking. The pod is a list of ``torch.device``s
(the visible cards by default; tests pass CPU devices). A spatial job
gets a consecutive block of C·M free devices (the reference's
``carve_submeshes`` carves it into a mesh): a block of one
card runs the job in the daemon, its builder handed the card where the
reference's is handed a mesh; a block of more runs it in C·M worker
processes, one a card, joined into a process group of their own
(``fedservice/spatial.py``), the builder called in each rank with the
block's ``--num_devices``/``--mesh``. ``migrate`` goes through
``runtime/checkpoint.py`` between any two footprints.

One service instance owns one pod and runs J admitted jobs over it.
Each job is the ordinary single-job stack — its own FedModel (own
ledger shard, alarm engine, DP accountant, RNG stream keyed by its
own seed) — so the daemon's value-add is purely control-plane:
admission, scheduling, fairness observability, and elastic migration.
A single job driven through the daemon is bit-identical (ledger
records and final server state) to driving the model directly;
``tests/test_torch_fedservice.py`` and ``chip_smoke.py``'s
``service_paths`` pin that.

Scheduling
----------
``policy="fair"`` round-robins: every runnable job steps one round
per tick. ``policy="backlog"`` greedily steps only the job with the
largest remaining backlog each tick — deliberately starvable, which
is what the ``job_starvation`` alarm drill exercises.

Telemetry
---------
The service writes its OWN ledger at the base ``cfg.ledger`` path —
one record per scheduler tick carrying the fairness probes
(occupancy, backlog, starvation, admission rejections). Job records
go to ``<ledger>.job<j>.jsonl`` shards (``telemetry.sinks.
job_ledger_path``) that stay byte-equivalent to solo-run ledgers.
"""

import dataclasses
import os
import tempfile
import threading

import numpy as np
import torch

from commefficient_tpu_torch.fedservice.job import AdmissionError, JobSpec
from commefficient_tpu_torch.fedservice.spatial import (SpatialJob,
                                                        SpatialJobError,
                                                        spatial_cfg)
from commefficient_tpu_torch.runtime.checkpoint import (RoundAutosaver,
                                                        load_checkpoint,
                                                        save_checkpoint)
from commefficient_tpu_torch.telemetry import clock, registry
from commefficient_tpu_torch.telemetry.alarms import (AlarmEngine,
                                                      DivergenceAbort)
from commefficient_tpu_torch.telemetry.causal import (SEQ_ADMIT, SEQ_GRANT,
                                                      SEQ_ROOT,
                                                      build_causal_tracer,
                                                      span_id, trace_id)
from commefficient_tpu_torch.telemetry.core import build_telemetry
from commefficient_tpu_torch.telemetry.live import (LiveMetricsSink,
                                                    attach_live_plane,
                                                    ensure_server,
                                                    live_registry)
from commefficient_tpu_torch.telemetry.sinks import (job_ledger_path,
                                                     recover_ledger_shards)
from commefficient_tpu_torch.telemetry.slo import build_slo_engine

#: lock-confinement declarations: the scheduler state is read by probe/admission paths that outlive the
#: tick loop — an HTTP scrape asking ``active_jobs`` or an operator
#: admitting a tenant while a tick runs must not iterate ``_jobs``
#: while ``admit`` appends, and the device free-list carve must be
#: atomic. ``_ticks``/``_admitted``/``_rejected`` are plain counters
#: touched only by the single scheduler thread — deliberately not
#: declared.
_LOCK_MAP = {"_jobs": "_lock", "_by_id": "_lock", "_free": "_lock"}


class _Job:
    """Internal per-tenant record: spec + live runtime objects +
    scheduler bookkeeping. ``device`` is the reserved card (None for
    time-sliced jobs — their FedModel runs on the pod's first card and
    shares it with the other time-sliced jobs — and for a spatial job of
    several cards, whose ranks run in ``spatial``'s worker processes
    while ``model``/``opt`` stay None)."""

    def __init__(self, spec, index, cfg, device, devices):
        self.spec = spec
        self.index = int(index)
        self.cfg = cfg          # ledger rewritten to the job shard
        self.device = device
        self.devices = devices  # reserved pod devices (spatial only)
        self.model = None
        self.opt = None
        self.spatial = None
        self.error = None       # a failed spatial job's traceback
        self.autosaver = None
        self.rounds_done = 0
        self.ran_ticks = 0
        self.starved_ticks = 0
        self.done = False
        self.final_state = None
        # --causal_trace bookkeeping: monotonic instant the job last
        # became runnable (admission / previous grant) — the begin of
        # its next round's sched_grant span
        self.wait_since = None

    def backlog(self) -> int:
        return max(0, int(self.spec.rounds) - self.rounds_done)


class FedService:
    """The daemon. ``cfg`` is the SERVICE's Config — its ``ledger``
    is the base path the job shards hang off, and its alarm knobs
    (``--alarm_job_starvation``, ``--on_divergence``) arm the
    service's own AlarmEngine. Jobs bring their own Configs inside
    their :class:`JobSpec`.

    ``runs_dir`` (optional) stamps one registry manifest per admitted
    job (``job_id`` + ``service_run`` lineage keys). ``ckpt_dir``
    holds migration checkpoints (a tempdir by default). ``devices``
    is the pod (the visible cards by default).
    """

    POLICIES = ("fair", "backlog")

    def __init__(self, cfg, *, policy: str = "fair", runs_dir: str = "",
                 ckpt_dir: str = "", devices=None):
        assert policy in self.POLICIES, policy
        self.cfg = cfg
        self.policy = policy
        self.runs_dir = runs_dir
        self._ckpt_dir = ckpt_dir
        self._devices = list(devices) if devices is not None \
            else [torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())]
        self._lock = threading.Lock()
        self._free = list(self._devices)
        self._jobs = []
        self._by_id = {}
        self._ticks = 0
        self._admitted = 0
        self._rejected = 0
        # restart hygiene: a daemon SIGKILLed mid-write leaves a torn
        # tail on whichever shard was flushing — and a tenant that is
        # never re-admitted would leave it there forever, poisoning
        # ledger_merge. Sweep the base path and EVERY sibling shard
        # (.p<k>, .job<j>, and job shards' process shards) before any
        # sink reopens them.
        base = getattr(cfg, "ledger", "") or ""
        if base:
            for shard, n in recover_ledger_shards(base).items():
                print(f"WARNING: recovered torn ledger tail "
                      f"({n} bytes) at {shard}")
        self.telemetry = build_telemetry(cfg)
        # constructed directly (not build_alarm_engine) so the
        # always-armed admission_rejected rule fires even when no
        # threshold knob is set on the service cfg
        self.engine = AlarmEngine(cfg, self.telemetry)
        # live operations plane: the daemon's own fairness/SLO series
        # export under job="service"; each admitted job's FedModel
        # attaches its own sink (job=<j> labels) to the same process
        # registry, so one scrape endpoint carries the whole pod
        self.live_sink, self.flightrec = attach_live_plane(
            self.telemetry, cfg, labels={"job": "service"},
            runs_dir=runs_dir)
        # service-level SLO engine (starvation objective, typically):
        # observed once per scheduler tick; None with no target set
        self._slo = build_slo_engine(cfg)
        # causal tracer (--causal_trace on the service cfg): tick
        # records carry the daemon's own span DAGs, and admission /
        # scheduler-grant spans are stamped INTO each tenant's round
        # trace by deterministic id (they ride the next tick record
        # with a trace override; ledger_merge stitches them)
        self.telemetry.set_causal_tracer(
            build_causal_tracer(cfg, job="service"))
        self._causal = self.telemetry.causal

    # ------------------------------------------------------------ admission

    def admit(self, spec: JobSpec) -> int:
        """Validate ``spec`` against the pod and bring the job up.

        Returns the job index ``j`` (its ledger shard is
        ``<ledger>.job<j>.jsonl``). Raises :class:`AdmissionError`
        after counting the rejection in the service ledger, so the
        ``admission_rejected`` alarm fires even when the caller
        swallows the exception."""
        try:
            spec.validate()
            if str(spec.job_id) in self._by_id:
                raise AdmissionError(
                    f"job id {spec.job_id!r} already admitted")
            with self._lock:
                for other in self._jobs:
                    if int(other.cfg.seed) == int(spec.cfg.seed):
                        raise AdmissionError(
                            f"job {spec.job_id}: seed {spec.cfg.seed}"
                            f" collides with job "
                            f"{other.spec.job_id!r} — per-job RNG "
                            "streams must be disjoint")
            need = spec.demand_devices()
            if need > len(self._free):
                raise AdmissionError(
                    f"job {spec.job_id}: mesh demand "
                    f"{spec.mesh_demand[0]}x{spec.mesh_demand[1]} "
                    f"needs {need} devices, pod has "
                    f"{len(self._free)} free of {len(self._devices)}")
            if str(getattr(spec.cfg, "dp", "off")) != "off" and \
                    float(getattr(spec.cfg, "dp_epsilon", 0.0)
                          or 0.0) <= 0:
                raise AdmissionError(
                    f"job {spec.job_id}: DP mode needs a positive "
                    "epsilon budget for the per-job accountant")
        except AdmissionError:
            self._count_rejection()
            raise
        admit_b = clock.tick()

        burning = self.slo_burning_jobs()
        if burning:
            # admission flag, not refusal: a tenant burning its error
            # budget means the pod is already failing someone — the
            # operator should know BEFORE a new job compounds the
            # load. The meta record and per-job manifest carry the
            # flag; the admission itself proceeds.
            print(f"WARNING: admitting {spec.job_id!r} while job(s) "
                  f"{burning} are burning their SLO error budget")
            self.telemetry.emit_meta(
                slo_burning_at_admission=burning,
                admitted_job=str(spec.job_id))

        index = self._admitted
        self._admitted += 1
        devices = self._carve(spec.mesh_demand) if need else None
        base = getattr(self.cfg, "ledger", "") or ""
        shard = job_ledger_path(base, index) if base else ""
        # the operations plane is pod-scoped: a daemon with
        # --live_port / --flightrec_rounds arms every tenant's sink
        # on the shared process registry too (a job cfg's own setting
        # wins). Both knobs are config-hash-excluded, so the shard
        # stays bit-identical to a solo run's ledger.
        plane = {}
        if getattr(self.cfg, "live_port", 0) \
                and not getattr(spec.cfg, "live_port", 0):
            plane["live_port"] = self.cfg.live_port
        if getattr(self.cfg, "flightrec_rounds", 0) \
                and not getattr(spec.cfg, "flightrec_rounds", 0):
            plane["flightrec_rounds"] = self.cfg.flightrec_rounds
            plane["postmortem_dir"] = self.cfg.postmortem_dir
        if getattr(self.cfg, "causal_trace", False) \
                and not getattr(spec.cfg, "causal_trace", False):
            plane["causal_trace"] = True
        cfg = dataclasses.replace(spec.cfg, ledger=shard, **plane)
        if cfg.on_mesh:
            # a tenant's own --num_devices (-1: every visible card)
            # builds no mesh: its footprint is the service's to place.
            # Where it asks for one card already, its config (and hash)
            # stays the solo run's
            cfg = dataclasses.replace(cfg, num_devices=1)
        job = _Job(spec, index, cfg, None, devices)
        try:
            self._bring_up(job)
        except BaseException:
            self._release(job)
            raise
        with self._lock:
            self._jobs.append(job)
            self._by_id[str(spec.job_id)] = job
        job.wait_since = clock.tick()
        if self._causal is not None:
            # the tenant's round-0 trace gets the admission span;
            # parent=None makes it a root anchor (it precedes the
            # round root in time and may sit on another clock)
            self._causal.add_event(
                "admission", admit_b, job.wait_since,
                trace=trace_id(index, 0),
                sid=span_id(index, 0, SEQ_ADMIT), parent=None)
        if self.runs_dir:
            c, m = spec.mesh_demand or (1, 1)
            registry.write_manifest(
                self.runs_dir, args=cfg, ledger=shard,
                mesh_shape=dict({"clients": int(c)},
                                **({"model": int(m)} if int(m) > 1
                                   else {})),
                extra={"job_id": str(spec.job_id),
                       "service_run": True,
                       "config_hash": registry.config_hash(cfg),
                       **({"slo_burning_at_admission": burning}
                          if burning else {})})
        return index

    def _carve(self, demand) -> list:
        """The first C·M free devices, the block of a (C, M) demand: rank
        c·M + m of the job takes its (c·M + m)-th, as ``make_mesh2d``
        lays a mesh out."""
        need = int(demand[0]) * int(demand[1])
        with self._lock:
            devices, self._free = self._free[:need], self._free[need:]
        return devices

    def _release(self, job: _Job):
        """Give the job's block back to the pod."""
        if job.devices:
            with self._lock:
                self._free.extend(job.devices)
            job.devices = None

    def _bring_up(self, job: _Job, restore: str = ""):
        """Build the job on its block (restoring the checkpoint at
        ``restore``): a block of several devices in spatial worker
        processes, else the builder in the daemon on the block's card
        (None: time-sliced)."""
        cfg, spec = job.cfg, job.spec
        job.model = job.opt = job.spatial = job.autosaver = None
        job.device = None
        if job.devices and len(job.devices) > 1:
            demand = tuple(int(x) for x in spec.mesh_demand)
            job.spatial = SpatialJob(
                spatial_cfg(dataclasses.replace(cfg, live_port=0), demand),
                spec.builder, job.devices, demand,
                autosave_tag=f"job{job.index}",
                on_records=self._live_relay(cfg, job.index))
            if restore:
                job.spatial.restore(restore)
            return
        if job.devices:
            job.device = job.devices[0]
        job.model, job.opt = spec.builder(cfg, job.device)
        if restore:
            load_checkpoint(restore, job.model, job.opt)
        if int(getattr(cfg, "checkpoint_every_rounds", 0) or 0) > 0:
            os.makedirs(cfg.checkpoint_path, exist_ok=True)
            job.autosaver = RoundAutosaver(
                cfg, job.model, job.opt, None, None, None,
                tag=f"job{job.index}")

    def _live_relay(self, cfg, index):
        """Where a spatial job's rank-0 records go in the daemon: the
        live sink its FedModel would attach in the daemon's process
        (the workers' own exporters are off), or None."""
        port = int(getattr(cfg, "live_port", 0) or 0)
        if port <= 0:
            return None
        ensure_server(port)
        sink = LiveMetricsSink(live_registry(), {
            "process": 0, "run": registry.config_hash(cfg)[:8],
            "job": index})

        def relay(records):
            for rec in records:
                sink.write(rec)
        return relay

    def _spatial_failed(self, job: _Job, err: SpatialJobError):
        """A spatial job whose rank failed: it is done, its block goes
        back to the pod, the service ledger's meta records the failure;
        the other tenants run on."""
        print(f"WARNING: job {job.spec.job_id!r} failed: {err}")
        job.error = str(err)
        job.done = True
        job.spatial = None
        self._release(job)
        self.telemetry.emit_meta(job_failed=str(job.spec.job_id))

    def _count_rejection(self):
        """One service-ledger tick per rejection: the record carries
        the ``admission_rejected`` probe and the (always-armed) alarm
        rule flags it. An ``abort`` divergence action is swallowed —
        the AdmissionError the caller gets IS the abort."""
        self._rejected += 1
        t = self._ticks
        self._ticks += 1
        probes = {"admission_rejected": 1.0,
                  "job_active": float(self.active_jobs())}
        self.telemetry.begin_round(t)
        self.telemetry.merge_round_probes(t, probes)
        self.telemetry.set_round_bytes(t, 0, 0)
        try:
            self.engine.check(t, probes)
        except DivergenceAbort:
            pass

    # ------------------------------------------------------------ plumbing

    def _job(self, job_id) -> _Job:
        try:
            return self._by_id[str(job_id)]
        except KeyError:
            with self._lock:
                have = sorted(self._by_id)
            raise KeyError(f"no admitted job {job_id!r}; have "
                           f"{have}") from None

    def attach_arrival_process(self, job_id, fn):
        """Per-job arrival relay: forwards ``fn`` to the job's async
        driver. (Named ``attach_arrival_process`` on purpose — this
        is a sanctioned arrival-confinement relay range.) A spatial
        job's ranks each get ``fn``, which must pickle."""
        job = self._job(job_id)
        if job.spatial is not None:
            job.spatial.attach_arrival_process(fn)
        else:
            job.model.attach_arrival_process(fn)

    def active_jobs(self) -> int:
        with self._lock:
            return sum(1 for job in self._jobs if not job.done)

    def job_state(self, job_id):
        """The job's current (or final) replicated server weights."""
        job = self._job(job_id)
        if job.final_state is not None:
            return job.final_state
        if job.error is not None:
            raise RuntimeError(f"job {job_id!r} failed: {job.error}")
        if job.spatial is not None:
            return job.spatial.state()
        return _host(job.model.ps_weights)

    def job_rounds(self, job_id) -> int:
        return self._job(job_id).rounds_done

    def slo_burning_jobs(self) -> list:
        """Job ids currently burning their SLO error budget (their
        own FedModel SLO engine reads burn >= 1), plus "service" when
        the daemon's own engine is. Admission consults this."""
        burning = []
        with self._lock:
            jobs = list(self._jobs)
        for job in jobs:
            if job.done:
                continue
            if job.spatial is not None:
                if job.spatial.slo_burning:
                    burning.append(str(job.spec.job_id))
                continue
            slo = getattr(job.model, "_slo", None)
            if slo is not None and slo.burning:
                burning.append(str(job.spec.job_id))
        if self._slo is not None and self._slo.burning:
            burning.append("service")
        return burning

    # ------------------------------------------------------------ scheduler

    def tick(self):
        """One scheduler quantum: pick jobs per the policy, step each
        chosen job one round, then write the fairness record to the
        service ledger and evaluate the alarm rules on it. Returns
        the fired alarms (``abort`` raises DivergenceAbort instead)."""
        with self._lock:
            runnable = [job for job in self._jobs if not job.done]
        if not runnable:
            return []
        if self.policy == "fair":
            chosen = list(runnable)
        else:  # backlog: greedy, deliberately starvable
            chosen = [max(runnable,
                          key=lambda j: (j.backlog(), -j.index))]
        for job in chosen:
            self._run_round(job)
        for job in runnable:
            if job in chosen:
                job.ran_ticks += 1
                job.starved_ticks = 0
            else:
                job.starved_ticks += 1
        t = self._ticks
        self._ticks += 1
        probes = self._fairness_probes(runnable, chosen)
        self.telemetry.begin_round(t)
        if self._slo is not None:
            # the service's SLO objectives read the fairness probes
            # (starvation ticks); the burn probes merge INTO the tick
            # record's probe dict so the slo_burn rule fires through
            # the single engine.check below — the daemon path never
            # needs check_slo
            probes.update(self._slo.observe(
                t, starved_ticks=probes.get("job_starved_rounds")))
            self.telemetry.set_round_slo(t, self._slo.stamp())
        self.telemetry.merge_round_probes(t, probes)
        self.telemetry.set_round_bytes(t, 0, 0)
        return self.engine.check(t, probes)

    def run(self, max_ticks=None):
        """Drive ticks until every job drains (or the budget runs
        out). Returns the number of ticks executed."""
        n = 0
        while self.active_jobs() and (max_ticks is None
                                      or n < max_ticks):
            self.tick()
            n += 1
        return n

    def _run_round(self, job: _Job):
        batch = job.spec.batch_fn(job.rounds_done)
        if batch is None:
            self._finish(job)
            return
        if self._causal is not None:
            # grant span: runnable-since -> now, stitched into the
            # tenant's round trace by deterministic id (parent is the
            # tenant's round root — minted by the tenant, never by
            # us). Emitted only for rounds that actually run.
            now = clock.tick()
            r = job.rounds_done
            self._causal.add_event(
                "sched_grant",
                job.wait_since if job.wait_since is not None else now,
                now, trace=trace_id(job.index, r),
                sid=span_id(job.index, r, SEQ_GRANT),
                parent=span_id(job.index, r, SEQ_ROOT))
        if job.spatial is not None:
            try:
                job.spatial.round(batch)
            except SpatialJobError as e:
                self._spatial_failed(job, e)
                return
        else:
            job.model(batch)
            job.opt.step()
        job.rounds_done += 1
        if job.autosaver is not None:
            if job.model.telemetry.causal is not None:
                # round r's record is still current: the checkpoint
                # lands in its flush bucket. Off-path untouched so a
                # service-driven ledger stays byte-identical to solo.
                with job.model.telemetry.span("checkpoint"):
                    job.autosaver(0)
            else:
                job.autosaver(0)
        job.wait_since = clock.tick()
        if job.rounds_done >= int(job.spec.rounds):
            self._finish(job)

    def _finish(self, job: _Job):
        if job.done:
            return
        if job.spatial is not None:
            try:
                job.final_state = job.spatial.close()
            except SpatialJobError as e:
                self._spatial_failed(job, e)
                return
            job.spatial = None
        else:
            job.final_state = _host(job.model.ps_weights)
            job.model.finalize()
        job.done = True
        self._release(job)

    def _fairness_probes(self, runnable, chosen) -> dict:
        still = [job for job in runnable if not job.done]
        probes = {
            "job_active": float(len(still)),
            "job_ran": float(len(chosen)),
            "job_backlog_total": float(sum(j.backlog()
                                           for j in runnable)),
            "job_backlog_max": float(max(j.backlog()
                                         for j in runnable)),
        }
        if still:
            starved = max(still, key=lambda j: j.starved_ticks)
            probes["job_starved_rounds"] = float(starved.starved_ticks)
            probes["job_starved_index"] = float(starved.index)
            occ = [j.ran_ticks / max(1, j.ran_ticks + j.starved_ticks)
                   for j in still]
            probes["job_occupancy_min"] = float(min(occ))
        return probes

    # ------------------------------------------------------------ elasticity

    def migrate(self, job_id, mesh_demand=None):
        """Elastic migration: checkpoint the job, rebuild it on a freshly
        carved block (``mesh_demand=(C, M)``: one card in the daemon,
        several in spatial worker processes) or time-sliced (``None``),
        and restore — the checkpoint format (runtime/checkpoint.py)
        restores onto any world, so the restore is bit-exact. The job's
        ledger shard survives: the old sinks close before the rebuilt
        model reopens them, and round ids continue where they left
        off."""
        job = self._job(job_id)
        if job.done:
            raise ValueError(f"job {job_id!r} already finished")
        ckpt_dir = self._ckpt_dir or tempfile.mkdtemp(
            prefix="fedservice_migrate_")
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, f"migrate_job{job.index}.npz")
        if job.spatial is not None:
            job.spatial.save(path)
            job.spatial.close()
            job.spatial = None
        else:
            save_checkpoint(path, job.model, job.opt)
            job.model.finalize()
        self._release(job)
        if mesh_demand is not None:
            c, m = mesh_demand
            need = int(c) * int(m)
            if need > len(self._free):
                raise AdmissionError(
                    f"job {job_id}: migration demand {c}x{m} needs "
                    f"{need} devices, {len(self._free)} free")
            job.devices = self._carve(mesh_demand)
        job.spec = dataclasses.replace(job.spec, mesh_demand=mesh_demand)
        self._bring_up(job, restore=path)
        return job.index

    # ------------------------------------------------------------ teardown

    def close(self):
        """Drain-free shutdown: finalize still-live jobs, stamp the
        service meta record, close the service ledger."""
        with self._lock:
            jobs = list(self._jobs)
        for job in jobs:
            if not job.done:
                self._finish(job)
        self.telemetry.emit_meta(
            service_jobs=self._admitted,
            service_policy=self.policy,
            service_ticks=self._ticks,
            service_rejected=self._rejected,
            pod_devices=len(self._devices))
        self.telemetry.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _host(weights) -> np.ndarray:
    """A host copy of a job's server weights."""
    return weights.detach().to("cpu").numpy().copy()


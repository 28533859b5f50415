"""Flight recorder: bounded round ring + atomic postmortem bundles.

Port of ``commefficient_tpu/telemetry/flightrec.py``, attached with
the live exporter by ``live.attach_live_plane``. The bundle's
``config``/``config_hash``/``environment`` are the run registry's
(``telemetry/registry.py``), and a run that writes a ledger stamps each
bundle into the registry (``runs_dir``). A bundle dumped for a
latency-shaped rule on a ``--causal_trace`` run carries the firing
round's critical path diffed against the ring's median round
(``critpath_diff``, reference :120-153).

A crashed or alarming run's most valuable evidence is the last few
rounds of full-fidelity telemetry — exactly the records the ledger
may not have flushed (or the operator may not have enabled). The
recorder is an ordinary telemetry sink keeping an in-memory ring of
the last N round records (plus the run's meta record and a short
queue of recent compile/alarm events); on any alarm fire,
``GracefulShutdown``, or unhandled crash it dumps a **postmortem
bundle** — one self-describing JSON file under
``--postmortem_dir`` (default ``runs/postmortems/``) written with
a tmp + fsync + rename, so a bundle either exists completely or not
at all (a SIGKILL mid-dump leaves only the inert ``.tmp``).
``load_postmortem`` reads and validates one.

Dump policy: one bundle per distinct firing rule per run (a rule
that keeps firing re-describes the same incident), plus one each for
``graceful_shutdown`` and ``crash``. Dumps are observability — every
failure degrades to a warning, never to failing the run it observes.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from collections import deque

from commefficient_tpu_torch.telemetry import clock, registry
from commefficient_tpu_torch.telemetry.record import validate_record
from commefficient_tpu_torch.telemetry.sinks import _json_default

POSTMORTEM_SCHEMA = 1
POSTMORTEM_PREFIX = "postmortem_"

#: lock-confinement declarations (flowlint ``lock-confinement``).
#: The recorder is written by the round loop but dumped from OTHER
#: threads — the crash excepthook fires on whichever thread raised,
#: and a daemon's alarm path can dump while another job's sink is
#: mid-``write``. Iterating ``_ring``/``_events`` (deques) while a
#: writer appends past maxlen raises ``RuntimeError: deque mutated
#: during iteration``, so every touch goes through ``_lock``.
_LOCK_MAP = {
    "_ring": "_lock",
    "_events": "_lock",
    "_meta": "_lock",
    "_dumped": "_lock",
    "last_bundle": "_lock",
}

#: recent compile/alarm events retained alongside the round ring
EVENT_QUEUE = 64

#: bundle keys every reader may rely on
BUNDLE_REQUIRED_KEYS = (
    "schema", "kind", "ts", "reason", "rule", "labels", "config",
    "config_hash", "ring_rounds", "rounds", "events", "meta",
    "environment",
)


class FlightRecorder:
    """Sink-shaped ring of the last ``ring_rounds`` emitted records.

    ``labels`` (process/run) stamp the bundle; ``runs_dir`` (optional)
    arms the registry lineage stamp. ``out_dir`` overrides
    ``cfg.postmortem_dir`` (tests)."""

    def __init__(self, cfg, ring_rounds: int, labels=None,
                 runs_dir: str = "", out_dir: str = ""):
        if int(ring_rounds) <= 0:
            raise ValueError(f"ring_rounds must be > 0, not {ring_rounds}")
        self._cfg = cfg
        self.ring_rounds = int(ring_rounds)
        self._lock = threading.Lock()
        self._ring = deque(maxlen=self.ring_rounds)
        self._events = deque(maxlen=EVENT_QUEUE)
        self._meta = None
        self.labels = {k: str(v) for k, v in (labels or {}).items()}
        self.runs_dir = runs_dir
        self.out_dir = (out_dir
                        or str(getattr(cfg, "postmortem_dir", "")
                               or "runs/postmortems"))
        self._config = registry.config_dict(cfg)
        self._config_hash = registry.config_hash(cfg)
        self._dumped = set()
        #: path of the most recent bundle (None before any dump)
        self.last_bundle = None

    # ------------------------------------------------------------- sink

    def write(self, rec):
        kind = rec.get("kind")
        if kind == "meta":
            with self._lock:
                self._meta = dict(rec)
            return
        if kind != "round":
            return
        counters = rec.get("counters") or {}
        alarms = rec.get("alarms") or []
        with self._lock:
            self._ring.append(rec)
            if counters.get("compile_events"):
                self._events.append({
                    "kind": "compile", "round": rec.get("round"),
                    "events": counters["compile_events"],
                    "secs": counters.get("compile_secs")})
            for alarm in alarms:
                self._events.append(dict(alarm, kind="alarm"))
        if alarms:
            # the firing record is already IN the ring (appended
            # above), so the bundle always contains its own trigger;
            # dump() takes the lock itself, so call it outside ours
            context = {"alarms": alarms, "round": rec.get("round")}
            diff = self._critpath_diff(rec,
                                       {str(a.get("rule"))
                                        for a in alarms})
            if diff is not None:
                context["critpath_diff"] = diff
            self.dump("alarm", rule=str(alarms[0].get("rule")),
                      context=context)

    #: latency-shaped rules whose postmortems benefit from a causal
    #: "why": the bundle gets the firing round's critical path diffed
    #: against the ring's rolling-median round
    CRITPATH_RULES = ("step_time_regression", "slo_burn")

    def _critpath_diff(self, rec, rules):
        """Critical-path diff of the firing round vs the per-bucket
        median of the prior ring (--causal_trace runs only; any
        failure degrades to None — this is bundle garnish, never a
        reason to lose the bundle)."""
        if not rules.intersection(self.CRITPATH_RULES) \
                or not isinstance(rec.get("causal"), dict):
            return None
        try:
            from commefficient_tpu_torch.telemetry.critpath import (
                critical_path, critpath_diff, median_buckets)
            with self._lock:
                prior = [r for r in self._ring if r is not rec
                         and isinstance(r.get("causal"), dict)]
            cur = critical_path(rec["causal"], rec.get("device_time"))
            base = median_buckets(
                [critical_path(r["causal"], r.get("device_time"))
                 for r in prior])
            if base is None:
                return None
            return critpath_diff(cur, base)
        except Exception:  # noqa: BLE001 — observability only
            return None

    def close(self):
        pass  # the ring is only evidence; nothing to flush

    # ------------------------------------------------------------- dump

    def dump(self, reason: str, rule=None, context=None):
        """Write one atomic postmortem bundle; returns its path (or
        the prior path when this (reason, rule) already dumped, or
        None when the write failed — warned, never raised)."""
        key = (str(reason), None if rule is None else str(rule))
        with self._lock:
            if key in self._dumped:
                return self.last_bundle
            # claim the key BEFORE the file I/O so a concurrent dump
            # of the same incident (crash hook racing the alarm path)
            # can't write twice; rolled back below if the write fails.
            # Snapshot the ring under the same lock — a writer
            # appending past maxlen while we iterate would raise
            # "deque mutated during iteration" and lose the bundle.
            self._dumped.add(key)
            rounds = list(self._ring)
            events = list(self._events)
            meta = self._meta
        bundle = {
            "schema": POSTMORTEM_SCHEMA,
            "kind": "postmortem",
            "ts": clock.wall(),
            "reason": str(reason),
            "rule": None if rule is None else str(rule),
            "context": context or {},
            "labels": dict(self.labels),
            "config": self._config,
            "config_hash": self._config_hash,
            "ring_rounds": self.ring_rounds,
            "rounds": rounds,
            "events": events,
            "meta": meta,
        }
        try:
            bundle["environment"] = registry._environment()
            os.makedirs(self.out_dir, exist_ok=True)
            tag = f"{reason}" + (f"_{rule}" if rule else "")
            name = f"{POSTMORTEM_PREFIX}{int(bundle['ts'])}_{tag}"
            path = os.path.join(self.out_dir, name + ".json")
            n = 1
            while os.path.exists(path):
                path = os.path.join(self.out_dir,
                                    f"{name}.{n}.json")
                n += 1
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(bundle, f, indent=1, sort_keys=True,
                          default=_json_default)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except Exception as e:  # noqa: BLE001 — observability only
            print(f"WARNING: postmortem bundle not written "
                  f"({type(e).__name__}: {e})", file=sys.stderr)
            with self._lock:
                self._dumped.discard(key)
            return None
        with self._lock:
            self.last_bundle = path
        if self.runs_dir:
            try:
                manifest = registry.write_manifest(
                    self.runs_dir, args=self._cfg,
                    ledger=str(getattr(self._cfg, "ledger", "")
                               or ""),
                    extra={"postmortem": os.path.abspath(path),
                           "postmortem_reason": str(reason),
                           "postmortem_rule": bundle["rule"],
                           "job_id": self.labels.get("job")})
                # back-pointer: the bundle's registry lineage entry
                bundle["manifest"] = os.path.abspath(manifest)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(bundle, f, indent=1, sort_keys=True,
                              default=_json_default)
                    f.write("\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except Exception as e:  # noqa: BLE001
                print(f"WARNING: postmortem registry stamp failed "
                      f"({type(e).__name__}: {e})", file=sys.stderr)
        return path


def install_crash_hook(recorder: FlightRecorder):
    """Chain ``sys.excepthook`` so an unhandled crash dumps a bundle
    before the traceback prints. Returns the installed hook (tests
    restore the prior one themselves)."""
    prev = sys.excepthook

    def _hook(tp, val, tb):
        try:
            recorder.dump(
                "crash",
                context={"exception": f"{tp.__name__}: {val}"})
        except Exception:  # noqa: BLE001 — never mask the crash
            pass
        prev(tp, val, tb)

    sys.excepthook = _hook
    return _hook


def load_postmortem(path: str):
    """Read + validate a bundle: ``(bundle, problems)``. Problems are
    strings (missing keys, invalid ring records); an unreadable file
    raises like any other open/parse error — the caller asked for
    THIS file."""
    with open(path) as f:
        bundle = json.load(f)
    problems = []
    if bundle.get("kind") != "postmortem":
        problems.append(f"kind {bundle.get('kind')!r} is not "
                        "'postmortem'")
    if bundle.get("schema") != POSTMORTEM_SCHEMA:
        problems.append(f"schema {bundle.get('schema')!r} != "
                        f"{POSTMORTEM_SCHEMA}")
    for key in BUNDLE_REQUIRED_KEYS:
        if key not in bundle:
            problems.append(f"bundle missing {key!r}")
    rounds = bundle.get("rounds")
    if not isinstance(rounds, list):
        problems.append("rounds is not a list")
    else:
        if len(rounds) > int(bundle.get("ring_rounds") or 0):
            problems.append("rounds overflow the declared ring size")
        for rec in rounds:
            for p in validate_record(rec):
                problems.append(f"round {rec.get('round')}: {p}")
    return bundle, problems

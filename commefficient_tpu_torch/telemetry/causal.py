"""Causal round tracing: distributed spans with deterministic ids.

Port of ``commefficient_tpu/telemetry/causal.py`` (``BUCKETS``/
``BUCKET_OF``, ``trace_id`` :88, ``span_id`` :96, the ``SEQ_*`` slots,
``CausalTracer`` :104-220, ``build_causal_tracer`` :222,
``assemble_traces`` :231): the ids are the same pure functions of
``(job, round, seq)``, so both packages mint the same strings.

The observability stack measures *how much* (per-phase seconds,
device buckets, SLO burn) but not *why a given round took as long as
it did*. This module adds the causal link: a span model threaded
through the round lifecycle — JobSpec admission → scheduler grant →
cohort issue → arrival dequeue → prefetch/gather → h2d → round
dispatch → server fold → checkpoint/ledger flush — whose per-round
DAG ``telemetry/critpath.py`` folds into a critical-path explanation
("this round was slow because arrival_wait grew 6×").

Design rules:

* **Deterministic ids.** A trace id is a pure function of
  ``(job, round)`` and a span id of ``(job, round, seq)`` — no
  wall-clock or RNG component. Two parties that never talk (the
  job service granting a slot, the tenant running the round) mint
  the SAME ids for the same causal event, so ``assemble_traces``
  stitches their spans by id with no coordination protocol. Well-known ``SEQ_*`` slots anchor
  the lifecycle events both sides must agree on.
* **Spans ride the record stream.** The closing round record carries
  the trace as its schema-v7 ``causal`` stamp; ``.job<j>`` shards
  carry their own spans and ``assemble_traces`` reassembles the DAG.
* **Host-side only, off by default.** A tracer is constructed ONLY
  under ``--causal_trace``; with the flag unset nothing here runs on
  the round path. The spans are host clock reads around host calls:
  no tensor is read, written or synchronised for them, so the round's
  numbers are the same bit for bit with the flag on or off
  (tests/test_torch_causal.py).

Span times are monotonic ``clock.tick()`` seconds — only the *ids*
are deterministic; cross-process spans therefore stitch structurally
(by id) rather than on a shared clock, and the critical-path
invariant (buckets sum == wall) is stated per trace, on one clock.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

from commefficient_tpu_torch.telemetry import clock

#: critical-path attribution buckets (telemetry/critpath.py). Every
#: second of a round's wall time lands in exactly one of these;
#: ``host_other`` is the honest residual — wall time between
#: instrumented spans (record bookkeeping, accounting glue) that no
#: named phase claims.
BUCKETS = ("sched_wait", "arrival_wait", "host_gather", "h2d",
           "compute", "collective_exposed", "writeback", "flush",
           "host_other")

#: span name -> bucket. Unknown names fall to ``host_other`` so a
#: new span can never silently inflate a named bucket.
BUCKET_OF = {
    "admission": "sched_wait",
    "sched_grant": "sched_wait",
    "sched_wait": "sched_wait",
    "async_fold": "arrival_wait",
    "cohort_issue": "arrival_wait",
    "arrival_dequeue": "arrival_wait",
    "sampler": "host_gather",
    "gather": "host_gather",
    "prefetch": "host_gather",
    "h2d": "h2d",
    "h2d_state": "h2d",
    "round_dispatch": "compute",
    "metrics_host": "compute",
    "server": "compute",
    "autopilot_warm": "compute",
    "collective": "collective_exposed",
    "writeback": "writeback",
    "flush": "flush",
    "checkpoint": "flush",
    "ledger_flush": "flush",
}

#: well-known seq slots: ids both sides of a process boundary must
#: agree on without talking. Dynamically numbered spans start at
#: ``SEQ_DYNAMIC`` so they can never collide with an anchor.
SEQ_ROOT = 0       # the round's root span (tenant round loop)
SEQ_ADMIT = 1      # JobSpec admission (fedservice daemon)
SEQ_GRANT = 2      # scheduler grant (fedservice daemon)
SEQ_DYNAMIC = 8


def trace_id(job, round_index: int) -> str:
    """Deterministic trace id for round ``round_index`` of ``job``
    (an int job index, a string like ``"service"``, or None for a
    solo run)."""
    j = "solo" if job is None else str(job)
    return f"j{j}.r{int(round_index)}"


def span_id(job, round_index: int, seq: int) -> str:
    return f"{trace_id(job, round_index)}.s{int(seq)}"


def bucket_of(name: str) -> str:
    return BUCKET_OF.get(str(name), "host_other")


class CausalTracer:
    """Per-run span recorder. One tracer serves one record stream
    (solo FedModel, fedservice tenant, or the daemon itself); the
    round lifecycle mirrors ``telemetry.core``: ``begin_round`` opens
    the root span, ``span()``/``open``/``close_span`` nest child
    spans under it, ``end_round`` closes the root and returns the
    schema-v7 ``causal`` stamp.

    Spans recorded from threads other than the round-loop owner
    (prefetch workers) attach flat under the root — the owner's open
    stack is single-threaded state and is never touched cross-thread.
    """

    def __init__(self, job=None):
        self.job = job
        self._round = None
        self._root_b = None
        self._seq = SEQ_DYNAMIC
        self._spans = []
        self._stack = []            # open frames: [id, name, b]
        self._owner = None          # round-loop thread ident
        self._foreign = []          # spans for OTHER traces (grants)

    # ------------------------------------------------------ lifecycle

    def begin_round(self, index: int):
        """Open round ``index``'s root span; an unclosed previous
        round is discarded (interrupted round — its record never
        emits either)."""
        self._round = int(index)
        self._root_b = clock.tick()
        self._seq = SEQ_DYNAMIC
        self._spans = []
        self._stack = []
        self._owner = threading.get_ident()

    def end_round(self):
        """Close the root span; returns the round's ``causal`` stamp
        (None when no round is open)."""
        if self._round is None:
            return None
        r, job = self._round, self.job
        e = clock.tick()
        root = {
            "id": span_id(job, r, SEQ_ROOT),
            "parent": None,
            "name": "round",
            "bucket": "host_other",
            "b": self._root_b,
            "e": e,
        }
        spans = [root] + self._spans
        foreign, self._foreign = self._foreign, []
        spans += foreign
        payload = {
            "trace": trace_id(job, r),
            "job": None if job is None else job,
            "round": r,
            "wall": e - self._root_b,
            "spans": spans,
        }
        self._round = None
        self._spans = []
        self._stack = []
        return payload

    # ------------------------------------------------------ recording

    def open(self, name: str):
        """Push an open span frame (paired with ``close_span``).
        No-op outside a round or from a non-owner thread."""
        if self._round is None \
                or threading.get_ident() != self._owner:
            return
        sid = span_id(self.job, self._round, self._seq)
        self._seq += 1
        self._stack.append([sid, str(name), clock.tick()])

    def close_span(self):
        """Pop the innermost open frame into a finished span whose
        parent is the enclosing frame (the root when none)."""
        if self._round is None \
                or threading.get_ident() != self._owner \
                or not self._stack:
            return
        sid, name, b = self._stack.pop()
        parent = (self._stack[-1][0] if self._stack
                  else span_id(self.job, self._round, SEQ_ROOT))
        self._spans.append({
            "id": sid, "parent": parent, "name": name,
            "bucket": bucket_of(name), "b": b, "e": clock.tick(),
        })

    @contextmanager
    def span(self, name: str):
        """Context-manager form of ``open``/``close_span`` for
        callers without a Telemetry (the asyncfed driver)."""
        self.open(name)
        try:
            yield
        finally:
            self.close_span()

    def add_event(self, name: str, b: float, e: float, *,
                  trace: str, sid: str, parent=None):
        """Record a span for ANOTHER trace — the fedservice daemon
        stamping a ``sched_grant`` into a tenant's round trace. The
        span buffers until this tracer's next ``end_round`` and rides
        that record with an explicit ``trace`` override; ids are
        deterministic, so the tenant-side parent needs no handshake.
        """
        self._foreign.append({
            "id": str(sid), "parent": parent, "name": str(name),
            "bucket": bucket_of(name), "b": float(b), "e": float(e),
            "trace": str(trace),
        })


def build_causal_tracer(cfg, job=None):
    """The run's tracer per its Config: None unless ``--causal_trace``
    is set — the disabled path constructs nothing and the round loop
    stays untouched."""
    if not getattr(cfg, "causal_trace", False):
        return None
    return CausalTracer(job=job)


def assemble_traces(records) -> dict:
    """Stitch the causal spans riding a record stream back into
    per-trace DAGs — the reassembly run after joining a job service's
    ledger with its ``.job<j>`` shards.

    Returns ``{trace_id: {"spans": {id: span}, "round": r,
    "orphans": [ids whose parent resolves to no span in the trace]}}``.
    A span whose ``parent`` is None is a root, never an orphan; the
    deterministic id scheme means a daemon's grant span and the
    tenant's round root land in the same trace without any shared
    state."""
    traces = {}
    for rec in records:
        causal = rec.get("causal") if isinstance(rec, dict) else None
        if not isinstance(causal, dict):
            continue
        default = causal.get("trace")
        for span in causal.get("spans") or ():
            tid = span.get("trace", default)
            t = traces.setdefault(tid, {"spans": {}, "round": None,
                                        "orphans": []})
            t["spans"][span["id"]] = span
            if causal.get("trace") == tid:
                t["round"] = causal.get("round")
    for t in traces.values():
        t["orphans"] = sorted(
            sid for sid, span in t["spans"].items()
            if span.get("parent") is not None
            and span["parent"] not in t["spans"])
    return traces

"""Round-ledger telemetry: spans, counters and the record lifecycle.

Port of ``commefficient_tpu/telemetry/core.py``. One ``Telemetry``
observes one run. The hot-path contract is the reference's:

- **disabled** (no sinks): ``begin_round`` is one truthiness check,
  ``span()`` returns one shared no-op context manager and ``count()``
  returns at once: no allocation a round, nothing kept.
- **enabled**: ``begin_round`` opens a round record; ``span(name)``
  adds wall time to it; ``count(name)`` bumps a counter. Records reach
  every sink in round order once they are (a) no longer the current
  round and (b) carry their uplink/downlink bytes
  (``set_round_bytes``, deferred under ``--pipeline_depth`` until the
  trainer drains). ``close()`` flushes what remains.

Round lifecycle (runtime/fed_model.py):

    begin_round(r)        # top of FedModel._call_train
      span("h2d") ...     # client pass spans
      set_round_bytes(r)  # sync path: end of _call_train;
                          # pipelined: FedModel.flush replay
      span("server") ...  # FedOptimizer.step (record still current)
    begin_round(r+1)      # closes r -> watermarks -> emit

Compile events: the reference counts XLA compiles through
``jax.monitoring``, which has no torch twin. The port's compiles are
its kernel builds, so a record's ``compile_events``/``compile_secs``
counters are the kernel libraries loaded (nvcc build or cached
library, ``_build.load``) while it was current, and their seconds.
``hbm_peak_bytes`` is the card's ``torch.cuda.max_memory_allocated``
since the process started (the reference's ``peak_bytes_in_use``); it
never resets the peak, which would cut a caller's own measurement
window short. The two peaks are read with the cheapest calls that give
their numbers: an enabled ledger costs ~0.12-0.15 ms a round on the
H100's machine (PERF.md §6). With a causal tracer attached
(``--causal_trace``, ``set_causal_tracer``) every span is also a frame
of the round's DAG, and closing a round stamps the DAG on its record as
the optional v7 ``causal`` key (reference core.py:56-75, 195-198,
220-237); ``set_round_slo`` attaches the SLO engine's v6 ``slo`` stamp.
"""

from __future__ import annotations

from collections import OrderedDict

from commefficient_tpu_torch import _build
from commefficient_tpu_torch.telemetry import clock
from commefficient_tpu_torch.telemetry.record import (make_epoch_record,
                                                      make_meta_record,
                                                      make_round_record,
                                                      make_summary_record)


class _NullSpan:
    """Shared, allocation-free no-op context manager."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_spans", "_name", "_t0", "_causal")

    def __init__(self, spans, name, causal=None):
        self._spans = spans
        self._name = name
        self._causal = causal

    def __enter__(self):
        self._t0 = clock.tick()
        if self._causal is not None:
            # open AFTER t0 so the causal frame nests inside the
            # accumulated span second-for-second; nesting (driver
            # spans inside async_fold) comes from the tracer's stack
            self._causal.open(self._name)
        return self

    def __exit__(self, *exc):
        if self._causal is not None:
            self._causal.close_span()
        dt = clock.tick() - self._t0
        self._spans[self._name] = self._spans.get(self._name, 0.0) + dt
        return False


def compile_mark():
    """Snapshot of the process-wide kernel-build accumulator; pair with
    ``compile_delta`` to attribute the builds between two points to a
    cause (FedModel stamps a round variant's first dispatch as
    ``vcompile_*:<key>`` counters)."""
    return (_build.COMPILES["events"], _build.COMPILES["secs"])


def compile_delta(mark):
    """(events, secs) accumulated since ``mark``."""
    ev0, s0 = mark
    return (_build.COMPILES["events"] - ev0, _build.COMPILES["secs"] - s0)


def host_rss_peak_bytes():
    """Peak resident set size of this process (bytes), or None: Linux's
    ``ru_maxrss`` (KiB), the number the reference reads as ``VmHWM``
    from ``/proc/self/status``, whose read cost 0.12 ms a call on the
    H100's machine against 3 us (PERF.md §6)."""
    try:
        import resource
        return int(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss) * 1024
    except (ImportError, OSError):
        return None


def hbm_peak_bytes(device=None):
    """Peak bytes the caching allocator held on ``device`` (a CUDA
    ``torch.device``) since the process started, or None for a CPU run
    or a card that reports nothing: ``max_memory_allocated``'s number,
    read from the nested stats (``max_memory_allocated`` flattens them
    in Python, 79 against 13 us a call on the H100's machine)."""
    if device is None or getattr(device, "type", None) != "cuda":
        return None
    import torch
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    peak = stats.get("allocated_bytes", {}).get("all", {}).get("peak", 0)
    return int(peak) or None


class Telemetry:
    """Span/counter recorder and sink fan-out for one run. ``device``
    is the run's device, whose memory peak the round records carry."""

    def __init__(self, sinks=None, device=None):
        self._sinks = list(sinks or ())
        self.device = device
        self._records = OrderedDict()   # round index -> record
        self._closed_rounds = set()     # indices no longer current
        self._alarm_counts = {}         # rule -> fires this run
        self._current = None            # the open round record
        self._compile_mark = (0, 0.0)
        self._shut = False
        # a profiler trace window holds closed records until its trace
        # is parsed, so the device-time buckets merge before the
        # records reach the sinks; round order is unchanged
        self._hold = False
        # optional callback(round_index, buckets) run when trace
        # buckets merge: FedModel points it at the alarm engine's
        # collective-skew check
        self.on_device_time = None
        # the round's roofline bound (analysis/cost.py), set by the
        # cost model; the trace's buckets derive roofline_utilization
        # from it
        self.expected_round_s = None
        # optional CausalTracer (--causal_trace): every _Span also
        # opens/closes a causal frame, and closing a round stamps its
        # span DAG onto the record as the optional v7 ``causal`` key.
        # None (the default) leaves the hot path as it was
        self.causal = None

    # --- configuration --------------------------------------------------

    @property
    def enabled(self) -> bool:
        return bool(self._sinks)

    def add_sink(self, sink):
        """Attach a sink mid-run (the trainers attach the TensorBoard
        sink once the run's log directory exists)."""
        self._sinks.append(sink)

    def set_causal_tracer(self, tracer):
        """Attach a CausalTracer (or None to detach). Only meaningful
        on an enabled Telemetry: causal stamps ride round records."""
        self.causal = tracer if self._sinks else None

    def emit(self, rec):
        for sink in self._sinks:
            sink.write(rec)

    def emit_meta(self, **fields):
        if self._sinks:
            self.emit(make_meta_record(**fields))

    # --- round lifecycle ------------------------------------------------

    def begin_round(self, index: int):
        """Open round ``index``; closes (and may emit) the previous
        round. A no-op when disabled."""
        if not self._sinks:
            return None
        self._close_current()
        rec = make_round_record(index)
        self._records[index] = rec
        self._current = rec
        self._compile_mark = compile_mark()
        if self.causal is not None:
            self.causal.begin_round(index)
        return rec

    def _close_current(self):
        rec, self._current = self._current, None
        if rec is None:
            return
        rec["host_rss_peak_bytes"] = host_rss_peak_bytes()
        rec["hbm_peak_bytes"] = hbm_peak_bytes(self.device)
        ev0, s0 = self._compile_mark
        ev1, s1 = compile_mark()
        rec["counters"]["compile_events"] = ev1 - ev0
        rec["counters"]["compile_secs"] = round(s1 - s0, 6)
        if self.causal is not None:
            stamp = self.causal.end_round()
            if stamp is not None:
                rec["causal"] = stamp
        self._closed_rounds.add(rec["round"])
        self._drain()

    def span(self, name: str):
        """Context manager adding wall time to the current round
        record; the shared no-op outside a round or when disabled."""
        if self._current is None:
            return NULL_SPAN
        return _Span(self._current["spans"], name, self.causal)

    def count(self, name: str, n: int = 1):
        if self._current is not None:
            c = self._current["counters"]
            c[name] = c.get(name, 0) + n

    def set_round_bytes(self, index: int, downlink, uplink):
        """Attach the round's FedModel accounting totals: at the end of
        the client pass (synchronous) or at the flush replay
        (``--pipeline_depth`` > 1)."""
        rec = self._records.get(index)
        if rec is None:
            return
        rec["downlink_bytes"] = float(downlink)
        rec["uplink_bytes"] = float(uplink)
        self._drain()

    def set_round_privacy(self, index: int, epsilon, delta, sigma):
        """Stamp the round's DP trail (schema v5): the cumulative
        ε(δ) after the round was charged, its δ, and the noise
        multiplier charged."""
        rec = self._records.get(index)
        if rec is None:
            return
        rec["dp_epsilon"] = float(epsilon)
        rec["dp_delta"] = float(delta)
        rec["dp_sigma"] = float(sigma)

    def set_round_slo(self, index: int, stamp: dict):
        """Attach the SLO engine's per-objective snapshot (schema v6
        ``slo`` key) to round ``index``'s record. Arrives from the
        round-finish hook (runtime/fed_model.py or the job service's
        tick), always before emission."""
        rec = self._records.get(index)
        if rec is None or not stamp:
            return
        rec["slo"] = dict(stamp)

    def merge_round_probes(self, index: int, probes: dict):
        """Merge algorithm-probe values onto round ``index``'s record
        (schema v2), always before it can emit: emission waits on
        ``set_round_bytes``, which arrives last."""
        rec = self._records.get(index)
        if rec is None or not probes:
            return
        if rec.get("probes") is None:
            rec["probes"] = {}
        rec["probes"].update(probes)

    def hold_emission(self, on: bool):
        """Buffer emission while a profiler trace window is open;
        releasing the hold drains what became eligible meanwhile."""
        self._hold = bool(on)
        if not self._hold:
            self._drain()

    def merge_round_device_time(self, index: int, buckets: dict):
        """Attach trace-derived device-time buckets (schema v3) to round
        ``index``'s record: called by the trace window at its exit,
        while ``hold_emission`` keeps the records buffered. Derives
        ``roofline_utilization`` where a cost model registered
        ``expected_round_s``."""
        rec = self._records.get(index)
        if rec is None or not buckets:
            return
        buckets = dict(buckets)
        exp = self.expected_round_s
        busy = buckets.get("busy_s")
        if exp and busy:
            # 6 dp, as the reference: CPU-scale utilizations sit at
            # 1e-6..1e-3 and must not round to zero
            buckets["roofline_utilization"] = round(exp / busy, 6)
        rec["device_time"] = buckets
        cb = self.on_device_time
        if cb is not None:
            cb(index, rec["device_time"])

    def flag_alarm(self, index: int, alarm: dict):
        """Append an alarm dict to round ``index``'s record and bump
        the run's fire count of its rule."""
        rule = str(alarm.get("rule"))
        self._alarm_counts[rule] = self._alarm_counts.get(rule, 0) + 1
        rec = self._records.get(index)
        if rec is None:
            return
        rec.setdefault("alarms", []).append(alarm)

    def _drain(self, force: bool = False):
        """Emit the front records that are closed and carry their
        bytes (every closed one when forced): ledger order is round
        order."""
        if self._hold and not force:
            return
        while self._records:
            idx, rec = next(iter(self._records.items()))
            if idx not in self._closed_rounds:
                break
            if rec["uplink_bytes"] is None and not force:
                break
            self._records.pop(idx)
            self._closed_rounds.discard(idx)
            self.emit(rec)

    # --- non-round records ----------------------------------------------

    def epoch(self, row: dict, epoch: int):
        """Emit the trainer's per-epoch row."""
        if self._sinks:
            self.emit(make_epoch_record(row, epoch))

    # --- shutdown -------------------------------------------------------

    def close(self):
        """Flush every pending record and close the sinks; idempotent.
        A run in which an alarm fired also emits one summary record of
        the per-rule ``alarm_fired`` totals."""
        if self._shut:
            return
        self._shut = True
        self._close_current()
        self._drain(force=True)
        if self._alarm_counts and self._sinks:
            self.emit(make_summary_record(
                alarm_fired=dict(sorted(self._alarm_counts.items()))))
        for sink in self._sinks:
            sink.close()
        self._sinks = []


#: a disabled instance: everything on it is a no-op
NULL_TELEMETRY = Telemetry()


def build_telemetry(args, device=None, extra_sinks=(), process_index=None,
                    process_count=None) -> Telemetry:
    """A run's Telemetry from its Config (reference telemetry/core.py
    :399-458). ``--ledger PATH`` attaches a JSONL sink on every rank of
    a mesh run: rank 0 writes the canonical ledger at ``PATH`` (its
    round records carry the accounting every rank holds alike); rank
    k > 0 writes the ``PATH.p<k>.jsonl`` shard, its own host spans, RSS
    watermark and device time, announced once a run. ``python -m
    commefficient_tpu_torch.telemetry.merge PATH`` joins the shards on
    round id. On a mesh of more than one rank every record is stamped
    with its rank (``process``). The reference's process is a JAX host;
    the port's is one card's rank (parallel/mesh.py), so a one-host run
    of four cards writes three shards. ``--telemetry_console`` attaches
    the end-of-run console summary, on rank 0 only. The TensorBoard
    sink is attached by the trainer, which owns the run log directory.

    ``process_index``/``process_count`` default to the launched group's
    rank and size (0 and 1 outside one); tests pass them to write the
    shard layout without a group.

    A ``--resume`` run appends to the same ledger (and each rank to its
    own shard): the sink truncates a torn tail and drops replayed round
    records at or below the file's last round id, so round ids stay
    monotone."""
    from commefficient_tpu_torch.telemetry.sinks import (ConsoleSink,
                                                         JSONLSink,
                                                         last_round_index,
                                                         shard_ledger_path)
    sinks = list(extra_sinks)
    path = getattr(args, "ledger", "") or ""
    console = bool(getattr(args, "telemetry_console", False))
    if process_index is None or process_count is None:
        import torch.distributed as dist
        on = dist.is_available() and dist.is_initialized()
        process_index = dist.get_rank() if on else 0
        process_count = dist.get_world_size() if on else 1
    pidx, pcount = int(process_index), int(process_count)
    if path:
        spath = shard_ledger_path(path, pidx)
        resume_after = (last_round_index(spath)
                        if getattr(args, "do_resume", False) else None)
        sinks.append(JSONLSink(spath, process=pidx if pcount > 1 else None,
                               resume_after=resume_after))
        if pidx != 0:
            print(f"telemetry: process {pidx}/{pcount} writing ledger "
                  f"shard {spath} (process 0 owns the canonical ledger; "
                  "merge with python -m "
                  "commefficient_tpu_torch.telemetry.merge)")
    if console and pidx == 0:
        sinks.append(ConsoleSink())
    return Telemetry(sinks, device=device)

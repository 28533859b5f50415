"""Device-time attribution: profiler round markers and trace parsing.

Port of ``commefficient_tpu/telemetry/trace.py`` on ``torch.profiler``.
The round ledger (core.py) measures host phases; this module closes
the gap to the card's timeline. Two halves:

**Markers** -- while a ``trace_window`` (profiler.py) is open,
``FedModel`` brackets each round in a ``torch.profiler.record_function``
range named ``fed_round::<round index>`` and the device-relevant phases
(h2d, round_dispatch, metrics_host, server) in ``fed_phase::<name>``
ranges. The round range opens at ``begin_round`` and closes at the
NEXT round's begin, as the ledger record does, so the server step
(dispatched after ``_call_train`` returns) lands inside its own round's
window. The state is module-level (one live FedModel a process, as
``fed_model._CURRENT_MODEL``); with no trace open every call is one
flag check.

**Parser** -- ``export_chrome_trace`` writes Kineto's Chrome
trace-event JSON: ``ph: "X"`` complete events with microsecond ``ts``
and ``dur``. The host's ranges (``cat: "user_annotation"``) sit on CPU
lanes, so a round's window is its marker's extent in host time; the
card's work sits on the device's lanes (``cat`` ``kernel``,
``gpu_memcpy`` and ``gpu_memset``, ``pid`` the device, ``tid`` the
stream), on the same clock (Kineto aligns the two). The
``gpu_user_annotation`` copies of the host ranges on the device lanes
are markers, not work, and are skipped. ``attribute_rounds`` buckets
every device event into its round's window: {compute, collective,
transfer (memcpy), host_gap}, by interval union, so nested and
overlapping events never count twice; memsets and kernels are
compute, kernels named like a collective (NCCL) collective. Times are
whole nanoseconds (Kineto's resolution), so compute + collective +
transfer + host_gap equal the window exactly. Per device the
reference's ``per_device`` buckets and collective skew follow; a
one-card trace has no collectives, so its skew stats are empty.
"""

from __future__ import annotations

import glob
import gzip
import json
import os

ROUND_MARKER = "fed_round"
PHASE_PREFIX = "fed_phase"

#: Kineto event categories of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: substrings (lowercase) naming a collective kernel
COLLECTIVE_TOKENS = (
    "nccl", "all-reduce", "allreduce", "all-gather", "allgather",
    "reduce-scatter", "reducescatter", "all-to-all", "alltoall",
    "collective-permute", "collectivepermute", "sendrecv",
)

# one live FedModel a process -> one module-level marker state; "ann"
# is the open round range, closed at the next begin or at window exit
_STATE = {"tracing": False, "ann": None, "round": None}


def tracing() -> bool:
    return _STATE["tracing"]


def set_tracing(on: bool):
    """Flipped by ``profiler.trace_window`` at enter and exit. Turning
    tracing off closes any open round range first, so its end lands
    inside the trace."""
    if not on:
        end_round_marker()
    _STATE["tracing"] = bool(on)


def begin_round_marker(round_index: int):
    """Open round ``round_index``'s range (closing the previous
    round's). A no-op unless a trace window is open."""
    if not _STATE["tracing"]:
        return
    end_round_marker()
    import torch
    ann = torch.profiler.record_function(
        f"{ROUND_MARKER}::{int(round_index)}")
    ann.__enter__()
    _STATE["ann"] = ann
    _STATE["round"] = int(round_index)


def end_round_marker():
    ann, _STATE["ann"] = _STATE["ann"], None
    _STATE["round"] = None
    if ann is not None:
        ann.__exit__(None, None, None)


class _NullPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_PHASE = _NullPhase()


def phase(name: str):
    """A ``record_function`` range named ``fed_phase::<name>`` while
    tracing, the shared no-op otherwise. Used beside (not instead of)
    the telemetry host spans."""
    if not _STATE["tracing"]:
        return _NULL_PHASE
    import torch
    return torch.profiler.record_function(f"{PHASE_PREFIX}::{name}")


# --- trace file discovery + loading ------------------------------------


def find_trace_file(logdir: str):
    """Newest ``*.json`` or ``*.json.gz`` trace under ``logdir`` (at any
    depth); None when the profiler wrote nothing."""
    hits = []
    for pat in ("*.json", "*.json.gz"):
        hits.extend(glob.glob(os.path.join(logdir, "**", pat),
                              recursive=True))
    if not hits:
        return None
    return max(hits, key=os.path.getmtime)


def load_trace_events(path_or_logdir: str):
    """Chrome trace-event list from a trace file, or from the newest one
    under a directory."""
    path = path_or_logdir
    if os.path.isdir(path):
        path = find_trace_file(path)
        if path is None:
            raise FileNotFoundError(
                f"no trace .json(.gz) under {path_or_logdir}")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) \
        else doc
    return [e for e in events if isinstance(e, dict)]


def _ns(us) -> int:
    """Kineto's microsecond timestamps as whole nanoseconds."""
    return int(round(float(us) * 1000.0))


# --- lane classification -----------------------------------------------


def lane_devices(events):
    """(pid, tid) -> device id (``cuda:<n>``) of every lane holding work
    on a card: the lanes of ``kernel``/``gpu_memcpy``/``gpu_memset``
    events, the device from the event's ``args.device`` (else its
    pid)."""
    out = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        key = (e.get("pid"), e.get("tid"))
        if key not in out:
            dev = (e.get("args") or {}).get("device", key[0])
            out[key] = f"cuda:{dev}"
    return out


def device_lanes(events):
    """(pid, tid) pairs whose events are work on a card."""
    return set(lane_devices(events))


# --- interval math -----------------------------------------------------


def _union(intervals):
    """Merged, sorted interval list — nested/overlapping device events
    (module > fusion > op) collapse to their covering span."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _measure(merged):
    return sum(b - a for a, b in merged)


def _clip(intervals, lo, hi):
    out = []
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b))
    return out


def _subtract(a, b):
    """``a \\ b`` for merged, sorted interval lists — a lane's compute
    slice is its busy union minus its collective/transfer cover."""
    out = []
    j = 0
    for lo, hi in a:
        cur = lo
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            s, e = b[k]
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
            k += 1
        if cur < hi:
            out.append((cur, hi))
    return out


def _intersect(a, b):
    """``a ∩ b`` for merged, sorted interval lists — the overlapped
    bucket is collective ∩ (some lane's compute)."""
    out = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


# --- per-round attribution ---------------------------------------------


def round_windows(events):
    """[(round_index, begin_ns, end_ns), ...] from the ``fed_round::<r>``
    host ranges, in timeline order: each window is the range's own
    extent (begin_round to the next begin_round or the window's
    exit)."""
    wins = []
    prefix = ROUND_MARKER + "::"
    for e in events:
        name = e.get("name", "")
        if e.get("ph") != "X" or not name.startswith(prefix) \
                or e.get("cat") in DEVICE_CATS \
                or e.get("cat") == "gpu_user_annotation":
            continue
        ts = _ns(e.get("ts", 0.0))
        wins.append((int(name[len(prefix):]), ts,
                     ts + _ns(e.get("dur", 0.0))))
    wins.sort(key=lambda w: w[1])
    return wins


def _classify(e) -> str:
    if e.get("cat") == "gpu_memcpy":
        return "transfer"
    low = e.get("name", "").lower()
    if any(t in low for t in COLLECTIVE_TOKENS):
        return "collective"
    return "compute"


def _collective_groups(coll_by_dev, lo, hi):
    """Align matching collective events across devices inside one
    round window.

    ``coll_by_dev``: device -> [(op_name, ts, end), ...]. Each
    device's in-window occurrences of an op name are sorted by start;
    the k-th occurrence on every device forms one *group* (the same
    HLO collective executes once per participant, so equal names +
    occurrence rank is the alignment key). Returns
    ``[{device: (enter, exit)}, ...]`` with enters/exits clipped to
    the window."""
    per = {}
    for dev, insts in coll_by_dev.items():
        for name, ts, end in insts:
            a, b = max(ts, lo), min(end, hi)
            if b > a:
                per.setdefault(name, {}).setdefault(dev, []).append((a, b))
    groups = []
    for name in sorted(per):
        by_dev = per[name]
        for occ in by_dev.values():
            occ.sort()
        depth = max(len(occ) for occ in by_dev.values())
        for k in range(depth):
            groups.append({d: occ[k]
                           for d, occ in sorted(by_dev.items())
                           if k < len(occ)})
    return groups


def _p95(values):
    if not values:
        return 0.0
    vals = sorted(values)
    # nearest-rank: matches the ledger's other percentile fields
    idx = max(0, int(round(0.95 * len(vals) + 0.5)) - 1)
    return vals[min(idx, len(vals) - 1)]


def _skew_stats(groups):
    """Per-device wait intervals + round skew stats from the aligned
    collective groups of one window.

    For a group entered last at ``last_enter``, a device's *wait* is
    ``[enter, min(last_enter, exit)]`` — the straggler-skew slice of
    its collective time; the remainder is *wire*. Single-participant
    groups contribute no wait (all wire). The straggler device is the
    one that caused the most waiting: argmax over devices of the
    summed enter-delta of the groups it entered last."""
    wait_iv = {}
    deltas, caused = [], {}
    for g in groups:
        if len(g) < 2:
            continue
        enters = {d: iv[0] for d, iv in g.items()}
        last_enter = max(enters.values())
        delta = last_enter - min(enters.values())
        deltas.append(delta)
        # deterministic straggler on ties: largest enter, then id
        straggler = max(sorted(g), key=lambda d: (enters[d], d))
        caused[straggler] = caused.get(straggler, 0.0) + delta
        for d, (a, b) in g.items():
            w = min(last_enter, b)
            if w > a:
                wait_iv.setdefault(d, []).append((a, w))
    stats = {
        "n_collectives": len(deltas),
        "max_enter_delta_s": round(max(deltas) / 1e9, 9) if deltas else 0.0,
        "p95_enter_delta_s": round(_p95(deltas) / 1e9, 9),
        "straggler_device": (max(sorted(caused), key=lambda d: caused[d])
                             if caused else None),
    }
    return wait_iv, stats


def attribute_rounds(events) -> dict:
    """Per-round device-time buckets from one trace's events:

        {round_index: {"window_s", "busy_s", "compute_s",
                       "collective_s", "transfer_s", "host_gap_s",
                       "overlapped_s",
                       "per_device": {device_id: {...}},
                       "skew": {...}}}

    ``busy`` is the union of all device-lane events clipped to the
    round window (parallel lanes don't double-count wall time);
    collective/transfer are the unions of the matching-named events;
    ``compute = busy - collective - transfer`` and ``host_gap =
    window - busy``, so the four buckets sum to the window exactly
    (whole nanoseconds). The aggregate buckets pool every lane's
    intervals.

    ``overlapped_s`` is the slice of ``collective_s`` that ran
    concurrently with some lane's compute (pooled collective union ∩
    union of per-lane compute) — an overlay on the partition, not a
    fifth bucket: the four buckets above still sum to the window
    exactly, and ``collective_s - overlapped_s`` is the serial
    collective share the --overlap_depth pipeline is built to
    collapse.

    ``per_device[<id>]`` repeats the bucket math on that device's own
    interval set and splits its collective bucket into ``wait_s``
    (straggler skew, from the cross-device alignment of matching
    collectives) and ``wire_s = collective_s - wait_s`` — an exact
    partition by construction. ``skew`` carries the round-level stats
    (max/p95 enter-delta, straggler device id, matched-group count).
    """
    wins = round_windows(events)
    if not wins:
        return {}
    lanes = lane_devices(events)
    dev, coll, xfer = [], [], []
    by_dev = {}          # device -> {"dev": [...], "coll": [...], "xfer": [...]}
    coll_insts = {}      # device -> [(op_name, ts, end), ...]
    for e in events:
        key = (e.get("pid"), e.get("tid"))
        if e.get("ph") != "X" or key not in lanes:
            continue
        if e.get("cat") not in DEVICE_CATS:
            continue
        name = e.get("name", "")
        ts = _ns(e.get("ts", 0.0))
        iv = (ts, ts + _ns(e.get("dur", 0.0)))
        dev.append(iv)
        d = lanes[key]
        slot = by_dev.setdefault(d, {"dev": [], "coll": [], "xfer": []})
        slot["dev"].append(iv)
        kind = _classify(e)
        if kind == "collective":
            coll.append(iv)
            slot["coll"].append(iv)
            coll_insts.setdefault(d, []).append((name, iv[0], iv[1]))
        elif kind == "transfer":
            xfer.append(iv)
            slot["xfer"].append(iv)
    dev, coll, xfer = _union(dev), _union(coll), _union(xfer)
    for slot in by_dev.values():
        for k in slot:
            slot[k] = _union(slot[k])

    out = {}
    for ridx, lo, hi in wins:
        busy = _union(_clip(dev, lo, hi))
        c = _union(_clip(coll, lo, hi))
        t = _union(_clip(xfer, lo, hi))
        busy_ns = _measure(busy)
        coll_ns = _measure(c)
        # transfer time that isn't already counted as collective
        # (disjoint buckets: the four sum to the window)
        xfer_ns = _measure(_union(t + c)) - coll_ns
        win_ns = hi - lo
        # overlapped: wall time where the pooled collective union runs
        # concurrently with some lane's COMPUTE (its busy minus its
        # own collective/transfer cover) — the slice of collective_s
        # the --overlap_depth pipeline hid behind compute. An overlay
        # on the partition, not a fifth bucket: compute + collective +
        # transfer + host_gap still sum to the window exactly, and
        # 0 <= overlapped_s <= collective_s; collective_s -
        # overlapped_s is the SERIAL collective share.
        comp_iv = []
        for slot in by_dev.values():
            d_busy = _union(_clip(slot["dev"], lo, hi))
            d_other = _union(_clip(slot["coll"], lo, hi)
                             + _clip(slot["xfer"], lo, hi))
            comp_iv.extend(_subtract(d_busy, d_other))
        ovl_ns = _measure(_intersect(c, _union(comp_iv)))
        buckets = {
            "window_s": round(win_ns / 1e9, 9),
            "busy_s": round(busy_ns / 1e9, 9),
            "compute_s": round((busy_ns - coll_ns - xfer_ns) / 1e9, 9),
            "collective_s": round(coll_ns / 1e9, 9),
            "transfer_s": round(xfer_ns / 1e9, 9),
            "host_gap_s": round((win_ns - busy_ns) / 1e9, 9),
            "overlapped_s": round(min(ovl_ns, coll_ns) / 1e9, 9),
        }
        groups = _collective_groups(coll_insts, lo, hi)
        wait_iv, skew = _skew_stats(groups)
        per_device = {}
        for d in sorted(by_dev):
            slot = by_dev[d]
            d_busy_ns = _measure(_union(_clip(slot["dev"], lo, hi)))
            d_c = _union(_clip(slot["coll"], lo, hi))
            d_t = _union(_clip(slot["xfer"], lo, hi))
            d_coll_ns = _measure(d_c)
            d_xfer_ns = _measure(_union(list(d_t) + list(d_c))) - d_coll_ns
            d_wait_ns = _measure(_union(_clip(wait_iv.get(d, ()), lo, hi)))
            coll_s = round(d_coll_ns / 1e9, 9)
            wait_s = round(min(d_wait_ns, d_coll_ns) / 1e9, 9)
            per_device[d] = {
                "busy_s": round(d_busy_ns / 1e9, 9),
                "compute_s": round(
                    (d_busy_ns - d_coll_ns - d_xfer_ns) / 1e9, 9),
                "collective_s": coll_s,
                "transfer_s": round(d_xfer_ns / 1e9, 9),
                "wait_s": wait_s,
                # difference of two 6-dp values: wait + wire ==
                # collective holds exactly, not just to tolerance
                "wire_s": round(coll_s - wait_s, 9),
            }
        buckets["per_device"] = per_device
        buckets["skew"] = skew
        out[ridx] = buckets
    return out


def attribute_logdir(logdir: str) -> dict:
    """``attribute_rounds`` over the newest trace under ``logdir``;
    empty when no trace file exists."""
    path = find_trace_file(logdir)
    if path is None:
        return {}
    return attribute_rounds(load_trace_events(path))

"""Per-round critical-path extraction over causal span DAGs.

Port of ``commefficient_tpu/telemetry/critpath.py`` (``critical_path``
:64 with its ``device_time`` overlay, ``dominant_bucket`` :104,
``median_buckets`` :113, ``critpath_diff`` :128, ``CLOCK_TOLERANCE``).
The overlay reads the ``device_time`` stamp of the port's ``--profile``
trace window (telemetry/trace.py) as the reference reads its own: the
first lane of a ``per_device`` list, or a ``per_device`` dict holding
``collective_s``/``overlapped_s`` itself. Both traces key ``per_device``
by device id, which neither shape matches, so on a traced run the
overlay moves nothing (as in the reference; a one-card round has no
collective either).

Input is a round's ``causal`` stamp (telemetry/causal.py): a root
span covering the round's wall interval plus nested child spans. The
round loop is sequential on the host thread — device overlap hides
*inside* spans, not between them — so the longest dependency chain
IS the root interval, and the explanatory work is attributing every
second of it to the bucket that bounded progress then.

``critical_path`` walks the span tree recursively: a parent's
interval is partitioned among its children (clipped, sorted by begin
time); gaps between children belong to the parent's own bucket;
whatever the root itself can't hand to a child lands in
``host_other``. The invariant — checked by the golden-DAG tests —
is exact by construction:

    sum(buckets.values()) == root.e - root.b == causal["wall"]

Overlap awareness: host spans can't see how much collective time the
overlap engine actually hid behind compute, but the round record's
``device_time`` stamp can. When provided, ``critical_path`` moves
the *exposed* collective seconds — ``max(0, collective - overlapped)``
clipped to the compute bucket — from ``compute`` to
``collective_exposed``, so a chunked-overlap run attributes only the
un-hidden tail to the wire.

Cross-party spans (a job service's ``sched_grant`` stitched into a
tenant trace) are timestamped on a different monotonic clock; they
clip to the root interval and so contribute structure (parent edges
for orphan checks) but never skew the attribution.
"""

from __future__ import annotations

from commefficient_tpu_torch.telemetry.causal import BUCKETS

#: two clocks reading "the same" boundary (clock.tick() before vs
#: after a record stamp) disagree by far less than this; golden-DAG
#: tests assert exactness, real runs assert within tolerance.
CLOCK_TOLERANCE = 5e-3


def _attribute(span, children_of, buckets):
    """Recursively attribute ``span``'s interval: child intervals to
    the children (clipped, begin-sorted), gaps to ``span``'s own
    bucket."""
    b, e = float(span["b"]), float(span["e"])
    cursor = b
    own = span.get("bucket", "host_other")
    if own not in buckets:
        own = "host_other"
    for child in sorted(children_of.get(span["id"], ()),
                        key=lambda s: float(s["b"])):
        cb = min(max(float(child["b"]), cursor), e)
        ce = min(max(float(child["e"]), cb), e)
        if cb > cursor:
            buckets[own] += cb - cursor
        _attribute({**child, "b": cb, "e": ce}, children_of, buckets)
        cursor = max(cursor, ce)
    if e > cursor:
        buckets[own] += e - cursor


def critical_path(causal, device_time=None):
    """Fold one round's ``causal`` stamp into per-bucket seconds.

    Returns ``{"round", "wall", "buckets": {bucket: seconds}}`` with
    ``sum(buckets) == wall`` exactly, or None when ``causal`` is not
    a usable stamp. ``device_time`` (the round record's v3 stamp, if
    any) reapportions overlap-hidden collective time as described in
    the module docstring.
    """
    if not isinstance(causal, dict):
        return None
    spans = [s for s in causal.get("spans") or ()
             if isinstance(s, dict)]
    root = next((s for s in spans if s.get("parent") is None
                 and "trace" not in s), None)
    if root is None:
        return None
    children_of = {}
    for s in spans:
        if s is not root and s.get("parent") is not None:
            children_of.setdefault(s["parent"], []).append(s)
    buckets = {b: 0.0 for b in BUCKETS}
    _attribute(root, children_of, buckets)

    if isinstance(device_time, dict):
        per = device_time.get("per_device")
        lanes = per[0] if isinstance(per, (list, tuple)) and per \
            else per if isinstance(per, dict) else None
        if isinstance(lanes, dict):
            coll = float(lanes.get("collective_s") or 0.0)
            hidden = float(lanes.get("overlapped_s") or 0.0)
            exposed = min(max(0.0, coll - hidden), buckets["compute"])
            buckets["compute"] -= exposed
            buckets["collective_exposed"] += exposed

    wall = float(root["e"]) - float(root["b"])
    return {"round": causal.get("round"), "wall": wall,
            "buckets": buckets}


def dominant_bucket(crit):
    """``("h2d", 0.62)``-style headline for console columns; None
    when the round had no measurable wall time."""
    if not crit or crit["wall"] <= 0:
        return None
    b, s = max(crit["buckets"].items(), key=lambda kv: kv[1])
    return b, s / crit["wall"]


def median_buckets(crits):
    """Per-bucket median across rounds — the 'typical round' a
    regression diff compares against. None on empty input."""
    crits = [c for c in crits if c]
    if not crits:
        return None
    out = {}
    for b in BUCKETS:
        vals = sorted(c["buckets"].get(b, 0.0) for c in crits)
        n = len(vals)
        out[b] = (vals[n // 2] if n % 2
                  else 0.5 * (vals[n // 2 - 1] + vals[n // 2]))
    return out


def critpath_diff(cur, base):
    """Explain ``cur`` (a ``critical_path`` result) against ``base``
    (a ``median_buckets`` map): absolute and multiplicative growth
    per bucket, sorted by absolute growth. This is what an alarm
    firing attaches to its flight-recorder bundle."""
    if not cur or not isinstance(base, dict):
        return None
    rows = []
    for b in BUCKETS:
        c = cur["buckets"].get(b, 0.0)
        m = base.get(b, 0.0)
        rows.append({"bucket": b, "cur_s": c, "median_s": m,
                     "delta_s": c - m,
                     "ratio": (c / m) if m > 0 else None})
    rows.sort(key=lambda r: r["delta_s"], reverse=True)
    return {"round": cur.get("round"), "wall": cur["wall"],
            "base_wall": sum(base.values()), "rows": rows}

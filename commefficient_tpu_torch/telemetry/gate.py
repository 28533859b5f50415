"""Perf-gate math: a noise-aware comparison of run metrics with a
baseline.

Port of ``commefficient_tpu/telemetry/gate.py``, the same functions
and numbers. A baseline pins, per metric, the median and MAD (median
absolute deviation) of a reference run's samples, and ``compare()``
fails a fresh run only when it lands outside BOTH a relative tolerance
and a ``k x MAD`` noise band:

    lower-is-better:  fail when median_now > median_base
                                + max(rel_tol x median_base,
                                      mad_k x MAD_base)
    higher-is-better: symmetric, below the baseline

Median + MAD rather than mean + stddev: one bad draw moves neither the
baseline nor the verdict.

Metrics extracted from a ledger (``metrics_from_records``):

* ``span:<name>:ms`` — per-round host span samples;
* ``device:<bucket>`` — the per-round device-time buckets of a
  ``--profile`` window (compute/transfer/host_gap/busy seconds, and
  ``roofline_utilization``, where higher is better);
* ``bench:<metric>`` — bench-record headline values (higher is
  better), and ``bench:<metric>:round_s`` from a bench record's
  ``round_times_s``;
* ``device:skew_*`` — collective-skew stats (lower is better).

Baselines are topology-keyed (schema 2): one file holds a metrics
entry per ``d<D>p<P>`` point, suffixed for quantized wires
(``q<dtype>``), buffered-arrival rounds (``a<K>``), chunked emission
(``o<N>``), DP budgets (``p<eps>``) and the reference's mesh, autopilot
and service fragments, so no run is gated against another
experiment's pin. Schema-1 baselines (one flat metrics dict) stay
readable.

Pure stdlib: the gate entry point (``commefficient_tpu_torch.perf_gate``)
is host-side JSON work.
"""

from __future__ import annotations

import json
from statistics import median
from typing import Dict, List

from commefficient_tpu_torch.telemetry import clock

BASELINE_SCHEMA = 2
READABLE_BASELINE_SCHEMAS = (1, 2)

#: topology key for runs whose device/process counts are unknown
#: (pre-fleet ledgers with no meta record; direct metrics-dict tests)
ANY_TOPOLOGY = "any"

#: default gate knobs (CLI-overridable): generous enough for CI-class
#: noise, tight enough that a 2x regression can never pass
REL_TOL = 0.25
MAD_K = 5.0
#: a metric whose baseline median is under this (seconds-type metrics)
#: is below timer resolution/scheduler noise — never gated hard
MIN_GATED_SECONDS = 1e-4


def mad(samples: List[float]) -> float:
    """Median absolute deviation — the robust sigma."""
    if not samples:
        return 0.0
    m = median(samples)
    return median([abs(x - m) for x in samples])


def _pct(sorted_vals, q):
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def summarize_samples(samples: List[float], better: str) -> Dict:
    sv = sorted(samples)
    return {"median": median(sv), "mad": mad(sv), "n": len(sv),
            "p50": _pct(sv, 50), "p95": _pct(sv, 95),
            "better": better}


def metrics_from_records(records) -> Dict[str, Dict]:
    """Gateable metrics from one ledger's records (see module doc).
    Every metric value is a summarized sample set."""
    spans: Dict[str, List[float]] = {}
    device: Dict[str, List[float]] = {}
    bench: Dict[str, Dict] = {}
    for rec in records:
        kind = rec.get("kind")
        if kind == "round":
            for name, secs in (rec.get("spans") or {}).items():
                spans.setdefault(name, []).append(1e3 * float(secs))
            dt = rec.get("device_time") or {}
            for bname, val in dt.items():
                if isinstance(val, (int, float)):
                    device.setdefault(bname, []).append(float(val))
            skew = dt.get("skew")
            if isinstance(skew, dict):
                for sname in ("max_enter_delta_s", "p95_enter_delta_s"):
                    val = skew.get(sname)
                    if isinstance(val, (int, float)):
                        device.setdefault(f"skew_{sname}",
                                          []).append(float(val))
        elif kind == "bench":
            metric = rec.get("metric")
            if metric is None:
                continue
            val = rec.get("value")
            if isinstance(val, (int, float)):
                bench.setdefault(f"bench:{metric}", {
                    "samples": [], "better": "higher"})[
                        "samples"].append(float(val))
            times = rec.get("round_times_s")
            if isinstance(times, list) and times:
                bench.setdefault(f"bench:{metric}:round_s", {
                    "samples": [], "better": "lower"})[
                        "samples"].extend(float(t) for t in times)
    out: Dict[str, Dict] = {}
    for name, vals in sorted(spans.items()):
        out[f"span:{name}:ms"] = summarize_samples(vals, "lower")
    for name, vals in sorted(device.items()):
        # more hidden collective time is better, like utilization;
        # every other device bucket is time spent (lower wins)
        better = ("higher" if name in ("roofline_utilization",
                                       "overlapped_s") else "lower")
        out[f"device:{name}"] = summarize_samples(vals, better)
    for name, entry in sorted(bench.items()):
        out[name] = summarize_samples(entry["samples"],
                                      entry["better"])
    return out


def mesh_suffix(mesh_shape) -> str:
    """Canonical key fragment for a run's mesh layout: ``m<C>x<M>``
    for a genuinely 2D (clients x model) mesh, ``""`` for the 1-D
    layouts every pre-mesh run used — so existing ``d<D>p<P>`` pins
    keep matching 1-D runs unchanged, and only mesh-sharded runs get
    (and require) their own entry. Accepts the ledger/manifest dict
    form ({"clients": C, "model": M}) or a (C, M) pair."""
    if not mesh_shape:
        return ""
    if isinstance(mesh_shape, dict):
        c = int(mesh_shape.get("clients", 0) or 0)
        m = int(mesh_shape.get("model", 0) or 0)
    else:
        c, m = (int(x) for x in tuple(mesh_shape)[:2])
    if m <= 1:
        return ""
    return f"m{c}x{m}"


def wire_suffix(wire_dtype) -> str:
    """Canonical key fragment for a run's uplink wire dtype:
    ``q<dtype>`` for quantized sketches (``qint8``, ``qbf16``,
    ``qfp8``), ``""`` for f32/unknown — so every pre-quantization pin
    keeps matching f32 runs unchanged, and a quantized run gets (and
    REQUIRES) its own entry. An int8 round moves ~4x fewer collective
    bytes than the f32 reference; letting it resolve an f32 pin would
    make the gate read the dtype change as a giant perf swing in both
    directions."""
    if not wire_dtype or str(wire_dtype) == "f32":
        return ""
    return f"q{wire_dtype}"


def async_suffix(async_k) -> str:
    """Canonical key fragment for a buffered-arrival run:
    ``a<K>`` when ``--async_buffer_size K`` was on, ``""`` for the
    synchronous barrier every pre-async pin measured. A buffered
    round overlaps the next cohort's arrivals with the fold, so its
    wall profile is a different experiment from the synchronous run
    of the same config — an async ledger must never resolve (or
    overwrite) a synchronous pin."""
    k = int(async_k or 0)
    return f"a{k}" if k > 0 else ""


def overlap_suffix(overlap_depth) -> str:
    """Canonical key fragment for a chunked-emission run: ``o<N>``
    when ``--overlap_depth N`` > 1 was on, ``""`` for the serial
    round every pre-overlap pin measured (depth 1 is HLO-identical to
    the pre-overlap program, so it keeps the bare key). A pipelined
    round's collective profile is a different experiment from the
    serial one — an o4 ledger must never resolve (or overwrite) an
    o1/bare pin, and there is NO cross-depth fallback (like the wire
    and async fragments, unlike the mesh fragment)."""
    n = int(overlap_depth or 0)
    return f"o{n}" if n > 1 else ""


def band_suffix(band) -> str:
    """Canonical key fragment for an autopilot-controlled run:
    ``b<lo-hi>`` (``b0.2-0.6``) when ``--autopilot on`` held the
    recovery error inside ``--autopilot_band LO:HI``, ``""`` for
    static-knob runs. An autopilot run's wall profile mixes every
    lattice point the controller visited (plus the re-jit cache's
    compile stalls), so it is a different experiment from any one
    static program — and two different bands walk different ladders.
    Like the wire/async/overlap fragments there is NO fallback: a
    banded ledger must never resolve (or overwrite) a static pin, nor
    another band's. Accepts "LO:HI", "LO-HI", or a (lo, hi) pair."""
    if not band:
        return ""
    if isinstance(band, str):
        s = band.replace(":", "-")
    else:
        lo, hi = (float(x) for x in tuple(band)[:2])
        s = f"{lo:g}-{hi:g}"
    return f"b{s}"


def privacy_suffix(dp_epsilon) -> str:
    """Canonical key fragment for a differentially-private run:
    ``p<eps>`` (``p3.5``; ``p0`` is DP with an unlimited budget) when
    ``--dp sketch`` clipped the clients and noised the aggregated
    table, ``""`` for the noiseless runs every pre-privacy pin
    measured. The calibrated Gaussian changes both what the ledger's
    recovery probes see and the round's wall profile (per-client
    clip, the noise draw, the forced-f32 wire), so a DP round is a
    different experiment from the same config without it — and two
    different budgets drive different autopilot walks. Like the
    wire/async/overlap/band fragments there is NO fallback in either
    direction: a DP ledger must never resolve (or overwrite) a
    noiseless pin, nor another budget's. ``dp_epsilon`` must be None
    for non-DP runs — 0.0 is a real value (unlimited budget), not an
    absence."""
    if dp_epsilon is None:
        return ""
    return f"p{float(dp_epsilon):g}"


def service_suffix(service_jobs) -> str:
    """Canonical key fragment for a multi-tenant fedservice run:
    ``j<J>`` when the daemon multiplexed J >= 2 jobs over the pod,
    ``""`` for solo runs — a single job through the daemon is
    bit-identical to driving the model directly (the fedservice
    parity contract), so it honestly keeps the bare key. A J-job
    run's wall profile interleaves J independent round programs (plus
    the scheduler's switching cost), which no single-job pin
    measured — and a 2-job and a 3-job pod are different experiments
    too. Like the wire/async/overlap/band/privacy fragments there is
    NO fallback in either direction: a j3 ledger must never resolve
    (or overwrite) a solo pin, nor a j2 one."""
    j = int(service_jobs or 0)
    return f"j{j}" if j > 1 else ""


def topology_key(device_count=None, process_count=None,
                 mesh_shape=None, wire_dtype=None,
                 async_k=None, overlap_depth=None, band=None,
                 dp_epsilon=None, service_jobs=None) -> str:
    """Baseline entry key for one topology point. ``d<D>p<P>`` when
    both counts are known — suffixed ``m<C>x<M>`` for 2D-mesh runs
    (a 4x2 and an 8x1 run on the same 8 chips are different programs,
    not one noise band), ``q<dtype>`` for quantized-wire runs
    (int8 vs f32 collectives are different experiments), ``a<K>``
    for buffered-arrival runs (an async fold overlaps work a barrier
    round waits for), ``o<N>`` for chunked-emission runs (a
    pipelined collective profile is a different experiment from the
    serial one), ``b<lo-hi>`` for autopilot-controlled runs (the
    knob walk mixes lattice points no static program mixes) and
    ``p<eps>`` for differentially-private runs (the clip + table
    noise is a different experiment from the noiseless program) —
    :data:`ANY_TOPOLOGY` otherwise: unknown
    topologies form their own bucket rather than silently matching a
    counted one. Quantized/async/overlapped/banded/private/
    multi-tenant runs with unknown counts still split off
    (``any-q<dtype>``, ``any-a<K>``, ``any-o<N>``, ``any-b<lo-hi>``,
    ``any-p<eps>``, ``any-j<J>``)."""
    if device_count is None or process_count is None:
        w = (wire_suffix(wire_dtype) + async_suffix(async_k)
             + overlap_suffix(overlap_depth) + band_suffix(band)
             + privacy_suffix(dp_epsilon)
             + service_suffix(service_jobs))
        return f"{ANY_TOPOLOGY}-{w}" if w else ANY_TOPOLOGY
    return (f"d{int(device_count)}p{int(process_count)}"
            f"{mesh_suffix(mesh_shape)}{wire_suffix(wire_dtype)}"
            f"{async_suffix(async_k)}{overlap_suffix(overlap_depth)}"
            f"{band_suffix(band)}{privacy_suffix(dp_epsilon)}"
            f"{service_suffix(service_jobs)}")


def make_topology_entry(metrics: Dict[str, Dict], *, source: str = "",
                        device_count=None, process_count=None,
                        config_hash: str = "", mesh_shape=None,
                        wire_dtype=None, async_k=None,
                        overlap_depth=None, band=None,
                        dp_epsilon=None, service_jobs=None) -> Dict:
    entry = {"ts": clock.wall(), "source": source, "metrics": metrics}
    if device_count is not None:
        entry["device_count"] = int(device_count)
    if process_count is not None:
        entry["process_count"] = int(process_count)
    if config_hash:
        entry["config_hash"] = config_hash
    if mesh_suffix(mesh_shape):
        entry["mesh_shape"] = (dict(mesh_shape)
                               if isinstance(mesh_shape, dict)
                               else list(mesh_shape))
    if wire_suffix(wire_dtype):
        entry["wire_dtype"] = str(wire_dtype)
    if async_suffix(async_k):
        entry["async_buffer_size"] = int(async_k)
    if overlap_suffix(overlap_depth):
        entry["overlap_depth"] = int(overlap_depth)
    if band_suffix(band):
        entry["autopilot_band"] = (str(band) if isinstance(band, str)
                                   else list(band))
    if privacy_suffix(dp_epsilon):
        entry["dp_epsilon"] = float(dp_epsilon)
    if service_suffix(service_jobs):
        entry["service_jobs"] = int(service_jobs)
    return entry


def make_baseline(metrics: Dict[str, Dict], *, source: str = "",
                  extra: Dict = None, device_count=None,
                  process_count=None, config_hash: str = "",
                  mesh_shape=None, wire_dtype=None,
                  async_k=None, overlap_depth=None,
                  band=None, dp_epsilon=None,
                  service_jobs=None) -> Dict:
    """A fresh schema-2 baseline holding one topology entry."""
    key = topology_key(device_count, process_count, mesh_shape,
                       wire_dtype, async_k, overlap_depth, band,
                       dp_epsilon, service_jobs)
    base = {"schema": BASELINE_SCHEMA, "ts": clock.wall(),
            "topologies": {key: make_topology_entry(
                metrics, source=source, device_count=device_count,
                process_count=process_count, config_hash=config_hash,
                mesh_shape=mesh_shape, wire_dtype=wire_dtype,
                async_k=async_k, overlap_depth=overlap_depth,
                band=band, dp_epsilon=dp_epsilon,
                service_jobs=service_jobs)}}
    if extra:
        base.update(extra)
    return base


def migrate_baseline(baseline: Dict) -> Dict:
    """Schema-1 -> schema-2: the flat metrics dict becomes the
    :data:`ANY_TOPOLOGY` entry (it was captured topology-blind, so
    that is the honest key). Schema-2 passes through unchanged."""
    if baseline.get("schema") == BASELINE_SCHEMA:
        return baseline
    return {"schema": BASELINE_SCHEMA,
            "ts": baseline.get("ts", clock.wall()),
            "topologies": {ANY_TOPOLOGY: {
                "ts": baseline.get("ts", clock.wall()),
                "source": baseline.get("source", ""),
                "metrics": baseline.get("metrics", {})}}}


def update_baseline(baseline: Dict, metrics: Dict[str, Dict], *,
                    source: str = "", device_count=None,
                    process_count=None, config_hash: str = "",
                    mesh_shape=None, wire_dtype=None,
                    async_k=None, overlap_depth=None,
                    band=None, dp_epsilon=None,
                    service_jobs=None) -> Dict:
    """Insert/replace ONE topology's entry, leaving every other
    topology point untouched — how the gate CLI re-captures the
    8-device headline without disturbing the single-chip one.
    Schema-1 input is migrated first. Returns the (new) baseline."""
    base = migrate_baseline(dict(baseline)) if baseline else \
        {"schema": BASELINE_SCHEMA, "ts": clock.wall(),
         "topologies": {}}
    base["topologies"] = dict(base.get("topologies", {}))
    key = topology_key(device_count, process_count, mesh_shape,
                       wire_dtype, async_k, overlap_depth, band,
                       dp_epsilon, service_jobs)
    base["topologies"][key] = make_topology_entry(
        metrics, source=source, device_count=device_count,
        process_count=process_count, config_hash=config_hash,
        mesh_shape=mesh_shape, wire_dtype=wire_dtype,
        async_k=async_k, overlap_depth=overlap_depth, band=band,
        dp_epsilon=dp_epsilon, service_jobs=service_jobs)
    base["ts"] = clock.wall()
    return base


def baseline_entry(baseline: Dict, device_count=None,
                   process_count=None, mesh_shape=None,
                   wire_dtype=None, async_k=None,
                   overlap_depth=None, band=None, dp_epsilon=None,
                   service_jobs=None):
    """The topology entry ``compare`` gates against, or None when the
    baseline has no entry for this topology. A 2D-mesh run resolves
    its exact ``d<D>p<P>m<C>x<M>`` entry first and falls back to the
    mesh-blind ``d<D>p<P>`` pin (pins captured before mesh keying
    existed keep gating until re-captured — migration, not a hole).
    Quantized-wire and buffered-arrival runs get NO such fallback: an
    int8 run must never resolve an f32 pin (the dtype changes the
    collective bytes ~4x) and an async run must never resolve a
    synchronous pin (the buffered fold overlaps waits the barrier
    round eats) — cross-mode comparison is a category error, not
    noise. An ungated quantized/async topology stays None (compare
    raises loudly). Schema-1 baselines resolve for ANY topology
    (their historical, topology-blind behaviour — re-capture to get
    keyed guarding)."""
    schema = baseline.get("schema")
    if schema not in READABLE_BASELINE_SCHEMAS:
        raise ValueError(
            f"baseline schema {schema!r} not in "
            f"{READABLE_BASELINE_SCHEMAS} — re-capture the baseline")
    if schema == 1:
        return {"source": baseline.get("source", ""),
                "metrics": baseline.get("metrics", {})}
    topologies = baseline.get("topologies", {})
    entry = topologies.get(
        topology_key(device_count, process_count, mesh_shape,
                     wire_dtype, async_k, overlap_depth, band,
                     dp_epsilon, service_jobs))
    if entry is None and mesh_suffix(mesh_shape):
        # drop only the mesh fragment; the wire, async, overlap, band,
        # privacy AND service fragments stay — there is no
        # cross-dtype, cross-mode, cross-depth, cross-band,
        # cross-budget or cross-J fallback (an o2 pipelined round has
        # a different collective schedule than the serial o1 program;
        # a b0.2-0.6 autopilot walk mixes programs no static pin
        # measured; a p3.5 run's probes carry calibrated noise no
        # noiseless pin ever saw; a j3 pod interleaves three round
        # programs no solo pin ever dispatched)
        entry = topologies.get(
            topology_key(device_count, process_count,
                         wire_dtype=wire_dtype, async_k=async_k,
                         overlap_depth=overlap_depth, band=band,
                         dp_epsilon=dp_epsilon,
                         service_jobs=service_jobs))
    return entry


def _threshold(base_entry: Dict, rel_tol: float, mad_k: float):
    m = base_entry["median"]
    return max(rel_tol * abs(m), mad_k * base_entry.get("mad", 0.0))


def compare(baseline: Dict, metrics: Dict[str, Dict],
            rel_tol: float = REL_TOL,
            mad_k: float = MAD_K, device_count=None,
            process_count=None, mesh_shape=None,
            wire_dtype=None, async_k=None,
            overlap_depth=None, band=None, dp_epsilon=None,
            service_jobs=None) -> Dict:
    """Gate ``metrics`` against ``baseline``'s entry for this
    topology. Returns::

        {"regressions": [...], "improvements": [...],
         "skipped": [...], "checked": N, "topology": key}

    Only metrics present on BOTH sides are gated (a new span or a
    trace-less run is a skip, not a failure). Sub-resolution timing
    metrics are never hard failures (MIN_GATED_SECONDS-equivalent:
    0.1 ms for ms-metrics, 100 µs for s-metrics). Raises ValueError
    when the baseline has no entry for this topology — an ungated
    topology point must fail loudly, not pass silently."""
    key = topology_key(device_count, process_count, mesh_shape,
                       wire_dtype, async_k, overlap_depth, band,
                       dp_epsilon, service_jobs)
    entry = baseline_entry(baseline, device_count, process_count,
                           mesh_shape, wire_dtype, async_k,
                           overlap_depth, band, dp_epsilon,
                           service_jobs)
    if entry is None:
        have = ", ".join(sorted(baseline.get("topologies", {}))) \
            or "none"
        raise ValueError(
            f"no baseline entry for topology {key} (have: {have}) — "
            f"capture one with --write-baseline")
    base_metrics = entry.get("metrics", {})
    regressions, improvements, skipped = [], [], []
    checked = 0
    for name in sorted(set(base_metrics) | set(metrics)):
        b, c = base_metrics.get(name), metrics.get(name)
        if b is None or c is None:
            skipped.append({"metric": name,
                            "reason": ("not in baseline" if b is None
                                       else "not in current run")})
            continue
        floor = (MIN_GATED_SECONDS * 1e3 if name.endswith(":ms")
                 else MIN_GATED_SECONDS)
        if name.startswith(("span:", "device:", "bench:")) and \
                name != "device:roofline_utilization" and \
                b["better"] == "lower" and abs(b["median"]) < floor:
            skipped.append({"metric": name,
                            "reason": "below timing resolution"})
            continue
        checked += 1
        tol = _threshold(b, rel_tol, mad_k)
        delta = c["median"] - b["median"]
        entry = {"metric": name, "baseline": b["median"],
                 "current": c["median"],
                 "delta": delta, "tolerance": tol,
                 "better": b["better"]}
        if b["better"] == "lower":
            if delta > tol:
                regressions.append(entry)
            elif delta < -tol:
                improvements.append(entry)
        else:
            if delta < -tol:
                regressions.append(entry)
            elif delta > tol:
                improvements.append(entry)
    return {"regressions": regressions,
            "improvements": improvements,
            "skipped": skipped, "checked": checked,
            "topology": key}


def render_verdict(verdict: Dict) -> str:
    topo = verdict.get("topology")
    lines = [f"perf gate"
             f"{f' [{topo}]' if topo else ''}: "
             f"{verdict['checked']} metric(s) checked, "
             f"{len(verdict['regressions'])} regression(s), "
             f"{len(verdict['improvements'])} improvement(s), "
             f"{len(verdict['skipped'])} skipped"]
    for r in verdict["regressions"]:
        lines.append(
            f"  REGRESSION {r['metric']}: {r['baseline']:.6g} -> "
            f"{r['current']:.6g} ({'+' if r['delta'] >= 0 else ''}"
            f"{r['delta']:.6g}, tolerance {r['tolerance']:.6g}, "
            f"{r['better']} is better)")
    for r in verdict["improvements"]:
        lines.append(
            f"  improvement {r['metric']}: {r['baseline']:.6g} -> "
            f"{r['current']:.6g}")
    return "\n".join(lines)


def load_baseline(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def save_baseline(baseline: Dict, path: str):
    with open(path, "w") as f:
        json.dump(baseline, f, indent=1, sort_keys=True)
        f.write("\n")

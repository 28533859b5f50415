"""Ledger record schema (version 7), a copy of the reference's.

Port of ``commefficient_tpu/telemetry/record.py``: the record makers
and ``validate_record`` are the reference's, so a ledger the port
writes validates under the reference's ``validate_record`` and the
reference's report tooling reads it. A run ledger is a JSONL file, one
self-describing record per line, each with ``schema`` and ``kind``:

``meta``    -- one a run, first: the static description of the round
               program (``core.rounds.round_plan``).
``round``   -- one a training round: wall-time spans (seconds) of the
               host phases (sampler, gather, h2d, h2d_state,
               round_dispatch, metrics_host, server, writeback,
               async_fold), counters (prefetch hits and misses, kernel
               builds as compile events), uplink/downlink bytes (equal
               to FedModel's accounting), host-RSS and device-memory
               peaks; ``probes`` (None with probes off, else the
               round's algorithm diagnostics), ``alarms`` (the fired
               alarm dicts), ``device_time`` (None outside
               ``--profile``, else the round's device-time buckets,
               telemetry/trace.py), ``dp_epsilon``/``dp_delta``/
               ``dp_sigma`` (None outside ``--dp sketch``) and ``slo``
               (None: no SLO engine is ported).
``epoch``   -- the trainer's per-epoch row.
``bench``   -- a benchmark headline metric.
``summary`` -- an end-of-run aggregate (the console sink's, and the
               alarm totals ``Telemetry.close`` emits).

The ``sampler`` span measures fetching the NEXT round's batch and is
attributed to the round that is open while the fetch happens. The
optional v7 ``causal`` stamp (``--causal_trace``) is never written by
the port; ``validate_record`` still checks one where present.
"""

from __future__ import annotations

from commefficient_tpu_torch.telemetry import clock

LEDGER_SCHEMA_VERSION = 7

# versions validate_record accepts: v1 (pre-probe), v2 (pre-trace),
# v3 (pre-fleet), v4 (pre-DP), v5 (pre-SLO) and v6 (pre-causal)
# ledgers stay readable by the report tooling
READABLE_SCHEMA_VERSIONS = (1, 2, 3, 4, 5, 6, 7)

# device_time keys whose values are nested dicts (v4); every other
# bucket value must be numeric
DEVICE_TIME_DICT_KEYS = ("per_device", "skew")

KINDS = ("meta", "round", "epoch", "bench", "summary")

# keys every round record must carry (values may be None where noted)
ROUND_REQUIRED_KEYS = (
    "schema", "kind", "ts", "round", "spans", "counters",
    "uplink_bytes", "downlink_bytes",      # None until accounted
    "host_rss_peak_bytes",                 # None off-Linux
    "hbm_peak_bytes",                      # None off-accelerator
)

# v2 additions (not required of v1 records)
ROUND_V2_KEYS = (
    "probes",                              # None with probing off
    "alarms",                              # [] when nothing fired
)

# v3 additions (not required of v1/v2 records)
ROUND_V3_KEYS = (
    "device_time",                         # None outside --profile
)

# v5 additions (not required of v1-v4 records)
ROUND_V5_KEYS = (
    "dp_epsilon",                          # None outside --dp runs
    "dp_delta",                            # None outside --dp runs
    "dp_sigma",                            # None outside --dp runs
)

# v6 additions (not required of v1-v5 records)
ROUND_V6_KEYS = (
    "slo",                                 # None without an SLO engine
)

# v7 adds no required keys: ``causal`` is optional (present only
# under --causal_trace) so the off path adds zero ledger fields
ROUND_V7_KEYS = ()

# keys every span dict inside a causal stamp must carry
CAUSAL_SPAN_KEYS = ("id", "parent", "name", "bucket", "b", "e")


def _base(kind: str) -> dict:
    return {"schema": LEDGER_SCHEMA_VERSION, "kind": kind,
            "ts": clock.wall()}


def make_meta_record(**fields) -> dict:
    rec = _base("meta")
    rec.update(fields)
    return rec


def make_round_record(round_index: int) -> dict:
    rec = _base("round")
    rec.update({
        "round": int(round_index),
        "spans": {},
        "counters": {},
        "uplink_bytes": None,
        "downlink_bytes": None,
        "host_rss_peak_bytes": None,
        "hbm_peak_bytes": None,
        "probes": None,
        "alarms": [],
        "device_time": None,
        "dp_epsilon": None,
        "dp_delta": None,
        "dp_sigma": None,
        "slo": None,
    })
    return rec


def make_epoch_record(row: dict, epoch: int) -> dict:
    rec = _base("epoch")
    rec["epoch"] = int(epoch)
    rec["row"] = {k: v for k, v in row.items()}
    return rec


def make_bench_record(metric: str, value, unit: str, **extra) -> dict:
    rec = _base("bench")
    rec.update({"metric": str(metric), "value": value,
                "unit": str(unit)})
    rec.update(extra)
    return rec


def make_summary_record(**fields) -> dict:
    rec = _base("summary")
    rec.update(fields)
    return rec


def _validate_causal(causal) -> list:
    """Problems with an optional v7 ``causal`` stamp (the key is
    validated only when present — absence is the off-mode contract)."""
    if not isinstance(causal, dict):
        return ["causal is not a dict"]
    problems = []
    if not isinstance(causal.get("trace"), str):
        problems.append("causal.trace is not a string")
    if not isinstance(causal.get("round"), int):
        problems.append("causal.round is not an int")
    if not isinstance(causal.get("wall"), (int, float)):
        problems.append("causal.wall is non-numeric")
    spans = causal.get("spans")
    if not isinstance(spans, list):
        return problems + ["causal.spans is not a list"]
    for span in spans:
        if not isinstance(span, dict):
            problems.append("causal span is not a dict")
            continue
        for key in CAUSAL_SPAN_KEYS:
            if key not in span:
                problems.append(f"causal span missing {key!r}")
        for key in ("id", "name", "bucket"):
            if key in span and not isinstance(span[key], str):
                problems.append(f"causal span {key} is not a string")
        if span.get("parent") is not None \
                and not isinstance(span.get("parent"), str):
            problems.append("causal span parent is not str-or-None")
        for key in ("b", "e"):
            if key in span and not isinstance(span[key], (int, float)):
                problems.append(f"causal span {key} is non-numeric")
    return problems


def validate_record(rec) -> list:
    """Schema check: a list of problem strings, empty when valid."""
    problems = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not dict"]
    schema = rec.get("schema")
    if schema not in READABLE_SCHEMA_VERSIONS:
        problems.append(f"schema {schema!r} not in "
                        f"{READABLE_SCHEMA_VERSIONS}")
    kind = rec.get("kind")
    if kind not in KINDS:
        problems.append(f"unknown kind {kind!r}")
    if not isinstance(rec.get("ts"), (int, float)):
        problems.append("ts missing or non-numeric")
    if kind == "round":
        required = ROUND_REQUIRED_KEYS
        if isinstance(schema, int) and schema >= 2:
            required = required + ROUND_V2_KEYS
        if isinstance(schema, int) and schema >= 3:
            required = required + ROUND_V3_KEYS
        if isinstance(schema, int) and schema >= 5:
            required = required + ROUND_V5_KEYS
        if isinstance(schema, int) and schema >= 6:
            required = required + ROUND_V6_KEYS
        for key in required:
            if key not in rec:
                problems.append(f"round record missing {key!r}")
        if not isinstance(rec.get("spans"), dict):
            problems.append("spans is not a dict")
        elif any(not isinstance(v, (int, float))
                 for v in rec["spans"].values()):
            problems.append("non-numeric span value")
        if not isinstance(rec.get("counters"), dict):
            problems.append("counters is not a dict")
        for key in ("uplink_bytes", "downlink_bytes") + ROUND_V5_KEYS:
            v = rec.get(key)
            if v is not None and not isinstance(v, (int, float)):
                problems.append(f"{key} is non-numeric")
        slo = rec.get("slo")
        if slo is not None and not isinstance(slo, dict):
            problems.append("slo is not a dict")
        if "causal" in rec:                # optional (v7): validate
            problems.extend(_validate_causal(rec["causal"]))
        dt = rec.get("device_time")
        if dt is not None:
            if not isinstance(dt, dict):
                problems.append("device_time is not a dict")
            else:
                for k, v in dt.items():
                    if k in DEVICE_TIME_DICT_KEYS:
                        if not isinstance(v, dict):
                            problems.append(
                                f"device_time.{k} is not a dict")
                    elif not isinstance(v, (int, float)):
                        problems.append("non-numeric device_time bucket")
    proc = rec.get("process")
    if proc is not None and not isinstance(proc, int):
        problems.append("process is non-integer")
    if kind == "bench":
        for key in ("metric", "value", "unit"):
            if key not in rec:
                problems.append(f"bench record missing {key!r}")
    if kind == "epoch" and not isinstance(rec.get("row"), dict):
        problems.append("epoch record missing row dict")
    if kind == "summary":
        fired = rec.get("alarm_fired")
        if fired is not None and (
                not isinstance(fired, dict)
                or any(not isinstance(v, (int, float))
                       for v in fired.values())):
            problems.append("alarm_fired is not a {rule: count} dict")
    return problems

"""Merge per-rank ledger shards into one ledger.

Port of ``scripts/ledger_merge.py`` (which imports the JAX package's
``telemetry.causal`` and ``.record``; this copy reads the port's)::

    python -m commefficient_tpu_torch.telemetry.merge runs/a.jsonl
        finds runs/a.jsonl.p1.jsonl, runs/a.jsonl.p2.jsonl, ... (the
        shards telemetry/core.py ``build_telemetry`` writes on a mesh)
        and writes runs/a.jsonl.merged.jsonl

In the port a shard is a rank: rank k of a mesh run (one process a
card, parallel/mesh.py) writes ``<ledger>.p<k>.jsonl``, where the
reference's process k is a JAX host. Rank 0 owns the canonical ledger;
its round records carry the accounting every rank holds alike. Every
other rank's shard carries what only that rank observed: its host
spans, RSS watermark, bytes and, under ``--profile``, its own device
time. The merge joins the shards on round id:

* each canonical round record gains ``shards`` — ``{"p<k>": {spans,
  counters, host_rss_peak_bytes, uplink_bytes, downlink_bytes,
  host_gap_s}}`` — and ``host_gap_by_process``, each rank's host-gap
  seconds (a rank that stalls shows as its own gap, not an average);
* shard rounds the canonical ledger lacks are appended in round order
  with ``shard_only: true``;
* shard meta, bench and epoch records are dropped (the canonical copies
  hold); the count is reported.

The job service's per-job shards (``<ledger>.job<j>.jsonl``,
telemetry/sinks.py ``job_ledger_path``) are independent round streams:
each job's records are appended after the canonical stream stamped
``"job": j``. A spatial job of several cards writes its own rank
sub-shards (``<ledger>.job<j>.jsonl.p<k>.jsonl``), joined on round id
within the job first.

Causal stitching (``--causal_trace``): joined round records take the
union of their shards' ``causal`` spans (deduplicated by span id), and
the merged stream's traces are reassembled (telemetry/causal.py
``assemble_traces``); an orphan span (a parent id no shard supplied) is
warned about. Host JSON work only.
"""

from __future__ import annotations

import argparse
import glob
import json
import re
import sys

from commefficient_tpu_torch.telemetry.causal import assemble_traces
from commefficient_tpu_torch.telemetry.record import validate_record

MERGED_SUFFIX = ".merged.jsonl"

#: the round-record keys a shard contributes to the merged view (what
#: its rank measured; device_time collapses to its host-gap bucket)
SHARD_VIEW_KEYS = ("spans", "counters", "host_rss_peak_bytes",
                   "uplink_bytes", "downlink_bytes")


def _discover(path: str, tag: str) -> list:
    hits = []
    for shard in glob.glob(glob.escape(path) + f".{tag}*.jsonl"):
        m = re.match(re.escape(path) + rf"\.{tag}(\d+)\.jsonl$", shard)
        if m:
            hits.append((int(m.group(1)), shard))
    return sorted(hits)


def discover_shards(path: str) -> list:
    """[(rank, shard_path), ...] of a canonical ledger path, by rank
    (telemetry/sinks.py ``shard_ledger_path``)."""
    return _discover(path, "p")


def discover_job_shards(path: str) -> list:
    """[(job_index, shard_path), ...] of a job service's base ledger
    path, by job index (telemetry/sinks.py ``job_ledger_path``)."""
    return _discover(path, "job")


def merge_job_shards(merged, job_records: dict) -> tuple:
    """Append the per-job records ``job_records`` ({job_index: [records,
    ...]}) to a merged stream, each stamped ``"job": j``. Returns
    (records, stats)."""
    out = list(merged)
    appended = 0
    for j, records in sorted(job_records.items()):
        for rec in records:
            out.append(dict(rec, job=int(j)))
            appended += 1
    return out, {"job_records": appended,
                 "jobs": sorted(int(j) for j in job_records)}


def load_records(path: str) -> tuple:
    """(records, problems) of one JSONL ledger; a bad line is skipped
    and reported, not fatal."""
    records, problems = [], []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as exc:
                problems.append(f"{path}:{lineno}: not JSON ({exc})")
                continue
            issues = validate_record(rec)
            if issues:
                problems.append(f"{path}:{lineno}: " + "; ".join(issues))
                continue
            records.append(rec)
    return records, problems


def _host_gap_s(rec):
    dt = rec.get("device_time")
    if isinstance(dt, dict):
        hg = dt.get("host_gap_s")
        if isinstance(hg, (int, float)):
            return hg
    return None


def _merge_causal(rec, shards: dict):
    """The union of the canonical record's and its shards' causal spans,
    deduplicated by span id, onto the (copied) canonical record: each
    rank carries the spans only it observed."""
    stamps = [rec.get("causal")]
    stamps += [sh.get("causal") for _, sh in sorted(shards.items())]
    stamps = [s for s in stamps if isinstance(s, dict)]
    if not stamps:
        return
    merged = dict(stamps[0])
    seen, spans = set(), []
    for stamp in stamps:
        for span in stamp.get("spans") or ():
            sid = span.get("id")
            if sid in seen:
                continue
            seen.add(sid)
            spans.append(span)
    merged["spans"] = spans
    rec["causal"] = merged


def _shard_view(rec) -> dict:
    view = {key: rec[key] for key in SHARD_VIEW_KEYS
            if rec.get(key) is not None}
    hg = _host_gap_s(rec)
    if hg is not None:
        view["host_gap_s"] = hg
    return view


def merge_ledgers(canonical_records, shard_records: dict) -> tuple:
    """Join the shards' round records onto the canonical ones by round
    id. ``shard_records``: {rank: [records, ...]}. Returns (merged
    records, stats): joined and shard-only rounds, dropped non-round
    shard records, the ranks."""
    shard_rounds = {}       # round id -> {"p<k>": round record}
    dropped = 0
    for k, records in sorted(shard_records.items()):
        for rec in records:
            if rec.get("kind") == "round":
                shard_rounds.setdefault(rec["round"], {})[f"p{int(k)}"] = rec
            else:
                dropped += 1
    merged, joined, seen_rounds = [], 0, set()
    for rec in canonical_records:
        if rec.get("kind") != "round":
            merged.append(rec)
            continue
        ridx = rec["round"]
        seen_rounds.add(ridx)
        shards = shard_rounds.get(ridx)
        if not shards:
            merged.append(rec)
            continue
        joined += 1
        rec = dict(rec)
        rec["shards"] = {pk: _shard_view(sh)
                         for pk, sh in sorted(shards.items())}
        _merge_causal(rec, shards)
        gaps = {}
        hg0 = _host_gap_s(rec)
        if hg0 is not None:
            gaps["p0"] = hg0
        for pk, sh in sorted(shards.items()):
            hg = _host_gap_s(sh)
            if hg is not None:
                gaps[pk] = hg
        if gaps:
            rec["host_gap_by_process"] = gaps
        merged.append(rec)
    # rounds only a shard saw (rank 0 stopped first): kept, flagged, in
    # round order after the canonical stream
    orphans = [dict(sh, shard_only=True)
               for ridx in sorted(set(shard_rounds) - seen_rounds)
               for _, sh in sorted(shard_rounds[ridx].items())]
    merged.extend(orphans)
    return merged, {"joined_rounds": joined,
                    "shard_only_rounds": len(orphans),
                    "dropped_shard_records": dropped,
                    "shards": sorted(int(k) for k in shard_records)}


def merge_path(ledger: str) -> tuple:
    """Everything found beside ``ledger`` merged: (merged records, rank
    stats, job stats, problems, found) where ``found`` is whether any
    rank or job shard exists."""
    canonical, problems = load_records(ledger)
    shards = discover_shards(ledger)
    shard_records = {}
    for k, spath in shards:
        recs, probs = load_records(spath)
        shard_records[k] = recs
        problems.extend(probs)
    job_shards = discover_job_shards(ledger)
    job_records = {}
    for j, jpath in job_shards:
        recs, probs = load_records(jpath)
        problems.extend(probs)
        # a spatial job's rank sub-shards join on round id within the
        # job before its stream is appended
        subs = discover_shards(jpath)
        if subs:
            sub_records = {}
            for k, spath in subs:
                srecs, sprobs = load_records(spath)
                sub_records[k] = srecs
                problems.extend(sprobs)
            recs, substats = merge_ledgers(recs, sub_records)
            print(f"job {j}: joined {len(subs)} process "
                  f"sub-shard(s), {substats['joined_rounds']} "
                  f"round(s) joined, "
                  f"{substats['shard_only_rounds']} shard-only")
        job_records[j] = recs
    merged, stats = merge_ledgers(canonical, shard_records)
    merged, job_stats = merge_job_shards(merged, job_records)
    return merged, stats, job_stats, problems, bool(shards or job_shards)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="merge per-rank ledger shards on round id")
    ap.add_argument("ledger",
                    help="canonical (rank-0) ledger path; shards are "
                         "found as <ledger>.p<k>.jsonl")
    ap.add_argument("-o", "--out", default=None,
                    help=f"output path (default <ledger>{MERGED_SUFFIX})")
    args = ap.parse_args(argv)
    merged, stats, job_stats, problems, found = merge_path(args.ledger)
    for p in problems:
        print(f"WARNING {p}", file=sys.stderr)
    if not found:
        print(f"{args.ledger}: no shards found (expected "
              f"{args.ledger}.p<k>.jsonl or .job<j>.jsonl) — "
              "nothing to merge")
        return 1
    out = args.out or (args.ledger + MERGED_SUFFIX)
    with open(out, "w") as f:
        for rec in merged:
            json.dump(rec, f, separators=(",", ":"))
            f.write("\n")
    traces = assemble_traces(merged)
    if traces:
        n_spans = sum(len(t["spans"]) for t in traces.values())
        n_orphans = sum(len(t["orphans"]) for t in traces.values())
        print(f"causal: {len(traces)} trace(s), {n_spans} span(s) "
              f"stitched, {n_orphans} orphan(s)")
        for tid, t in sorted(traces.items()):
            if t["orphans"]:
                print(f"WARNING causal trace {tid}: orphan span(s) "
                      f"{t['orphans']} (parent id missing from every "
                      "shard)", file=sys.stderr)
    print(f"{args.ledger} + shards p{stats['shards']} "
          f"+ jobs {job_stats['jobs']}: "
          f"{stats['joined_rounds']} round(s) joined, "
          f"{stats['shard_only_rounds']} shard-only, "
          f"{job_stats['job_records']} job record(s) appended, "
          f"{stats['dropped_shard_records']} non-round shard "
          f"record(s) dropped -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

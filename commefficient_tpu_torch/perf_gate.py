"""Cross-run performance regression gate over the port's ledgers.

Port of the reference's ``scripts/perf_gate.py``, the same flags for the
port's runs and the same exit codes::

    python -m commefficient_tpu_torch.perf_gate --ledger runs/a.jsonl \
        --write-baseline perf_baseline_torch.json   # capture a baseline
    python -m commefficient_tpu_torch.perf_gate --ledger runs/b.jsonl \
        --baseline perf_baseline_torch.json --check  # gate a fresh run
    python -m commefficient_tpu_torch.perf_gate --runs_dir runs --check \
        --baseline perf_baseline_torch.json          # gate the newest
                                                     # registered run

A baseline pins median + MAD per metric (host-span times, the
``--profile`` device-time buckets, bench values); ``--check`` exits 1
only outside a noise band of ``max(rel_tol x median, k x MAD)``
(``telemetry/gate.py``). ``--write-baseline`` over an existing baseline
first gates the new run against it and refuses (exit 1) to
re-baseline over a hard regression unless ``--force`` is given.

Baselines are topology-keyed: the run's ``(device_count,
process_count)``, from its manifest, its ledger's meta record, or
``--device_count``/``--process_count``, selects the entry that gates
it, and ``--write-baseline`` replaces only that entry. The wire dtype,
async buffer, overlap depth and DP budget come from the manifest or
the meta record. Records are checked with the port's
``telemetry/record.py`` ``validate_record``; invalid ones are skipped
with a warning. The reference's baseline file is its own: pass the
port's with ``--baseline``.

Host-side JSON work only: nothing here touches a device.
"""

import argparse
import json
import os
import sys

from commefficient_tpu_torch.telemetry import gate, registry
from commefficient_tpu_torch.telemetry.record import validate_record

#: the port's baseline file name (not committed: a builder's run is not
#: a yardstick)
DEFAULT_BASELINE = "perf_baseline_torch.json"


def load_ledger_records(path):
    records = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                print(f"WARNING {path}:{lineno}: not JSON, skipped",
                      file=sys.stderr)
                continue
            if validate_record(rec):
                print(f"WARNING {path}:{lineno}: invalid record, "
                      "skipped", file=sys.stderr)
                continue
            records.append(rec)
    return records


def resolve_topology(manifest=None, records=(), device_count=None,
                     process_count=None, mesh_shape=None,
                     wire_dtype=None, async_k=None,
                     overlap_depth=None, band=None, dp_epsilon=None,
                     service_jobs=None):
    """The run's baseline key parts (device_count, process_count,
    mesh_shape, wire_dtype, async_k, overlap_depth, band, dp_epsilon,
    service_jobs), as the reference's gate resolves them: the
    arguments win, then the run manifest, then the ledger's meta
    record (its ``num_devices``, ``process_count``, ``mesh_shape`` and
    round ``plan``). f32, synchronous, serial, static and solo runs
    resolve to None in their part (the bare key); a DP run with no
    budget keys ``p0``. All-None counts gate under ``any``."""
    dc, pc = device_count, process_count
    ms = parse_mesh_shape(mesh_shape)
    wd = wire_dtype
    ak = async_k
    od = overlap_depth
    bd = band
    de = dp_epsilon
    sj = service_jobs
    if manifest is not None:
        mdc, mpc = registry.run_topology(manifest)
        dc = mdc if dc is None else dc
        pc = mpc if pc is None else pc
        if ms is None:
            ms = registry.run_mesh_shape(manifest)
        if wd is None:
            wd = registry.run_wire_dtype(manifest)
        if ak is None:
            ak = registry.run_async_k(manifest)
        if od is None:
            od = registry.run_overlap_depth(manifest)
        if bd is None:
            bd = registry.run_band(manifest)
        if de is None:
            de = registry.run_dp_epsilon(manifest)
        if sj is None:
            sj = registry.run_service_jobs(manifest)
    if dc is None or pc is None or ms is None or wd is None \
            or ak is None or od is None or bd is None \
            or de is None:
        for rec in records:
            if rec.get("kind") != "meta":
                continue
            if dc is None and rec.get("num_devices") is not None:
                dc = int(rec["num_devices"])
                if pc is None:
                    pc = int(rec.get("process_count") or 1)
            elif pc is None and rec.get("process_count") is not None:
                pc = int(rec["process_count"])
            if ms is None and isinstance(rec.get("mesh_shape"), dict):
                ms = dict(rec["mesh_shape"])
            plan = rec.get("plan") or {}
            if wd is None:
                cost = rec.get("cost_model") or {}
                if plan.get("mode") == "sketch":
                    wd = plan.get("sketch_dtype")
                elif cost.get("wire_dtype"):
                    wd = cost.get("wire_dtype")
            if ak is None and plan.get("async_buffer_size"):
                ak = int(plan["async_buffer_size"])
            if od is None and plan.get("overlap_depth"):
                od = int(plan["overlap_depth"])
            if bd is None and isinstance(plan.get("autopilot"), dict):
                bd = plan["autopilot"].get("band") or None
            if de is None and isinstance(plan.get("dp"), dict):
                # 0.0 is a real budget (unlimited) — "or None" would
                # erase the p0 fragment and let a DP ledger resolve
                # the noiseless pin
                eps = plan["dp"].get("epsilon_budget")
                de = float(eps) if eps is not None else 0.0
            if sj is None and rec.get("service_jobs") is not None:
                sj = int(rec["service_jobs"])
            if (dc is not None and pc is not None
                    and ms is not None and wd is not None
                    and ak is not None and od is not None
                    and bd is not None and de is not None):
                break
    if wd == "f32":
        wd = None  # historical unsuffixed key
    if not ak:
        ak = None  # synchronous runs keep the historical key
    if not od or int(od) <= 1:
        od = None  # serial rounds keep the historical key
    if not bd:
        bd = None  # static-knob runs keep the unbanded key
    if not sj or int(sj) <= 1:
        sj = None  # solo / single-job-daemon runs keep the bare key
    return dc, pc, ms, wd, ak, od, bd, de, sj


def parse_mesh_shape(mesh_shape):
    """"CxM" -> {"clients": C, "model": M}; dicts/None pass through."""
    if mesh_shape is None or isinstance(mesh_shape, dict):
        return mesh_shape
    c, m = (int(p) for p in str(mesh_shape).lower().split("x"))
    return {"clients": c, "model": m}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="perf regression gate over telemetry ledgers")
    ap.add_argument("--ledger", default=None,
                    help="run ledger (JSONL) to gate / baseline")
    ap.add_argument("--runs_dir", default=None,
                    help="discover the newest manifest-registered "
                         "ledger under this directory instead of "
                         "--ledger")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON (default "
                         f"{DEFAULT_BASELINE})")
    ap.add_argument("--check", action="store_true",
                    help="gate the run against --baseline; exit 1 on "
                         "any hard regression")
    ap.add_argument("--write-baseline", metavar="PATH", nargs="?",
                    const=DEFAULT_BASELINE, default=None,
                    help="write the run's metrics as the new baseline "
                         "(refused over a hard regression vs the "
                         "existing one unless --force)")
    ap.add_argument("--force", action="store_true",
                    help="re-baseline even over a regression")
    ap.add_argument("--rel_tol", type=float, default=gate.REL_TOL,
                    help="relative tolerance component of the noise "
                         f"band (default {gate.REL_TOL})")
    ap.add_argument("--mad_k", type=float, default=gate.MAD_K,
                    help="MAD multiples component of the noise band "
                         f"(default {gate.MAD_K})")
    ap.add_argument("--json", default=None,
                    help="dump the verdict (or captured metrics) to "
                         "this path")
    ap.add_argument("--device_count", type=int, default=None,
                    help="override the run's device count for "
                         "baseline keying (normally read from the "
                         "manifest / ledger meta)")
    ap.add_argument("--process_count", type=int, default=None,
                    help="override the run's process count for "
                         "baseline keying")
    args = ap.parse_args(argv)

    ledger = args.ledger
    manifest = None
    if ledger is None and args.runs_dir:
        hits = registry.latest_ledgers(args.runs_dir, n=1)
        if not hits:
            print(f"no manifest-registered ledgers under "
                  f"{args.runs_dir}")
            return 1
        mpath, manifest, ledger = hits[0]
        # the run's topology key is printed with its metrics below
        print(f"run: {mpath} (config {manifest.get('config_hash', '')[:8]}, "
              f"git {manifest.get('git_sha', '')[:8]}) -> {ledger}")
    if ledger is None:
        ap.error("one of --ledger / --runs_dir is required")

    records = load_ledger_records(ledger)
    metrics = gate.metrics_from_records(records)
    if not metrics:
        print(f"{ledger}: no gateable metrics (empty ledger?)")
        return 1
    dc, pc, ms, wd, ak, od, bd, de, sj = resolve_topology(
        manifest, records, args.device_count, args.process_count)
    topo = gate.topology_key(dc, pc, ms, wd, ak, od, bd, de, sj)
    print(f"{ledger}: {len(metrics)} metric(s) extracted "
          f"(topology {topo})")
    chash = (manifest or {}).get("config_hash", "")

    # a run that resized mid-run (elastic resume onto a different
    # topology) has a ledger that mixes rounds measured under
    # DIFFERENT topologies — no single baseline entry is a valid pin
    # for it, in either direction
    if manifest is not None and registry.run_topology_changed(manifest):
        segs = registry.run_segments(manifest)
        chain = " -> ".join(
            gate.topology_key(s.get("device_count"),
                              s.get("process_count"),
                              s.get("mesh_shape"), wd, ak, od, bd,
                              de, sj)
            for s in segs)
        print(f"perf gate: REFUSED — run resumed across a mid-run "
              f"topology change ({len(segs)} segments: {chain}); its "
              "metrics span topologies and never resolve to one "
              "baseline pin. Gate each segment's own ledger instead.")
        if args.check or args.write_baseline:
            return 1
        return 0

    verdict = None
    existing = None
    # a write-only invocation gates against the file it is about to
    # overwrite; --check gates against the committed --baseline
    gate_path = (args.write_baseline
                 if args.write_baseline and not args.check
                 else args.baseline)
    if args.check or (args.write_baseline
                      and os.path.exists(gate_path)
                      and not args.force):
        if not os.path.exists(gate_path):
            print(f"baseline {gate_path} missing — capture one "
                  "with --write-baseline first")
            return 1
        existing = gate.load_baseline(gate_path)
        entry = gate.baseline_entry(existing, dc, pc, ms, wd, ak, od,
                                    bd, de, sj)
        if entry is None and args.write_baseline and not args.check:
            # first capture of a NEW topology point: nothing to gate
            # this run against, other points stay untouched
            print(f"baseline has no {topo} entry yet — capturing it")
        elif entry is None:
            print(f"perf gate: FAIL — baseline {args.baseline} has "
                  f"no {topo} entry (this topology point is ungated; "
                  "capture one with --write-baseline)")
            return 1
        else:
            if entry is not None and chash and \
                    entry.get("config_hash") and \
                    entry["config_hash"] != chash:
                print(f"WARNING: baseline {topo} entry was captured "
                      f"from config {entry['config_hash'][:8]}, run "
                      f"is {chash[:8]} — metrics may not be "
                      "comparable")
            verdict = gate.compare(existing, metrics,
                                   rel_tol=args.rel_tol,
                                   mad_k=args.mad_k,
                                   device_count=dc, process_count=pc,
                                   mesh_shape=ms, wire_dtype=wd,
                                   async_k=ak, overlap_depth=od,
                                   band=bd, dp_epsilon=de,
                                   service_jobs=sj)
            print(gate.render_verdict(verdict))

    if args.write_baseline:
        if verdict and verdict["regressions"] and not args.force:
            print(f"\nNOT writing {args.write_baseline}: "
                  f"{len(verdict['regressions'])} hard regression(s) "
                  "vs the existing baseline — fix them or pass "
                  "--force for an intentional trade-off")
            return 1
        if existing is None and os.path.exists(args.write_baseline):
            existing = gate.load_baseline(args.write_baseline)
        gate.save_baseline(
            gate.update_baseline(existing or {}, metrics,
                                 source=os.path.abspath(ledger),
                                 device_count=dc, process_count=pc,
                                 config_hash=chash, mesh_shape=ms,
                                 wire_dtype=wd, async_k=ak,
                                 overlap_depth=od, band=bd,
                                 dp_epsilon=de, service_jobs=sj),
            args.write_baseline)
        print(f"baseline[{topo}] -> {args.write_baseline}")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(verdict if verdict is not None else metrics, f,
                      indent=1, sort_keys=True)
        print(f"verdict -> {args.json}")

    if args.check and verdict and verdict["regressions"]:
        print(f"\nperf gate: FAIL "
              f"({len(verdict['regressions'])} regression(s))")
        return 1
    if args.check:
        print("\nperf gate: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run registry: self-describing manifests under ``runs/``.

Port of ``commefficient_tpu/telemetry/registry.py``. Every trainer run
that writes a ledger also drops one small JSON manifest (git sha,
config hash, torch version, backend and topology, the ledger path) so
a directory of runs is navigable without the launching shell history:

    runs/manifests/run_<utc-seconds>_<confighash8>.json

``python -m commefficient_tpu_torch.perf_gate --runs_dir`` picks
"latest vs baseline" through them. Manifests are written by process 0
only, and never by a run without ``--ledger`` or under ``--test``, so
``runs/`` stays free of every test run's files. The reader functions
(``run_*``, ``run_key``) read the reference's manifests and the
port's alike: the mesh, autopilot and fedservice fields they look for
are simply absent from the port's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

from commefficient_tpu_torch.telemetry import clock

MANIFEST_SCHEMA = 1
MANIFEST_DIR = "manifests"
MANIFEST_PREFIX = "run_"

#: Config fields that never change what the program computes — they
#: must not perturb the config hash (two reruns of one experiment
#: with different ledger paths are the SAME configuration)
_HASH_EXCLUDE = ("ledger", "telemetry_console", "use_tensorboard",
                 "do_profile", "clientstore_dir", "live_port",
                 "flightrec_rounds", "postmortem_dir", "causal_trace")


def config_dict(args) -> dict:
    """JSON-able view of a Config (or argparse namespace): scalar
    fields only, hash-excluded knobs dropped."""
    if dataclasses.is_dataclass(args):
        src = dataclasses.asdict(args)
    else:
        src = dict(getattr(args, "__dict__", {}) or {})
    return {k: v for k, v in sorted(src.items())
            if k not in _HASH_EXCLUDE
            and isinstance(v, (int, float, str, bool, type(None)))}


def config_hash(args) -> str:
    """SHA-256 of the sorted scalar config — the identity under which
    runs are comparable."""
    blob = json.dumps(config_dict(args), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def git_sha(cwd=None) -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd,
            capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except Exception:
        pass
    return ""


def _process_index() -> int:
    """This process's rank: ``torch.distributed``'s where it is
    initialised, else 0 (the only process)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def _environment() -> dict:
    """Where the run ran: torch's version (the reference records
    jax's), the backend (``gpu`` on a CUDA card, else ``cpu``), the
    device and process counts and the card's name."""
    env = {"python": sys.version.split()[0]}
    try:
        import torch
        import torch.distributed as dist
        env["torch_version"] = torch.__version__
        on_gpu = torch.cuda.is_available()
        env["backend"] = "gpu" if on_gpu else "cpu"
        env["device_count"] = (torch.cuda.device_count() if on_gpu
                               else 1)
        env["process_count"] = (
            int(dist.get_world_size())
            if dist.is_available() and dist.is_initialized() else 1)
        env["device_kind"] = (torch.cuda.get_device_name(0) if on_gpu
                              else "cpu")
    except Exception:
        pass
    return env


def run_topology(manifest: dict) -> tuple:
    """(device_count, process_count) of a run — the topology half of
    the comparability key. Pre-fleet manifests that never recorded
    the counts key as (None, None): they only ever compare against
    each other, never silently against a counted run."""
    dc = manifest.get("device_count")
    pc = manifest.get("process_count")
    return (int(dc) if dc is not None else None,
            int(pc) if pc is not None else None)


def run_mesh_shape(manifest: dict):
    """The run's recorded mesh layout ({axis: size} dict) or None —
    pre-mesh manifests and 1-D runs record nothing here."""
    shape = manifest.get("mesh_shape")
    return dict(shape) if isinstance(shape, dict) else None


def run_wire_dtype(manifest: dict):
    """The run's uplink wire dtype (``--sketch_dtype``) from its
    recorded config, or None for non-sketch / pre-quantization
    manifests — they only ever carried f32 on the wire. An autopilot
    run reports the dtype of the point the controller CONVERGED on
    (the recorded trajectory's ``final`` key): that is the wire the
    steady-state rounds — the ones a perf pin should describe —
    actually moved, so a walk that lands on int8 pins as
    ``...qint8b<lo-hi>``."""
    cfg = manifest.get("config") or {}
    if cfg.get("mode") != "sketch":
        return None
    ap = run_autopilot(manifest)
    final = (ap or {}).get("final") or ""
    if final:
        # variant keys are "<dtype>-k..-r..-c..-re.." (autopilot/
        # lattice.py key_str); the leading segment is the wire dtype
        return final.split("-", 1)[0] or None
    return cfg.get("sketch_dtype") or None


def run_async_k(manifest: dict):
    """The run's buffered-arrival buffer size
    (``--async_buffer_size``) from its recorded config, or None for
    synchronous / pre-async manifests — they all ran the barrier
    round."""
    cfg = manifest.get("config") or {}
    k = int(cfg.get("async_buffer_size") or 0)
    return k if k > 0 else None


def run_overlap_depth(manifest: dict):
    """The run's round-pipeline chunk depth (``--overlap_depth``)
    from its recorded config, or None for serial / pre-overlap
    manifests — depth 1 IS the serial round, so only depth > 1 keys a
    distinct experiment."""
    cfg = manifest.get("config") or {}
    if cfg.get("mode") != "sketch":
        return None
    n = int(cfg.get("overlap_depth") or 0)
    return n if n > 1 else None


def run_autopilot(manifest: dict):
    """The run's recorded autopilot trajectory block (band, ladder,
    per-round observations — the bit-exact replay input of
    the reference's ``autopilot.replay``), or None for
    static-knob / pre-autopilot manifests."""
    rec = manifest.get("autopilot")
    return rec if isinstance(rec, dict) else None


def run_band(manifest: dict):
    """The run's ``--autopilot_band LO:HI`` string, or None for
    static-knob manifests — the band half of the ``b<lo-hi>``
    topology fragment (telemetry/gate.py band_suffix)."""
    cfg = manifest.get("config") or {}
    if str(cfg.get("autopilot") or "off") != "on":
        return None
    return cfg.get("autopilot_band") or None


def run_dp_epsilon(manifest: dict):
    """The run's privacy budget (``--dp_epsilon``) from its recorded
    config when the run was differentially private (``--dp`` != off),
    or None for noiseless / pre-privacy manifests — the budget half
    of the ``p<eps>`` topology fragment (telemetry/gate.py
    privacy_suffix). 0.0 is a REAL return (DP on, unlimited budget):
    such a run keys ``p0``, never the bare noiseless key."""
    cfg = manifest.get("config") or {}
    if str(cfg.get("dp") or "off") == "off":
        return None
    return float(cfg.get("dp_epsilon") or 0.0)


def run_service_jobs(manifest: dict):
    """The number of jobs a fedservice daemon multiplexed for this
    run (``service_jobs``, stamped by the service/bench manifest
    writer), or None for solo / pre-service manifests — and for
    single-job daemon runs, which are bit-identical to the direct
    path and honestly share its key (telemetry/gate.py
    service_suffix)."""
    j = int(manifest.get("service_jobs") or 0)
    return j if j > 1 else None


def run_job_id(manifest: dict):
    """The job this manifest describes inside a fedservice daemon
    (``job_id``, stamped at admission), or None for non-service
    manifests. The job lineage key: ``latest_ledgers(job=...)``
    filters on it, so each tenant's run chain is navigable without
    grepping the shared runs/ directory."""
    job = manifest.get("job_id")
    return str(job) if job is not None else None


def run_segments(manifest: dict) -> list:
    """The run's per-topology segments (``topology_segments``, stamped
    by the trainers from checkpoint lineage for resumed runs). Empty
    for unresumed / pre-elastic manifests."""
    segs = manifest.get("topology_segments")
    return [s for s in segs if isinstance(s, dict)] \
        if isinstance(segs, list) else []


def run_topology_changed(manifest: dict) -> bool:
    """True when a resumed run crossed a topology boundary mid-run:
    its segments span more than one distinct (device_count,
    process_count, mesh_shape). Such a run's ledger mixes rounds
    measured under different topologies, so the perf gate must NEVER
    resolve it to a single baseline pin — gate each segment's own
    ledger instead (scripts/perf_gate.py refuses)."""
    keys = set()
    for s in run_segments(manifest):
        ms = s.get("mesh_shape")
        keys.add((s.get("device_count"), s.get("process_count"),
                  json.dumps(ms, sort_keys=True)
                  if isinstance(ms, dict) else None))
    return len(keys) > 1


def run_key(manifest: dict) -> tuple:
    """(config_hash, device_count, process_count): two runs are
    comparable — diffable by the report, gateable against one
    baseline entry — only when ALL three match. Config hash alone is
    not an identity: the same config on 1 vs 8 devices is a scaling
    experiment, not a regression. 2D-mesh runs append their
    ``m<C>x<M>`` fragment, quantized-wire runs their ``q<dtype>``
    fragment, buffered-arrival runs their ``a<K>`` fragment and
    chunk-pipelined runs their ``o<N>`` fragment and
    autopilot-controlled runs their ``b<lo-hi>`` fragment and
    differentially-private runs their ``p<eps>`` fragment (a 4x2 and
    an 8x1 program on the same chips — or an int8 and an f32 wire, or
    a buffered and a barrier round, or a depth-2 pipelined and a
    serial round, or a knob walk and a static program, or a noised
    table and a noiseless one — are different experiments) and
    multi-tenant fedservice runs their ``j<J>`` fragment (a pod
    interleaving J round programs is a different experiment from
    any solo run); 1-D f32
    synchronous serial static noiseless solo runs keep the historical
    3-tuple, so old manifests stay comparable to each other."""
    from commefficient_tpu_torch.telemetry.gate import (async_suffix,
                                                        band_suffix,
                                                        mesh_suffix,
                                                        overlap_suffix,
                                                        privacy_suffix,
                                                        service_suffix,
                                                        wire_suffix)
    key = (manifest.get("config_hash") or "",) + run_topology(manifest)
    suffix = (mesh_suffix(run_mesh_shape(manifest))
              + wire_suffix(run_wire_dtype(manifest))
              + async_suffix(run_async_k(manifest))
              + overlap_suffix(run_overlap_depth(manifest))
              + band_suffix(run_band(manifest))
              + privacy_suffix(run_dp_epsilon(manifest))
              + service_suffix(run_service_jobs(manifest)))
    return key + (suffix,) if suffix else key


def write_manifest(runs_dir: str = "runs", *, args=None,
                   ledger: str = "", bench: dict = None,
                   mesh_shape=None, extra: dict = None) -> str:
    """Write one run manifest; returns its path. ``bench`` is a dict
    of headline metrics ({metric: {"value", "unit", ...}} or any
    JSON-able shape); ``extra`` merges into the top level last."""
    chash = config_hash(args) if args is not None else ""
    rec = {
        "schema": MANIFEST_SCHEMA,
        "kind": "run_manifest",
        "ts": clock.wall(),
        "git_sha": git_sha(),
        "config_hash": chash,
        "config": config_dict(args) if args is not None else {},
        "argv": list(sys.argv),
        "ledger": os.path.abspath(ledger) if ledger else "",
        "bench": bench or {},
        "mesh_shape": (dict(mesh_shape)
                       if isinstance(mesh_shape, dict) else mesh_shape),
    }
    rec.update(_environment())
    if rec.get("ledger") and (rec.get("process_count") or 1) > 1:
        # every other rank's ledger shard (reference :285-289)
        from commefficient_tpu_torch.telemetry.sinks import \
            shard_ledger_path
        rec["ledger_shards"] = [
            shard_ledger_path(rec["ledger"], k)
            for k in range(1, rec["process_count"])]
    if extra:
        rec.update(extra)
    out_dir = os.path.join(runs_dir, MANIFEST_DIR)
    os.makedirs(out_dir, exist_ok=True)
    name = f"{MANIFEST_PREFIX}{int(rec['ts'])}_{chash[:8] or 'nocfg'}"
    path = os.path.join(out_dir, name + ".json")
    # same-second rerun of the same config: keep both manifests
    n = 1
    while os.path.exists(path):
        path = os.path.join(out_dir, f"{name}.{n}.json")
        n += 1
    # tmp + rename: a writer killed mid-dump must never leave a
    # half-written manifest at the canonical name (list_manifests
    # skips unparseable files, but a torn manifest would silently
    # drop the run from the registry; the orphaned .tmp is inert)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def maybe_write_manifest(args, **kw):
    """Trainer/bench entry point: a manifest when (and only when) the
    run wrote a ledger, from process 0, never under ``--test`` smoke.
    Failures degrade to a warning — observability must not fail the
    run it observes."""
    ledger = str(getattr(args, "ledger", "") or "")
    if not ledger or getattr(args, "do_test", False):
        return None
    if _process_index() != 0:
        return None
    try:
        return write_manifest(args=args, ledger=ledger, **kw)
    except Exception as e:  # noqa: BLE001 — observability only
        print(f"WARNING: run manifest not written "
              f"({type(e).__name__}: {e})")
        return None


def list_manifests(runs_dir: str = "runs") -> list:
    """All readable manifests under ``runs_dir``, oldest first.
    Returns [(path, manifest_dict), ...]; unparseable files are
    skipped."""
    out_dir = os.path.join(runs_dir, MANIFEST_DIR)
    if not os.path.isdir(out_dir):
        return []
    out = []
    for name in sorted(os.listdir(out_dir)):
        if not (name.startswith(MANIFEST_PREFIX)
                and name.endswith(".json")):
            continue
        path = os.path.join(out_dir, name)
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if rec.get("kind") == "run_manifest":
            out.append((path, rec))
    out.sort(key=lambda pr: pr[1].get("ts", 0.0))
    return out


def latest_ledgers(runs_dir: str = "runs", n: int = 2,
                   key: tuple = None, job: str = None) -> list:
    """The newest ``n`` manifests whose ledger file still exists,
    newest FIRST: [(manifest_path, manifest, ledger_path), ...].

    ``key`` (a ``run_key`` tuple) restricts hits to comparable runs —
    the report/gate pass the newest run's key so "latest vs previous"
    never pairs different configs or topologies. ``job`` restricts
    hits to one fedservice tenant's lineage (manifests whose
    ``job_id`` matches), so a shared runs/ directory answers "this
    job's latest ledger" without pairing two tenants' runs."""
    hits = []
    for path, rec in reversed(list_manifests(runs_dir)):
        ledger = rec.get("ledger") or ""
        if not (ledger and os.path.exists(ledger)):
            continue
        if key is not None and run_key(rec) != tuple(key):
            continue
        if job is not None and run_job_id(rec) != str(job):
            continue
        hits.append((path, rec, ledger))
        if len(hits) >= n:
            break
    return hits

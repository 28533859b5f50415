"""Pluggable ledger sinks.

Port of ``commefficient_tpu/telemetry/sinks.py``: ``JSONLSink`` (the
run ledger, torn-tail recovery, the single-writer claim a path, resume
deduplication), ``TensorBoardSink``, ``ConsoleSink`` and the job
service's shard helpers (``job_ledger_path`` :39,
``job_index_of_ledger`` :51, ``recover_ledger_shards`` :62) and the
per-process shard path (``shard_ledger_path`` :29). Every sink has
``write(record)`` and ``close()`` and ignores the record kinds it does
not use. In the port a shard is a rank: rank ``k`` of a mesh run (one
process a card, parallel/mesh.py) writes ``<ledger>.p<k>.jsonl``, where
the reference's process ``k`` is a JAX host; ``python -m
commefficient_tpu_torch.telemetry.merge LEDGER`` joins them on round id.
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading

import numpy as np

from commefficient_tpu_torch.telemetry.record import make_summary_record

#: lock-confinement declaration: the JSONLSink two-writer guard is a
#: process-wide class dict — a job service opening per-job shards from
#: worker threads races the check-then-claim, so claim and eviction
#: hold ``_live_lock``.
_LOCK_MAP = {"_live": "_live_lock"}


def shard_ledger_path(path: str, process_index: int) -> str:
    """Per-rank ledger path: rank 0 owns the canonical ``path``; rank
    k writes the ``<path>.p<k>.jsonl`` shard that ``telemetry/merge.py``
    joins back on round id. Namespacing by rank means two ranks pointed
    at the same ``--ledger`` never interleave writes into one file."""
    k = int(process_index)
    return path if k == 0 else f"{path}.p{k}.jsonl"


def job_ledger_path(path: str, job_index: int) -> str:
    """Per-job ledger path under a job service: job ``j``'s records go
    to the ``<path>.job<j>.jsonl`` shard. Namespacing by job index
    keeps J concurrent jobs pointed at one ``--ledger`` from ever
    interleaving writes into one file — the shard file IS the job
    identity, so the records themselves stay byte-identical to a solo
    run's."""
    return f"{path}.job{int(job_index)}.jsonl"


def job_index_of_ledger(path: str):
    """The job index a ledger shard path encodes (``<base>.job<j>
    .jsonl`` → ``j``), or None for a canonical path — the live plane
    derives its ``job`` metric label from this, since the shard file
    IS the job identity and records carry no job stamp."""
    m = re.search(r"\.job(\d+)\.jsonl(?:\.p\d+\.jsonl)?$",
                  str(path or ""))
    return int(m.group(1)) if m else None


def recover_ledger_shards(path: str) -> dict:
    """Sweep a canonical ledger path AND every sibling shard (the
    ``.job<j>`` job shards, and ``.p<k>`` process shards) through
    :func:`recover_torn_tail`.

    Returns ``{shard_path: bytes_dropped}`` for shards that lost a
    torn tail (empty when everything was clean). ``JSONLSink``
    recovers its own file at open, but a job service restarted after
    a SIGKILL may never re-admit the tenant that owned a torn shard —
    this sweep runs at service start so no orphaned torn tail
    survives."""
    if not path:
        return {}
    candidates = [path]
    candidates += sorted(
        set(glob.glob(glob.escape(path) + ".job*.jsonl")
            + glob.glob(glob.escape(path) + ".p*.jsonl")))
    dropped = {}
    for p in candidates:
        if not os.path.isfile(p):
            continue
        n = recover_torn_tail(p)
        if n:
            dropped[p] = n
    return dropped


def recover_torn_tail(path: str) -> int:
    """Truncate a JSONL file's torn last line in place, if any.

    A writer killed mid-write (SIGKILL, power loss) can leave a
    partial final line. Every complete line ends with ``\\n`` and
    parses as JSON; anything after the last newline — or a final
    newline-terminated line that does not parse — is the torn tail.
    Returns the number of bytes dropped (0 for a clean file)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0
    if size == 0:
        return 0
    with open(path, "rb+") as f:
        # scan back from EOF for the last complete line boundary
        f.seek(0, os.SEEK_END)
        end = f.tell()
        f.seek(max(0, end - 1))
        keep = end
        if f.read(1) != b"\n":
            # no trailing newline: drop everything past the previous
            # one (the whole file, if it is a single torn line)
            chunk = min(end, 1 << 16)
            f.seek(end - chunk)
            tail = f.read(chunk)
            nl = tail.rfind(b"\n")
            keep = end - chunk + nl + 1 if nl >= 0 else 0
        if keep != end:
            f.truncate(keep)
    return size - keep


def last_round_index(path: str):
    """Max round id among a ledger's round records (None when the
    file is missing/empty/has no round records). Unparseable lines
    are skipped — read-side torn tolerance."""
    last = None
    try:
        f = open(path)
    except OSError:
        return None
    with f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("kind") == "round":
                r = rec.get("round")
                if r is not None and (last is None or r > last):
                    last = int(r)
    return last


class JSONLSink:
    """One JSON object per line, appended to ``path``; each record is
    serialised to its full line FIRST, then written with a single
    ``write`` + flush — a crash between records leaves a clean file,
    and a crash mid-write leaves at most one torn tail, which the
    append-open truncates away (``recover_torn_tail``).

    ``resume_after``: round records with ``round`` <= this id are
    silently dropped — the resume path replays from the last
    checkpoint, and bit-exact replay would otherwise duplicate the
    rounds the previous run already recorded (pass
    ``last_round_index(path)`` to keep ledger round ids monotone and
    deduplicated across a crash/resume cycle). ``process``: every
    record is stamped with that rank, so a shard's records stay
    attributable after the merge."""

    #: absolute path -> the sink currently holding it in this process:
    #: a second writer on the same file would interleave its records
    #: between the first writer's write() calls, producing a ledger
    #: no reader can attribute (and, under two flush cadences, torn
    #: half-lines). Refusing at open time turns the silent corruption
    #: into an immediate error; close() releases the claim. A
    #: registered sink whose underlying file handle is already closed
    #: is a *dead* writer (crash/resume path) — it can never write
    #: again, so its claim is evicted rather than honoured.
    _live = {}
    _live_lock = threading.Lock()

    def __init__(self, path: str, process=None, resume_after=None):
        self.path = path
        self.process = None if process is None else int(process)
        self.resume_after = (None if resume_after is None
                             else int(resume_after))
        abspath = os.path.abspath(path)
        self._f = None
        self._abspath = abspath
        # claim under the lock BEFORE opening: two threads racing the
        # unlocked check-then-claim would both pass the prior check
        # and both open the file — the exact interleaving the guard
        # exists to refuse
        with JSONLSink._live_lock:
            prior = JSONLSink._live.get(abspath)
            # a claimed prior with _f None is mid-__init__ (close()
            # and a failed open both drop the claim) — still live
            if prior is not None and (prior._f is None
                                      or not prior._f.closed):
                raise RuntimeError(
                    f"ledger {path} already has a live JSONLSink in "
                    "this process — two writers on one path would "
                    "interleave torn records. Close the first sink")
            JSONLSink._live[abspath] = self
        try:
            parent = os.path.dirname(abspath)
            os.makedirs(parent, exist_ok=True)
            recover_torn_tail(path)
            self._f = open(path, "a")
        except BaseException:
            with JSONLSink._live_lock:
                if JSONLSink._live.get(abspath) is self:
                    del JSONLSink._live[abspath]
            raise

    def write(self, rec):
        if self.resume_after is not None \
                and rec.get("kind") == "round" \
                and rec.get("round") is not None \
                and int(rec["round"]) <= self.resume_after:
            return
        if self.process is not None:
            rec = dict(rec, process=self.process)
        line = json.dumps(rec, separators=(",", ":"),
                          default=_json_default) + "\n"
        self._f.write(line)
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
            with JSONLSink._live_lock:
                if JSONLSink._live.get(self._abspath) is self:
                    del JSONLSink._live[self._abspath]


def _json_default(obj):
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)


class TensorBoardSink:
    """TensorBoard writer (the single home of what used to be
    duplicated ``make_summary_writer``/``write_epoch_scalars`` setup
    in cv_train/gpt2_train): epoch rows become per-epoch scalars,
    round records become per-round span/byte scalars. Uses torch's
    bundled SummaryWriter; degrades to a no-op with a warning when
    unavailable."""

    def __init__(self, logdir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            import warnings
            warnings.warn("tensorboard writer unavailable; "
                          "--tensorboard ignored")
            return
        self._writer = SummaryWriter(log_dir=logdir)

    def write(self, rec):
        if self._writer is None:
            return
        kind = rec.get("kind")
        if kind == "epoch":
            for key, val in rec["row"].items():
                if isinstance(val, (int, float, np.floating,
                                    np.integer)):
                    self._writer.add_scalar(key.replace(" ", "_"),
                                            float(val), rec["epoch"])
            self._writer.flush()
        elif kind == "round":
            step = rec["round"]
            for name, secs in rec["spans"].items():
                self._writer.add_scalar(f"round/{name}_ms",
                                        1e3 * float(secs), step)
            for key in ("uplink_bytes", "downlink_bytes"):
                if rec.get(key) is not None:
                    self._writer.add_scalar(f"round/{key}",
                                            float(rec[key]), step)

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class ConsoleSink:
    """End-of-run summary on stdout: per-span totals/means, byte
    totals, prefetch hit rate, compile events — the quick look that
    previously required reassembling three log formats."""

    def __init__(self, out=None):
        self._out = out
        self.rounds = 0
        self.spans = {}
        self.counters = {}
        self.uplink = 0.0
        self.downlink = 0.0
        self.alarms = {}

    def write(self, rec):
        if rec.get("kind") != "round":
            return
        self.rounds += 1
        for name, secs in rec["spans"].items():
            self.spans[name] = self.spans.get(name, 0.0) + secs
        for name, n in rec["counters"].items():
            self.counters[name] = self.counters.get(name, 0) + n
        self.uplink += rec.get("uplink_bytes") or 0.0
        self.downlink += rec.get("downlink_bytes") or 0.0
        for alarm in rec.get("alarms") or []:
            rule = str(alarm.get("rule"))
            self.alarms[rule] = self.alarms.get(rule, 0) + 1

    def summary(self) -> dict:
        n = max(self.rounds, 1)
        rec = make_summary_record(
            rounds=self.rounds,
            uplink_mib=round(self.uplink / 2**20, 3),
            downlink_mib=round(self.downlink / 2**20, 3),
            span_total_s={k: round(v, 4)
                          for k, v in sorted(self.spans.items())},
            span_mean_ms={k: round(1e3 * v / n, 3)
                          for k, v in sorted(self.spans.items())},
            counters=dict(sorted(self.counters.items())),
        )
        if self.alarms:
            rec["alarm_fired"] = dict(sorted(self.alarms.items()))
        return rec

    def close(self):
        if not self.rounds:
            return
        import sys
        out = self._out or sys.stdout
        s = self.summary()
        print("== telemetry summary "
              f"({s['rounds']} rounds) ==", file=out)
        print(f"  comm: up {s['uplink_mib']} MiB, "
              f"down {s['downlink_mib']} MiB", file=out)
        for name in s["span_total_s"]:
            print(f"  span {name}: total {s['span_total_s'][name]} s, "
                  f"mean {s['span_mean_ms'][name]} ms/round", file=out)
        if s["counters"]:
            print(f"  counters: {s['counters']}", file=out)
        if s.get("alarm_fired"):
            print(f"  alarms fired: {s['alarm_fired']}", file=out)

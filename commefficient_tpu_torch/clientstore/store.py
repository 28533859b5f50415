"""Host-resident client-state store (port of
``commefficient_tpu/clientstore/store.py``: ``_Field`` :38,
``HostClientStore`` :59-370, ``state_fields`` :379, ``state_row_bytes``
:396, ``resolve_clientstore`` :403, ``shard_range`` :418).

The device-resident path keeps every client's local-mode rows
(momentum velocity, error feedback, topk_down's stale weights) as dense
``(num_clients, *transmit_shape)`` tensors on the card, so its memory
caps the simulated population even though each round only touches the
W sampled participants. ``HostClientStore`` moves those rows off the
card: a fixed-budget numpy arena holds the hot rows, colder rows spill
to a file tier, and only the participating clients' rows are
on the card each round (gather -> H2D -> round -> D2H -> write-back,
runtime/fed_model.py). Rows stay numpy f32 on the host.

Several processes: each owns a contiguous block of client ids
(``shard_range``). ``gather`` returns zeros for rows the process does
not own and ``write`` drops them, so one sum over the processes'
gathers rebuilds every participant row.

The spill tier is the reference's file, one per field, (n_owned, *shape)
f32 rows, created sparse (``ftruncate``) when the first row spills. The
reference maps it with ``np.memmap``; the port reads and writes its rows
with ``os.preadv``/``os.pwrite`` instead (``_SpillFile``): on a sandbox
whose file system made a mapped file resident (gVisor over 9p), the
263 GB spill file of 10 000 ResNet9 clients ran the machine out of
memory.

The store is thread-safe (one re-entrant lock), so the
``StorePrefetcher`` worker can gather round N+1's rows while the main
thread writes back round N's.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Dict

import numpy as np

_DTYPE = np.float32


class _SpillFile:
    """One field's spill tier: (rows, *shape) f32 rows at
    ``row * row_bytes`` in a sparse file, written with ``os.pwrite`` and
    read into the caller's buffer with ``os.preadv`` (no memory map)."""

    def __init__(self, path, rows, shape):
        self.path = path
        self.shape = tuple(shape)
        self.row_bytes = int(np.prod(self.shape)) * np.dtype(_DTYPE).itemsize
        self.fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o600)
        os.ftruncate(self.fd, int(rows) * self.row_bytes)

    def __setitem__(self, row, value):
        buf = memoryview(np.ascontiguousarray(value, _DTYPE)).cast("B")
        pos, done = int(row) * self.row_bytes, 0
        while done < len(buf):
            done += os.pwrite(self.fd, buf[done:], pos + done)

    def read_into(self, row, out):
        """Row ``row`` into ``out`` (a C-contiguous f32 array of its
        shape)."""
        buf = memoryview(out).cast("B")
        pos, done = int(row) * self.row_bytes, 0
        while done < len(buf):
            got = os.preadv(self.fd, [buf[done:]], pos + done)
            if got <= 0:
                raise OSError(f"short read of spill row {row} in "
                              f"{self.path}")
            done += got

    def close(self):
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None


class _Field:
    """One named per-client state row: shape, optional init row."""

    def __init__(self, name, shape, init_row=None):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.elems = int(np.prod(self.shape)) if self.shape else 1
        self.init_row = None
        if init_row is not None:
            self.set_init(init_row)

    def set_init(self, row):
        row = np.asarray(row, dtype=_DTYPE).reshape(self.shape)
        self.init_row = np.array(row, copy=True)

    def default_row(self):
        if self.init_row is not None:
            return self.init_row
        return np.zeros(self.shape, dtype=_DTYPE)


class HostClientStore:
    """Shard-per-process client-state store with an mmap spill tier.

    Parameters
    ----------
    num_clients: total simulated population (global, all processes).
    fields: mapping ``name -> (row_shape, init_row_or_None)``.
    budget_bytes: arena budget for the in-memory (hot) tier.  Rows
        beyond the budget are evicted LRU-first to the memmap tier.
        A budget smaller than one row still works: every write goes
        straight to the spill tier.
    spill_dir: directory for the memmap files.  Defaults to a private
        temp dir removed on ``close()``.
    owned: half-open ``(lo, hi)`` range of client ids this process
        persists.  Defaults to the full population.
    """

    def __init__(self, num_clients, fields, budget_bytes=1 << 30,
                 spill_dir=None, owned=None):
        self.num_clients = int(num_clients)
        self.fields = OrderedDict(
            (name, _Field(name, shape, init_row))
            for name, (shape, init_row) in fields.items())
        self.owned = (0, self.num_clients) if owned is None else (
            int(owned[0]), int(owned[1]))
        if not (0 <= self.owned[0] <= self.owned[1] <= self.num_clients):
            raise ValueError(f"owned range {self.owned} outside "
                             f"[0, {self.num_clients})")
        self.budget_bytes = int(budget_bytes)

        self.row_bytes = sum(f.elems for f in self.fields.values()) * \
            np.dtype(_DTYPE).itemsize
        n_owned = self.owned[1] - self.owned[0]
        arena_rows = (self.budget_bytes // self.row_bytes
                      if self.row_bytes else 0)
        self.arena_rows = int(min(arena_rows, n_owned))

        # hot tier: one (arena_rows, *shape) array per field; slots are
        # shared across fields (slot i of every field belongs to the
        # same client).  np.zeros is lazily paged-in on Linux, so a
        # large budget costs no RSS until rows are actually written.
        self._arena = {name: np.zeros((self.arena_rows,) + f.shape, _DTYPE)
                       for name, f in self.fields.items()}
        self._lru: "OrderedDict[int, int]" = OrderedDict()  # cid -> slot
        self._free = list(range(self.arena_rows - 1, -1, -1))
        self._in_spill: set = set()   # cids whose current row is spilled
        self._spill = None            # name -> _SpillFile, created lazily
        self._spill_dir = spill_dir
        self._tmpdir = None
        self._spill_paths = []

        self._lock = threading.RLock()
        self._version = 0
        self._row_version: Dict[int, int] = {}
        # asyncfed issue stamps: client id -> round index at which its
        # participant snapshot was issued into the arrival queue.
        # Bookkeeping only (no row data): lets tests/telemetry check a
        # buffered fold consumed the snapshot version it was issued
        # with, not a later write-back's.
        self._issue_round: Dict[int, int] = {}
        self._closed = False
        # seconds spent writing rows into the spill tier (evictions and
        # a zero-row arena's writes): the host store's round breakdown
        self.spill_s = 0.0

        self.stats = {
            "evictions": 0,
            "spill_rows": 0,        # rows currently in the mmap tier
            "resident_rows": 0,     # rows currently in the arena
            "resident_rows_max": 0,
            "gathers": 0,
            "writes": 0,
        }

    # ------------------------------------------------------------------
    @property
    def field_names(self):
        return list(self.fields)

    def owns(self, cid):
        return self.owned[0] <= int(cid) < self.owned[1]

    def row_version(self, cid):
        with self._lock:
            return self._row_version.get(int(cid), 0)

    def stamp_rounds(self, ids, round_index):
        """Version-stamp participant snapshots at issue time: the
        asyncfed driver records which round issued each client into
        the arrival queue (the snapshot the buffered fold will
        replay)."""
        r = int(round_index)
        with self._lock:
            for cid in np.asarray(ids).reshape(-1):
                self._issue_round[int(cid)] = r

    def stamped_round(self, cid):
        """The round index that last issued ``cid`` (-1 = never)."""
        with self._lock:
            return self._issue_round.get(int(cid), -1)

    def export_stamps(self):
        """``(ids, rounds)`` int64 arrays of every issue-round stamp,
        for checkpointing: the asyncfed staleness bookkeeping must
        survive a resume along with the arrival backlog it audits.
        Stamps cover the full issued cohort on every process (the
        driver stamps before ownership filtering), so one process's
        export is the global view."""
        with self._lock:
            ids = np.asarray(sorted(self._issue_round), np.int64)
            rounds = np.asarray([self._issue_round[int(i)]
                                 for i in ids], np.int64)
        return ids, rounds

    def import_stamps(self, ids, rounds):
        """Inverse of :meth:`export_stamps` (checkpoint restore)."""
        with self._lock:
            self._issue_round = {
                int(i): int(r)
                for i, r in zip(np.asarray(ids).reshape(-1),
                                np.asarray(rounds).reshape(-1))}

    @property
    def version(self):
        with self._lock:
            return self._version

    def set_init_row(self, name, row):
        """(Re)define a field's unwritten-row value — used on resume so
        never-participating clients keep the ORIGINAL run's init."""
        with self._lock:
            self.fields[name].set_init(row)

    # ------------------------------------------------------------------
    def _ensure_spill(self):
        if self._spill is not None:
            return
        if self._spill_dir:
            os.makedirs(self._spill_dir, exist_ok=True)
            base = self._spill_dir
        else:
            self._tmpdir = tempfile.mkdtemp(prefix="clientstore_")
            base = self._tmpdir
        n_owned = max(1, self.owned[1] - self.owned[0])
        self._spill = {}
        for name, f in self.fields.items():
            path = os.path.join(base, f"spill_{name}.dat")
            # sparse until rows are actually evicted
            self._spill[name] = _SpillFile(path, n_owned, f.shape)
            self._spill_paths.append(path)

    def _evict_one(self):
        """Push the LRU arena row to the spill tier; return its slot."""
        cid, slot = self._lru.popitem(last=False)
        t0 = time.perf_counter()
        self._ensure_spill()
        off = cid - self.owned[0]
        for name in self.fields:
            self._spill[name][off] = self._arena[name][slot]
        self.spill_s += time.perf_counter() - t0
        self._in_spill.add(cid)
        self.stats["evictions"] += 1
        return slot

    def _read_row_into(self, cid, out, i):
        """Copy client ``cid``'s current row of every field into
        ``out[name][i]``.  Caller holds the lock."""
        slot = self._lru.get(cid)
        if slot is not None:
            self._lru.move_to_end(cid)
            for name in self.fields:
                out[name][i] = self._arena[name][slot]
        elif cid in self._in_spill:
            off = cid - self.owned[0]
            for name in self.fields:
                dst = out[name][i]
                if dst.flags.c_contiguous:
                    self._spill[name].read_into(off, dst)
                else:
                    row = np.empty(self.fields[name].shape, _DTYPE)
                    self._spill[name].read_into(off, row)
                    out[name][i] = row
        else:
            for name, f in self.fields.items():
                out[name][i] = f.default_row()

    # ------------------------------------------------------------------
    def gather(self, ids, out=None):
        """Materialize rows for ``ids`` (host-side).

        Returns ``(rows, version)`` where ``rows`` maps field name to a
        ``(len(ids), *shape)`` f32 array and ``version`` is the store's
        write version at snapshot time (used by the prefetcher to patch
        rows written after an async gather started).  Ids outside the
        owned range come back as zeros — the multi-process exchange sums
        the per-process gathers, so exactly one process contributes
        each row's real value.
        """
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        with self._lock:
            if self._closed:
                raise RuntimeError("HostClientStore is closed")
            n = len(ids)
            rows = {}
            for name, f in self.fields.items():
                buf = None if out is None else out.get(name)
                if (buf is None or buf.shape != (n,) + f.shape
                        or buf.dtype != _DTYPE):
                    buf = np.empty((n,) + f.shape, dtype=_DTYPE)
                rows[name] = buf
            for i, cid in enumerate(ids):
                cid = int(cid)
                if not self.owns(cid):
                    for name in self.fields:
                        rows[name][i] = 0.0
                else:
                    self._read_row_into(cid, rows, i)
            self.stats["gathers"] += 1
            return rows, self._version

    def write(self, ids, rows):
        """Write back rows for ``ids``; non-owned ids are dropped.

        ``rows`` maps field name to a ``(len(ids), *shape)`` array.
        """
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        with self._lock:
            if self._closed:
                raise RuntimeError("HostClientStore is closed")
            self._version += 1
            for i, cid in enumerate(ids):
                cid = int(cid)
                if not self.owns(cid):
                    continue
                slot = self._lru.get(cid)
                if slot is None and self.arena_rows:
                    slot = (self._free.pop() if self._free
                            else self._evict_one())
                    self._lru[cid] = slot
                elif slot is not None:
                    self._lru.move_to_end(cid)
                if slot is not None:
                    for name in self.fields:
                        self._arena[name][slot] = rows[name][i]
                    self._in_spill.discard(cid)
                else:  # zero-row arena: straight to the spill tier
                    t0 = time.perf_counter()
                    self._ensure_spill()
                    off = cid - self.owned[0]
                    for name in self.fields:
                        self._spill[name][off] = rows[name][i]
                    self.spill_s += time.perf_counter() - t0
                    self._in_spill.add(cid)
                self._row_version[cid] = self._version
            self.stats["writes"] += 1
            self.stats["spill_rows"] = len(self._in_spill)
            self.stats["resident_rows"] = len(self._lru)
            self.stats["resident_rows_max"] = max(
                self.stats["resident_rows_max"], len(self._lru))

    # ------------------------------------------------------------------
    def written_ids(self):
        with self._lock:
            return np.array(sorted(set(self._lru) | self._in_spill),
                            dtype=np.int64)

    def export_shard(self):
        """Sparse snapshot of this process's shard for checkpointing:
        ``{"ids": (n,), "<field>": (n, *shape), "init:<field>": row}``
        (init rows only for fields that have one)."""
        with self._lock:
            ids = self.written_ids()
            rows, _ = self.gather(ids)
            shard = {"ids": ids}
            for name, arr in rows.items():
                shard[name] = arr
            for name, f in self.fields.items():
                if f.init_row is not None:
                    shard["init:" + name] = np.array(f.init_row)
            return shard

    def import_shard(self, shard):
        """Restore a snapshot produced by ``export_shard`` (owned rows
        only; foreign ids in a mismatched shard are dropped by
        ``write``)."""
        with self._lock:
            for name in self.fields:
                key = "init:" + name
                if key in shard:
                    self.fields[name].set_init(shard[key])
            ids = np.asarray(shard["ids"], dtype=np.int64)
            if len(ids):
                self.write(ids, {name: np.asarray(shard[name], _DTYPE)
                                 for name in self.fields})

    # ------------------------------------------------------------------
    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._spill is not None:
                for spill in self._spill.values():
                    spill.close()
                self._spill = None
            for path in self._spill_paths:
                try:
                    os.remove(path)
                except OSError:
                    pass
            if self._tmpdir is not None:
                try:
                    os.rmdir(self._tmpdir)
                except OSError:
                    pass
                self._tmpdir = None
            self._arena = {}
            self._lru.clear()
            self._in_spill.clear()

    def __del__(self):  # best-effort temp cleanup
        try:
            self.close()
        except Exception:
            pass


# ----------------------------------------------------------------------
# Config plumbing


def state_fields(cfg, init_weights=None):
    """Which per-client fields the mode/config combination needs, as a
    ``HostClientStore`` fields mapping.  Mirrors
    ``core.rounds.ClientStates.init``: velocities for local momentum,
    errors for local error feedback, stale weights for topk_down
    (initialized to the server weights)."""
    fields = OrderedDict()
    shape = tuple(int(s) for s in cfg.transmit_shape)
    if cfg.local_momentum > 0:
        fields["velocities"] = (shape, None)
    if cfg.error_type == "local":
        fields["errors"] = (shape, None)
    if getattr(cfg, "do_topk_down", False):
        fields["weights"] = ((int(cfg.grad_size),), init_weights)
    return fields


def state_row_bytes(cfg):
    """Bytes of per-client state one client costs under ``cfg``."""
    return sum(int(np.prod(shape)) if shape else 1
               for shape, _ in state_fields(cfg).values()) * \
        np.dtype(_DTYPE).itemsize


def resolve_clientstore(cfg, num_clients):
    """Resolve ``--clientstore auto`` to a concrete placement, the same
    build-time pattern as ``resolve_rot_lanes``/``resolve_fused_ce``:
    keep state on the card while the dense population fits the byte budget,
    spill to the host store beyond it."""
    mode = getattr(cfg, "clientstore", "device")
    if mode != "auto":
        return mode
    rb = state_row_bytes(cfg)
    if rb == 0:
        return "device"   # stateless combo: nothing to store
    budget = int(getattr(cfg, "clientstore_bytes", 1 << 30))
    return "host" if int(num_clients) * rb > budget else "device"


def shard_range(num_clients, process_index=None, process_count=None):
    """Contiguous client-id block ``[lo, hi)`` owned by a process: by
    default this process of ``torch.distributed``'s group where that is
    initialised, else process 0 of 1."""
    if process_index is None or process_count is None:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            process_index, process_count = (dist.get_rank(),
                                            dist.get_world_size())
        else:
            process_index, process_count = 0, 1
    per = -(-int(num_clients) // max(1, int(process_count)))
    lo = min(int(process_index) * per, int(num_clients))
    return lo, min(lo + per, int(num_clients))

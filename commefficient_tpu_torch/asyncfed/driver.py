"""The asynchronous round driver: issue cohorts, fold what has arrived.

Port of ``commefficient_tpu/asyncfed/driver.py`` (``AsyncRoundDriver``
:31-209), with its ``cohort_issue``/``arrival_dequeue`` causal spans
(:42-45, 74-90) under ``--causal_trace``. Host-side bookkeeping only. Each trainer step the driver issues the sampled cohort (every
slot gets an arrival delay from the attached arrival process; punctual
by default), then assembles the fold batch from up to K updates that
have arrived. The fold batch keeps the cohort width: arrived updates
fill the leading slots, the rest are dead (mask 0, id 0), which the
round's dead-slot handling already covers. The per-slot staleness
(fold step minus issue step) goes to the round's weighted fold.

Simulation model (the reference's): a stale client's gradient is
computed when its fold runs; arrival timing, weighting and byte
accounting are exact.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import numpy as np

from commefficient_tpu_torch.asyncfed.queue import ArrivalQueue

# delays(round_index, n) -> np.ndarray of per-slot arrival delays
ArrivalProcess = Callable[[int, int], np.ndarray]


class AsyncRoundDriver:
    """The buffered-arrival front end of ``FedModel.__call__``.
    ``stamp(ids, issue_round)``, where given (the host client store's
    ``stamp_rounds``), records the round that issued each client."""

    def __init__(self, cfg, stamp: Optional[Callable] = None):
        self.k = int(cfg.async_buffer_size)
        self.num_workers = int(cfg.num_workers)
        assert 0 < self.k <= self.num_workers
        self.queue = ArrivalQueue()
        self._arrival: Optional[ArrivalProcess] = None
        self._stamp = stamp
        # optional CausalTracer (--causal_trace), attached by FedModel:
        # cohort_issue / arrival_dequeue spans nest under the enclosing
        # async_fold telemetry span
        self.causal = None
        self._fold = 0
        self.issued_total = 0
        self.folded_total = 0
        self.last_stats: Dict[str, float] = {}

    def attach_arrival_process(self,
                               fn: Optional[ArrivalProcess]) -> None:
        """A seeded arrival schedule (tests and scripts; runs keep the
        punctual default)."""
        self._arrival = fn

    def step(self, batch: dict):
        """Issue ``batch``'s cohort, then assemble this fold's batch from
        up to K arrived updates. Returns ``(fold_batch, staleness)``,
        ``staleness`` float32 (num_workers,), 0 on dead pad slots."""
        now = self._fold
        ids = np.asarray(batch["client_ids"])
        W = ids.shape[0]
        if self._arrival is not None:
            delays = np.maximum(
                np.asarray(self._arrival(now, W)), 0).astype(np.int64)
        else:
            delays = np.zeros((W,), np.int64)
        if self._stamp is not None:
            self._stamp(ids, now)
        causal = self.causal
        ctx = (causal.span("cohort_issue") if causal is not None
               else contextlib.nullcontext())
        with ctx:
            for i in range(W):
                self.queue.push(now + int(delays[i]), {
                    "issue": now,
                    "slot": {k: np.asarray(v)[i] for k, v in batch.items()},
                })
            self.issued_total += W
        ctx = (causal.span("arrival_dequeue") if causal is not None
               else contextlib.nullcontext())
        with ctx:
            arrived = self.queue.pop_arrived(now, self.k)
        self.folded_total += len(arrived)
        fold_batch = self._assemble(arrived, batch)
        staleness = np.zeros((self.num_workers,), np.float32)
        for i, e in enumerate(arrived):
            staleness[i] = float(now - e["issue"])
        self._note_stats(arrived, staleness)
        self._fold = now + 1
        return fold_batch, staleness

    def _assemble(self, arrived: List[dict], template: dict) -> dict:
        """The (num_workers, ...) host batch: arrived slots first, then
        dead padding (mask 0, id 0), which the round's state writes and
        the byte accounting skip."""
        W = self.num_workers
        out = {}
        for key, v in template.items():
            v = np.asarray(v)
            rows = [np.asarray(e["slot"][key]) for e in arrived]
            pad = W - len(rows)
            if pad:
                zero = np.zeros_like(v[0])
                rows.extend([zero] * pad)
            out[key] = np.stack(rows).astype(v.dtype)
        if len(arrived) < W:
            # the padding is dead whatever the template's mask holds
            mask = out["mask"].copy()
            mask[len(arrived):] = 0
            out["mask"] = mask
        return out

    def export_state(self) -> dict:
        """The driver as host arrays: the arrival heap in (arrive_at,
        seq) order (timing columns int64, per-slot rows stacked per batch
        key) and the fold, seq and total counters; the checkpoint's
        ``asyncfed`` keys (runtime/checkpoint.py)."""
        entries, next_seq = self.queue.snapshot()
        keys = sorted(entries[0][2]["slot"]) if entries else []
        return {
            "fold": int(self._fold),
            "seq": int(next_seq),
            "issued_total": int(self.issued_total),
            "folded_total": int(self.folded_total),
            "slot_keys": keys,
            "arrive_at": np.asarray([t for t, _, _ in entries], np.int64),
            "issue_seq": np.asarray([s for _, s, _ in entries], np.int64),
            "issue": np.asarray([e["issue"] for _, _, e in entries],
                                np.int64),
            "slots": {k: np.stack([np.asarray(e["slot"][k])
                                   for _, _, e in entries])
                      for k in keys},
        }

    def import_state(self, state: dict) -> None:
        """Inverse of ``export_state``: the heap and counters rebuilt in
        place, entry order and seq values as saved, so the resumed folds
        are the uninterrupted run's."""
        self._fold = int(state["fold"])
        self.issued_total = int(state["issued_total"])
        self.folded_total = int(state["folded_total"])
        keys = list(state["slot_keys"])
        arrive_at = np.asarray(state["arrive_at"], np.int64)
        issue_seq = np.asarray(state["issue_seq"], np.int64)
        issue = np.asarray(state["issue"], np.int64)
        entries = []
        for i in range(arrive_at.shape[0]):
            entry = {"issue": int(issue[i]),
                     "slot": {k: np.asarray(state["slots"][k][i])
                              for k in keys}}
            entries.append((int(arrive_at[i]), int(issue_seq[i]), entry))
        self.queue.restore(entries, int(state["seq"]))

    def peek_next_ids(self) -> Optional[np.ndarray]:
        """The next fold's gather ids (fold-slot order, dead slots id 0),
        the host store's prefetch feed, where the backlog already holds a
        full buffer: the next issue cannot preempt entries that have
        arrived (they sort first), so the prediction is exact. None
        otherwise; the caller then takes the sampler's lookahead, and a
        wrong guess is a prefetch miss (a synchronous gather)."""
        nxt = self.queue.peek_arrived(self._fold, self.k)
        if len(nxt) < self.k:
            return None
        ids = np.zeros((self.num_workers,), np.int64)
        for i, e in enumerate(nxt):
            ids[i] = int(e["slot"]["client_ids"])
        return ids

    def _note_stats(self, arrived: List[dict],
                    staleness: np.ndarray) -> None:
        n = len(arrived)
        s = staleness[:n] if n else np.zeros((0,), np.float32)
        hist = (np.bincount(s.astype(np.int64), minlength=1) if n
                else np.zeros(1, np.int64))
        self.last_stats = {
            "async_buffer_occupancy": n / float(self.k),
            "async_backlog": float(len(self.queue)),
            "async_staleness_mean": float(s.mean()) if n else 0.0,
            "async_staleness_max": float(s.max()) if n else 0.0,
            "async_staleness_hist": [int(c) for c in hist],
        }

    def round_stats(self) -> Dict[str, float]:
        """The last fold's statistics: buffer occupancy, backlog, the
        staleness mean, max and histogram."""
        return dict(self.last_stats)

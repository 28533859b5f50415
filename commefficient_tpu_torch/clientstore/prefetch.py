"""Double-buffered background gather for the host client store (port
of ``commefficient_tpu/clientstore/prefetch.py``, ``StorePrefetcher``
:40-182).

The trainer knows round N+1's participant ids one round ahead
(``FedSampler.peek_next_client_ids``), so one worker thread can stage
their rows while round N runs on the card, hiding the host gather
behind device time.

Two staging buffer sets alternate between consecutive submits, so the
consumer can still be uploading buffer A while the worker fills buffer
B. With ``pin=True`` (a CUDA run) the buffers are page-locked, allocated
once per shape, so the upload of the rows ``take`` returns can be
``non_blocking``: a pageable copy is synchronous and slow. A failed pin
raises; nothing falls back to pageable memory. Correctness does not
depend on the prediction: ``take`` checks that the ids match, patches
any row written after the gather's snapshot (store write versions), and
returns ``None`` on a miss, where the caller gathers synchronously.

One thing the port adds: ``settle`` waits for the staged gathers to
finish. The write-back calls it first, so a staged gather always reads
the store before the round's write-back lands, whatever the thread
timing: a gather touches its rows in the arena's LRU, so the order of
the two decides which rows the write-back evicts. The reference leaves
that order to the threads (its ``evictions`` count moves with it).
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time

import numpy as np


logger = logging.getLogger("commefficient_tpu_torch.clientstore.prefetch")

#: transient shard-read retry policy: GATHER_TRIES total attempts,
#: exponential backoff with +-50% jitter between them. A one-off NFS
#: hiccup or page-cache miss recovers invisibly; a persistent failure
#: still surfaces (as the per-job error on take()) after
#: GATHER_TRIES attempts, so a dead disk cannot silently stall a run.
GATHER_TRIES = 3
GATHER_BACKOFF_S = 0.05


class StorePrefetcher:
    def __init__(self, store, name="clientstore-prefetch", pin=False):
        self._store = store
        self._pin = bool(pin)
        self._jobs: "queue.Queue" = queue.Queue()
        self._done: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._pending = 0
        # staged gathers submitted and finished, under _settled
        self._submitted = 0
        self._gathered = 0
        self._settled = threading.Condition()
        self._buffers = [{}, {}]
        self._buf_i = 0
        self.hits = 0
        self.misses = 0
        # exception that killed the worker LOOP (vs a per-job gather
        # error, which rides the done-queue): re-raised on the main
        # thread at the next submit/take — the next round boundary —
        # instead of the thread dying silently and every later take()
        # stalling out its timeout
        self._failure = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    # ------------------------------------------------------------------
    def _run(self):
        try:
            while not self._stop.is_set():
                try:
                    job = self._jobs.get(timeout=0.1)
                except queue.Empty:
                    continue
                if job is None:
                    return
                ids, buf = job
                try:
                    rows, version = self._gather_with_retry(ids, buf)
                    self._done.put((ids, rows, version, None))
                except BaseException as exc:  # surfaced by take()
                    self._done.put((ids, None, 0, exc))
                finally:
                    with self._settled:
                        self._gathered += 1
                        self._settled.notify_all()
        except BaseException as exc:
            self._failure = exc

    def _gather_with_retry(self, ids, buf):
        """``store.gather`` with bounded retry: transient shard-read
        failures (OSError/IOError from a file-backed store) get
        GATHER_TRIES attempts with jittered exponential backoff
        before the error rides the done-queue to the caller.
        Non-I/O errors (a real bug) are never retried."""
        delay = GATHER_BACKOFF_S
        for attempt in range(GATHER_TRIES):
            try:
                return self._store.gather(ids, out=buf)
            except OSError as exc:
                if attempt + 1 >= GATHER_TRIES:
                    raise
                jittered = delay * (0.5 + random.random())
                logger.warning(
                    "transient clientstore gather failure "
                    "(attempt %d/%d, retrying in %.3fs): %s",
                    attempt + 1, GATHER_TRIES, jittered, exc)
                time.sleep(jittered)
                delay *= 2

    def _fail_for_test(self, exc):
        """Chaos-harness hook (data/chaos.kill_prefetch_worker):
        mark the worker loop dead exactly as an escaped exception
        would, so tests can exercise the death-surfacing path
        without racing a real thread crash."""
        self._failure = exc
        self._stop.set()
        self._jobs.put(None)

    def _check_failure(self):
        if self._failure is not None:
            raise RuntimeError(
                "clientstore prefetch worker died; round state may be "
                "stale") from self._failure

    # ------------------------------------------------------------------
    def submit(self, ids):
        """Stage an async gather for next round's participant ids."""
        self._check_failure()
        if self._stop.is_set():
            return
        ids = np.array(ids, dtype=np.int64).reshape(-1)
        buf = self._buffers[self._buf_i]
        self._buf_i ^= 1
        staging_buffers(self._store, len(ids), self._pin, buf)
        self._pending += 1
        with self._settled:
            self._submitted += 1
        self._jobs.put((ids, buf))

    def settle(self, timeout=60.0):
        """Wait until every staged gather has read the store (a dead or
        stopped worker, or ``timeout``, ends the wait: ``take`` patches
        the rows written after a gather's snapshot either way)."""
        deadline = time.monotonic() + timeout
        with self._settled:
            while self._gathered < self._submitted:
                left = deadline - time.monotonic()
                if left <= 0 or self._stop.is_set() \
                        or not self._thread.is_alive():
                    return
                self._settled.wait(min(left, 0.1))

    def take(self, ids, timeout=60.0):
        """Rows for ``ids`` if a staged gather matches, else ``None``.

        Drains stale jobs (mispredicted or skipped rounds) until a
        matching one is found; patches rows the store wrote after the
        job's version snapshot so the result is always current.
        """
        self._check_failure()  # a dead worker surfaces even with an
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)  # empty backlog
        deadline = time.monotonic() + timeout
        while self._pending > 0:
            self._check_failure()
            try:
                # short poll, not one big blocking get: a dead worker
                # must surface within ~0.1s, not after `timeout`
                job_ids, rows, version, exc = self._done.get(
                    timeout=0.1)
            except queue.Empty:
                if not self._thread.is_alive():
                    self._check_failure()
                    return None  # worker exited cleanly (close())
                if time.monotonic() >= deadline:
                    return None  # worker wedged: fall back sync
                continue
            self._pending -= 1
            if exc is not None:
                raise exc
            if len(job_ids) != len(ids) or \
                    not np.array_equal(job_ids, ids):
                self.misses += 1
                continue
            stale = [i for i, cid in enumerate(job_ids)
                     if self._store.row_version(int(cid)) > version]
            if stale:
                fresh, _ = self._store.gather(job_ids[stale])
                for name in rows:
                    rows[name][stale] = fresh[name]
            self.hits += 1
            return rows
        return None

    # ------------------------------------------------------------------
    def close(self, timeout=5.0):
        """Stop the worker and join it; idempotent, never hangs the
        caller past ``timeout`` even with staged jobs un-taken."""
        self._stop.set()
        self._jobs.put(None)
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    def __del__(self):
        try:
            self.close(timeout=0.5)
        except Exception:
            pass


def staging_buffers(store, n, pin, bufs=None):
    """``bufs`` (a dict, filled in place) holding a (n, *shape) f32
    numpy array for each of ``store``'s fields, reused while the shape
    holds. With ``pin`` each is the numpy view of a page-locked torch
    tensor (the view keeps it alive), allocated once per shape;
    ``torch.empty(..., pin_memory=True)`` raises where it cannot pin."""
    import torch
    bufs = {} if bufs is None else bufs
    for name, f in store.fields.items():
        shape = (int(n),) + f.shape
        cur = bufs.get(name)
        if cur is not None and cur.shape == shape:
            continue
        bufs[name] = (torch.empty(shape, dtype=torch.float32,
                                  pin_memory=True).numpy()
                      if pin else np.empty(shape, np.float32))
    return bufs

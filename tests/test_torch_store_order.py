"""The host store's eviction order does not depend on thread timing.

A staged prefetch gather touches its rows in the arena's LRU, so
whether it reads the store before or after the round's write-back
decides which rows the write-back evicts: in the failing case of
``test_host_store_round_matches_jax_host_store[true-topk-local-momentum]``
(a 2-row arena) a late gather gives 3 evictions where an early one
gives 2, in either package. The port's write-back first waits for the
staged gathers (``StorePrefetcher.settle``), so a gather the thread
starts late gives the early gather's stats and rows, and the JAX
package's stats of an early gather.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import threading
import time

import numpy as np
import pytest

import test_torch_clientstore_round as rounds_test
from commefficient_tpu_torch.clientstore import prefetch as tpre
from commefficient_tpu_torch.clientstore import store as tstore
from commefficient_tpu_torch.clientstore.prefetch import StorePrefetcher
from commefficient_tpu_torch.clientstore.store import HostClientStore
from test_torch_modes import CASES, make_rounds

NAME = "true-topk-local-momentum"


def _run(monkeypatch, delay_s):
    """The case's three host-store rounds on the port, every staged
    (background) gather started ``delay_s`` late: (stats, rows)."""
    (case,) = [c for c in CASES if c[0] == NAME]
    _, kw, d, W, num_clients, dead = case
    seed, kw = rounds_test._case(NAME, kw, W)
    rs = make_rounds(seed, d, W, num_clients, dead)
    w0 = (np.random.RandomState(seed + 1).randn(d) * 0.5).astype(np.float32)
    gather = HostClientStore.gather

    def late(self, ids, out=None):
        if threading.current_thread() is not threading.main_thread():
            time.sleep(delay_s)
        return gather(self, ids, out)

    monkeypatch.setattr(tstore.HostClientStore, "gather", late)
    _, model = rounds_test.run_port(kw, d, w0, rs, num_clients, "host")
    stats = dict(model.client_store.stats)
    rows = rounds_test._store_rows(model)
    model.finalize()
    monkeypatch.setattr(tstore.HostClientStore, "gather", gather)
    return stats, rows


def test_a_late_prefetch_gather_moves_no_eviction(monkeypatch):
    early, early_rows = _run(monkeypatch, 0.0)
    late, late_rows = _run(monkeypatch, 0.3)
    assert early["evictions"] == 2
    assert late == early
    for name in early_rows:
        np.testing.assert_array_equal(late_rows[name], early_rows[name])


class _BlockingStore:
    """A store whose gather waits for ``release``."""
    fields = {}

    def __init__(self):
        self.release = threading.Event()

    def gather(self, ids, out=None):
        self.release.wait(5)
        return {}, 0

    def row_version(self, cid):
        return 0


def test_settle_waits_for_the_staged_gathers(monkeypatch):
    monkeypatch.setattr(tpre, "staging_buffers", lambda *a, **k: {})
    store = _BlockingStore()
    pre = StorePrefetcher(store)
    try:
        pre.submit([1, 2])
        t0 = time.monotonic()
        pre.settle(timeout=0.3)
        assert time.monotonic() - t0 >= 0.25   # still gathering
        store.release.set()
        pre.settle(timeout=5)
        assert pre._gathered == pre._submitted == 1
        assert pre.take([1, 2]) == {}
    finally:
        pre.close()
    # a stopped worker ends the wait at once
    pre.submit([3])
    t0 = time.monotonic()
    pre.settle(timeout=5)
    assert time.monotonic() - t0 < 1


def _jax_gathers_first(monkeypatch):
    """The JAX store's write-back held until its staged gather has read
    the store: the order its threads usually take, made certain."""
    from commefficient_tpu.clientstore import prefetch as jpre
    from commefficient_tpu.clientstore import store as jstore
    S, P = jstore.HostClientStore, jpre.StorePrefetcher
    gather, write, submit = S.gather, S.write, P.submit
    staged, gathered = [False], threading.Event()

    def submit_(self, ids):
        staged[0] = True
        gathered.clear()
        return submit(self, ids)

    def gather_(self, ids, out=None):
        rows = gather(self, ids, out)
        if threading.current_thread() is not threading.main_thread():
            gathered.set()
        return rows

    def write_(self, ids, rows):
        if staged[0]:
            assert gathered.wait(30), "the JAX prefetch never gathered"
        staged[0] = False
        return write(self, ids, rows)

    monkeypatch.setattr(S, "gather", gather_)
    monkeypatch.setattr(S, "write", write_)
    monkeypatch.setattr(P, "submit", submit_)


@pytest.mark.parametrize("delay_s", [0.0, 0.2])
def test_late_gather_matches_the_jax_store_stats(monkeypatch, delay_s):
    """The port's stats, its gather count too, equal the JAX store's
    with the JAX thread gathering first."""
    (case,) = [c for c in CASES if c[0] == NAME]
    _, kw, d, W, num_clients, dead = case
    seed, kw = rounds_test._case(NAME, kw, W)
    rs = make_rounds(seed, d, W, num_clients, dead)
    w0 = (np.random.RandomState(seed + 1).randn(d) * 0.5).astype(np.float32)
    with monkeypatch.context() as m:
        _jax_gathers_first(m)
        _, jm = rounds_test.run_jax_host(kw, d, w0, rs, num_clients)
        want = dict(jm.client_store.stats)
        jm.finalize()
    got, _ = _run(monkeypatch, delay_s)
    assert want["evictions"] == 2
    assert got == want

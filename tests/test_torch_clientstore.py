"""The port's host client store and its prefetcher on the CPU.

- ``HostClientStore`` against the JAX package's, op for op on the same
  seeded numpy rows: gathers and writes through LRU eviction, the mmap
  spill tier, a budget below one row (every write straight to spill),
  owned ranges, init rows, stamps, ``export_shard``/``import_shard``,
  exact; ``close`` removes the temporary spill directory.
- ``state_fields``, ``state_row_bytes``, ``resolve_clientstore`` and
  ``shard_range`` against the reference's.
- ``StorePrefetcher``: a take after a submit, the version patch of a row
  written after the gather started, a miss, ``FlakyStore``'s transient
  failures retried (a streak of 2 recovers, 3 surfaces), and
  ``kill_prefetch_worker`` making ``take`` raise.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import os

import numpy as np
import pytest

from commefficient_tpu import clientstore as ref
from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu_torch import clientstore as port
from commefficient_tpu_torch.clientstore.prefetch import staging_buffers
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.data.chaos import (ChaosConfig, FlakyStore,
                                                kill_prefetch_worker)

FIELDS = {"velocities": ((3, 4), None),
          "weights": ((5,), np.arange(5, dtype=np.float32) * 0.5)}
ROW_BYTES = (12 + 5) * 4

# (case, num_clients, budget in rows, owned range or None)
STORE_CASES = [
    ("roomy", 12, 100, None),
    ("evicting", 12, 3, None),
    ("one-row", 9, 1, None),
    ("below-one-row", 9, 0.5, None),
    ("owned-range", 16, 2, (4, 11)),
]


def _ops(seed, num_clients, n_ops=40):
    """A seeded sequence of ("write", ids, rows) / ("gather", ids)."""
    rs = np.random.RandomState(seed)
    ops = []
    for _ in range(n_ops):
        ids = rs.choice(num_clients, rs.randint(1, 5), replace=False)
        if rs.rand() < 0.5:
            rows = {name: rs.randn(len(ids), *shape).astype(np.float32)
                    for name, (shape, _) in FIELDS.items()}
            ops.append(("write", ids, rows))
        else:
            ops.append(("gather", ids))
    return ops


def _pair(num_clients, budget_rows, owned, tmp_path):
    kw = dict(budget_bytes=int(budget_rows * ROW_BYTES), owned=owned)
    return (port.HostClientStore(num_clients, FIELDS,
                                 spill_dir=str(tmp_path / "port"), **kw),
            ref.HostClientStore(num_clients, FIELDS,
                                spill_dir=str(tmp_path / "ref"), **kw))


@pytest.mark.parametrize("case,num_clients,budget_rows,owned", STORE_CASES,
                         ids=[c[0] for c in STORE_CASES])
def test_store_matches_reference_op_for_op(case, num_clients, budget_rows,
                                           owned, tmp_path):
    ours, theirs = _pair(num_clients, budget_rows, owned, tmp_path)
    assert ours.arena_rows == theirs.arena_rows
    for i, op in enumerate(_ops(sum(map(ord, case)), num_clients)):
        if op[0] == "write":
            ours.write(op[1], op[2])
            theirs.write(op[1], op[2])
        else:
            (a, va), (b, vb) = ours.gather(op[1]), theirs.gather(op[1])
            assert va == vb, i
            for name in FIELDS:
                np.testing.assert_array_equal(a[name], b[name],
                                              err_msg=f"op {i} {name}")
        for cid in range(num_clients):
            assert ours.row_version(cid) == theirs.row_version(cid)
    assert ours.stats == theirs.stats
    np.testing.assert_array_equal(ours.written_ids(), theirs.written_ids())
    if budget_rows < num_clients:
        assert ours.stats["evictions"] > 0 or ours.arena_rows == 0
        assert ours.stats["spill_rows"] > 0
    # export/import: a fresh store of each restores the other's shard
    shard, want = ours.export_shard(), theirs.export_shard()
    assert set(shard) == set(want)
    for key in want:
        np.testing.assert_array_equal(shard[key], want[key], err_msg=key)
    back_ours, back_theirs = _pair(num_clients, budget_rows, owned,
                                   tmp_path / "back")
    back_ours.import_shard(want)
    back_theirs.import_shard(shard)
    everyone = np.arange(num_clients)
    a, b = back_ours.gather(everyone)[0], theirs.gather(everyone)[0]
    c = back_theirs.gather(everyone)[0]
    for name in FIELDS:
        np.testing.assert_array_equal(a[name], b[name])
        np.testing.assert_array_equal(c[name], b[name])
    for s in (ours, theirs, back_ours, back_theirs):
        s.close()


def test_store_stamps_and_init_rows_match_reference(tmp_path):
    ours, theirs = _pair(8, 2, None, tmp_path)
    for s in (ours, theirs):
        s.stamp_rounds([3, 1, 6], 4)
        s.stamp_rounds([1], 7)
        s.set_init_row("weights", np.full(5, 2.0, np.float32))
    for a, b in zip(ours.export_stamps(), theirs.export_stamps()):
        np.testing.assert_array_equal(a, b)
    assert [ours.stamped_round(c) for c in range(8)] == \
        [theirs.stamped_round(c) for c in range(8)]
    fresh = port.HostClientStore(8, FIELDS)
    fresh.import_stamps(*theirs.export_stamps())
    assert fresh.stamped_round(1) == 7 and fresh.stamped_round(0) == -1
    np.testing.assert_array_equal(ours.gather([5])[0]["weights"],
                                  theirs.gather([5])[0]["weights"])
    fresh.close()
    ours.close()
    theirs.close()


def test_store_close_removes_its_temporary_spill_dir():
    store = port.HostClientStore(6, FIELDS, budget_bytes=0)
    store.write([1, 4], {name: np.ones((2,) + shape, np.float32)
                         for name, (shape, _) in FIELDS.items()})
    tmp = store._tmpdir
    assert tmp is not None and os.path.isdir(tmp)
    assert len(os.listdir(tmp)) == len(FIELDS)
    store.close()
    assert not os.path.exists(tmp)
    with pytest.raises(RuntimeError, match="closed"):
        store.gather([1])


CFG_CASES = [
    dict(mode="local_topk", error_type="local", local_momentum=0.9),
    dict(mode="local_topk", error_type="none", local_momentum=0.0),
    dict(mode="true_topk", error_type="virtual", local_momentum=0.9,
         do_topk_down=True),
    dict(mode="uncompressed", local_momentum=0.0, do_topk_down=True),
    dict(mode="sketch", error_type="virtual", local_momentum=0.0),
]


@pytest.mark.parametrize("kw", CFG_CASES,
                         ids=["-".join(map(str, c.values()))
                              for c in CFG_CASES])
def test_config_plumbing_matches_reference(kw):
    d = 6_584_000
    for store in ("device", "host", "auto"):
        ours = Config(device="cpu", clientstore=store, **kw)
        theirs = JaxConfig(clientstore=store, **kw)
        ours.grad_size = theirs.grad_size = d
        assert list(port.state_fields(ours)) == \
            list(ref.state_fields(theirs))
        assert port.state_row_bytes(ours) == ref.state_row_bytes(theirs)
        for n in (1, 10, 64, 10_000, 17_568):
            assert port.resolve_clientstore(ours, n) == \
                ref.resolve_clientstore(theirs, n)
    for n, i, c in ((10, 0, 1), (10, 1, 3), (17_568, 3, 4), (5, 7, 8)):
        assert port.shard_range(n, i, c) == ref.shard_range(n, i, c)
    assert port.shard_range(10) == (0, 10)


def test_auto_resolves_host_at_the_papers_populations():
    """ResNet9's 26.3 MB error row at 10 000 clients and GPT-2's
    497.8 MB at PersonaChat's 17 568 do not fit; 64 ResNet9 rows fit
    a 2 GiB budget."""
    cfg = Config(device="cpu", mode="local_topk", error_type="local",
                 local_momentum=0.0, clientstore="auto")
    cfg.grad_size = 6_584_000
    assert port.state_row_bytes(cfg) == 26_336_000
    assert port.resolve_clientstore(cfg, 10_000) == "host"
    assert port.resolve_clientstore(cfg.replace(clientstore_bytes=2 << 30),
                                    64) == "device"
    cfg.grad_size = 124_444_417
    assert port.resolve_clientstore(cfg, 17_568) == "host"


def _rows(n, value):
    return {name: np.full((n,) + shape, value, np.float32)
            for name, (shape, _) in FIELDS.items()}


def test_prefetch_take_after_submit_patches_later_writes():
    store = port.HostClientStore(10, FIELDS, budget_bytes=4 * ROW_BYTES)
    store.write([1, 2, 3], _rows(3, 1.0))
    pf = port.StorePrefetcher(store)
    pf.submit([3, 1])
    rows = pf.take([3, 1])
    assert pf.hits == 1
    np.testing.assert_array_equal(rows["velocities"], 1.0)
    # a write landing after the gather's snapshot is patched in
    gate = store._lock
    gate.acquire()  # hold the worker's gather until the write lands
    pf.submit([2, 5])
    store.write([2], _rows(1, 7.0))
    gate.release()
    rows = pf.take([2, 5])
    np.testing.assert_array_equal(rows["velocities"][0], 7.0)
    np.testing.assert_array_equal(rows["weights"][1],
                                  FIELDS["weights"][1])
    # a mispredicted round is a miss: take returns None
    pf.submit([4, 6])
    assert pf.take([6, 4]) is None and pf.misses == 1
    # the staging buffers are allocated once per shape and reused
    bufs = staging_buffers(store, 2, False)
    first = bufs["velocities"]
    assert staging_buffers(store, 2, False, bufs)["velocities"] is first
    pf.close()
    store.close()


@pytest.mark.parametrize("streak,recovers", [(2, True), (3, False)])
def test_prefetch_retries_transient_store_failures(streak, recovers,
                                                   monkeypatch):
    from commefficient_tpu_torch.clientstore import prefetch
    monkeypatch.setattr(prefetch, "GATHER_BACKOFF_S", 0.001)
    store = port.HostClientStore(6, FIELDS)
    store.write([0, 1], _rows(2, 3.0))
    # seed 2's schedule: the first draw hits, the next one misses
    flaky = FlakyStore(store, ChaosConfig(seed=2, shard_fail_prob=0.5,
                                          shard_fail_streak=streak))
    pf = port.StorePrefetcher(flaky)
    pf.submit([1, 0])
    if recovers:
        rows = pf.take([1, 0])
        np.testing.assert_array_equal(rows["velocities"], 3.0)
        assert flaky.failures == 2 and flaky.attempts == 3
    else:
        with pytest.raises(OSError, match="transient shard"):
            pf.take([1, 0])
        assert flaky.failures == 3
    pf.close()
    store.close()


def test_killed_prefetch_worker_makes_take_raise():
    store = port.HostClientStore(6, FIELDS)
    pf = port.StorePrefetcher(store)
    kill_prefetch_worker(pf)
    with pytest.raises(RuntimeError, match="prefetch worker died"):
        pf.take([1, 2])
    with pytest.raises(RuntimeError, match="prefetch worker died"):
        pf.submit([1, 2])
    pf.close()
    store.close()


def test_spill_tier_reads_and_writes_without_a_memory_map(monkeypatch,
                                                          tmp_path):
    """The spill file is read and written in place (``os.pwrite``,
    ``os.preadv``): mapping it made the whole file resident on a sandbox
    file system (gVisor over 9p). It stays sparse: 263 GB apparent for
    10 000 ResNet9 error rows, a few rows on disk."""
    def no_map(*a, **kw):
        raise AssertionError("the spill tier mapped its file")

    monkeypatch.setattr(np, "memmap", no_map)
    d = 6_584_000
    store = port.HostClientStore(10_000, {"errors": ((d,), None)},
                                 budget_bytes=4 * d,
                                 spill_dir=str(tmp_path))
    rows = np.arange(3 * d, dtype=np.float32).reshape(3, d)
    store.write([5, 9_999, 17], {"errors": rows})
    path = tmp_path / "spill_errors.dat"
    assert os.path.getsize(path) == 10_000 * d * 4
    assert os.stat(path).st_blocks * 512 < 4 * d * 4
    got, _ = store.gather([17, 9_999, 5, 3])
    np.testing.assert_array_equal(got["errors"][:3], rows[[2, 1, 0]])
    assert not got["errors"][3].any()
    assert store.stats["evictions"] == 2
    store.close()
    assert not path.exists()


def test_prefetch_stress_never_returns_a_stale_row():
    """More threads than cores, each with its own prefetcher on one
    store and its own clients, at a shortened switch interval: a
    row written after a submit is always the one its take returns
    (a lost update or an unpatched snapshot would return the older
    value)."""
    import sys
    import threading
    n_threads = 2 * (os.cpu_count() or 4)
    store = port.HostClientStore(4 * n_threads, FIELDS,
                                 budget_bytes=3 * ROW_BYTES)
    errors = []

    def worker(k):
        pf = port.StorePrefetcher(store)
        ids = [4 * k + j for j in range(3)]
        try:
            for value in range(1, 26):
                store.write(ids, _rows(3, value))
                pf.submit(ids)
                store.write(ids[:2], _rows(2, value + 0.5))
                rows = pf.take(ids)
                if rows is None:
                    rows, _ = store.gather(ids)
                got = rows["velocities"][:, 0, 0].tolist()
                if got != [value + 0.5, value + 0.5, value]:
                    errors.append((k, value, got))
        finally:
            pf.close()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    assert store.stats["writes"] == 2 * 25 * n_threads
    store.close()

"""The buffered asynchronous rounds (``--async_buffer_size``,
``commefficient_tpu_torch/asyncfed/``) against the JAX package, on the
CPU.

- ``ArrivalSchedule`` (data/chaos.py): every kind's trace and
  ``replay_stats`` equal the reference's, bit for bit.
- The queue and the driver, op for op against the reference's on the
  same batches and delays: fold batches, staleness, ``peek_next_ids``,
  ``round_stats``, the issue stamps and the ``export_state`` arrays;
  a port driver restored from the reference's export folds on as the
  reference does.
- The degenerate identity: K = cohort, alpha 0, punctual arrivals is
  the synchronous FedModel round bit for bit (weights, metrics and
  bytes), across modes and both state placements.
- The staleness-weighted fold against the reference's
  ``build_client_round(client_weights=True)`` under churny and bursty
  staleness, rtol 1e-5 / atol 1e-6 (the int8 wire's JAX round op by
  op, as tests/test_torch_quant_round.py runs it), and whole
  asynchronous FedModel runs against the
  reference's FedModel: weights within the same tolerance, every
  round's selected set and bytes equal. Pad slots write no client's
  row and bill client 0 nothing.
- ``--dp sketch``: ε after weighted rounds equals the reference
  accountant's.
- A resume mid-backlog equals the straight run bit for bit, and the
  archive's ``asyncfed`` meta and ``async*`` arrays equal the reference
  archive's on the same run.
- The config: the flags parse, and the reference's asserts fire.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.asyncfed import ArrivalQueue as JaxQueue
from commefficient_tpu.asyncfed import AsyncRoundDriver as JaxDriver
from commefficient_tpu.core.rounds import ClientStates as JaxStates
from commefficient_tpu.core.rounds import build_client_round as jax_client
from commefficient_tpu.data.chaos import ArrivalSchedule as JaxSchedule
from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.runtime import checkpoint as jax_checkpoint
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.runtime.fed_model import FedOptimizer as JaxFedOpt
from commefficient_tpu_torch.asyncfed import ArrivalQueue, AsyncRoundDriver
from commefficient_tpu_torch.config import Config, parse_args
from commefficient_tpu_torch.core.rounds import (ClientStates,
                                                 build_client_round)
from commefficient_tpu_torch.data.chaos import ArrivalSchedule
from commefficient_tpu_torch.runtime import checkpoint
from commefficient_tpu_torch.runtime.fed_model import FedModel, FedOptimizer

from test_modes import linear_loss, make_cfg
from test_torch_modes import torch_linear_loss

RTOL, ATOL = 1e-5, 1e-6
W, B, NUM_CLIENTS, ROUNDS, LR, ALPHA = 4, 3, 32, 6, 0.05, 0.5


# --- ArrivalSchedule ---------------------------------------------------


SCHEDULES = {
    "uniform": dict(),
    "churny": dict(max_delay=3, churn_frac=0.5),
    "bursty": dict(max_delay=4, burst_start_prob=0.5, burst_stop_prob=0.3,
                   drop_frac=0.5),
}


@pytest.mark.parametrize("kind", ArrivalSchedule.KINDS)
def test_arrival_schedules_replay_the_references_trace(kind):
    for seed in (0, 7):
        ours = ArrivalSchedule(kind, seed=seed, **SCHEDULES[kind])
        theirs = JaxSchedule(kind, seed=seed, **SCHEDULES[kind])
        trace = []
        for r, n in enumerate((6, 6, 4, 8, 6, 6, 5, 6)):
            got, want = ours(r, n), theirs(r, n)
            assert got.dtype == want.dtype == np.int64
            np.testing.assert_array_equal(got, want)
            trace.append(got)
        ours.reset()
        for n, want in zip((6, 6, 4, 8, 6, 6, 5, 6), trace):
            np.testing.assert_array_equal(ours.delays(n), want)
    # the reference's golden trace
    ch = ArrivalSchedule("churny", seed=7, max_delay=3, churn_frac=0.5)
    assert [ch.delays(6).tolist() for _ in range(2)] == [
        [1, 0, 3, 0, 0, 0], [1, 0, 0, 1, 1, 2]]


@pytest.mark.parametrize("alive", [
    [1.0, 0.5, 0.25, 1.0, 1.0, 0.75, 0.5, 1.0], [], [1.0, 1.0],
    [0.125, 0.5, 0.875]])
def test_replay_stats_equal_the_references(alive):
    assert ArrivalSchedule.replay_stats(alive, 8) == \
        JaxSchedule.replay_stats(alive, 8)


# --- the queue and the driver, op for op --------------------------------


def test_queue_op_for_op():
    ours, theirs = ArrivalQueue(), JaxQueue()
    rs = np.random.RandomState(3)
    for step in range(12):
        for _ in range(rs.randint(0, 4)):
            t = step + int(rs.randint(0, 3))
            ours.push(t, ("e", step, t))
            theirs.push(t, ("e", step, t))
        assert ours.peek_arrived(step) == theirs.peek_arrived(step)
        assert ours.peek_arrived(step, 2) == theirs.peek_arrived(step, 2)
        limit = int(rs.randint(1, 4))
        assert ours.pop_arrived(step, limit) == theirs.pop_arrived(step,
                                                                   limit)
        assert len(ours) == len(theirs)
        assert ours.snapshot() == theirs.snapshot()
    entries, seq = theirs.snapshot()
    restored = ArrivalQueue()
    restored.restore(entries, seq)
    assert restored.pop_arrived(99, 99) == theirs.pop_arrived(99, 99)


def _host_batch(rs, ids, d=5):
    n = rs.randint(0, B + 1, len(ids))
    mask = (np.arange(B)[None, :] < n[:, None]).astype(np.float32)
    return {"client_ids": np.asarray(ids, np.int32),
            "x": rs.randn(len(ids), B, d).astype(np.float32),
            "y": rs.randn(len(ids), B).astype(np.float32),
            "mask": mask}


def _same_export(a, b):
    assert set(a) == set(b)
    for key in a:
        if key == "slots":
            assert set(a[key]) == set(b[key])
            for k in a[key]:
                assert a[key][k].dtype == b[key][k].dtype, k
                np.testing.assert_array_equal(a[key][k], b[key][k])
        elif isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key])
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("kind,k", [("uniform", 2), ("churny", 2),
                                    ("churny", 4), ("bursty", 3)])
def test_driver_op_for_op_against_the_reference(kind, k):
    cfg = make_cfg(num_workers=W, async_buffer_size=k)
    stamps, jstamps = [], []
    ours = AsyncRoundDriver(Config(num_workers=W, async_buffer_size=k),
                            stamp=lambda ids, r: stamps.append(
                                (np.asarray(ids).tolist(), r)))
    theirs = JaxDriver(cfg, stamp=lambda ids, r: jstamps.append(
        (np.asarray(ids).tolist(), r)))
    ours.attach_arrival_process(ArrivalSchedule(kind, seed=5,
                                                **SCHEDULES[kind]))
    theirs.attach_arrival_process(JaxSchedule(kind, seed=5,
                                              **SCHEDULES[kind]))
    rs = np.random.RandomState(11)
    for step in range(10):
        if step == 5:
            # a port driver restored from the reference's export
            _same_export(ours.export_state(), theirs.export_state())
            restored = AsyncRoundDriver(
                Config(num_workers=W, async_buffer_size=k))
            restored.import_state(theirs.export_state())
            restored.attach_arrival_process(ours._arrival)
            restored._stamp = ours._stamp
            ours = restored
        batch = _host_batch(rs, rs.choice(NUM_CLIENTS, W, replace=False))
        fb, stale = ours.step(batch)
        jfb, jstale = theirs.step(batch)
        assert set(fb) == set(jfb)
        for key in fb:
            assert fb[key].dtype == jfb[key].dtype, key
            np.testing.assert_array_equal(fb[key], jfb[key])
        assert stale.dtype == jstale.dtype == np.float32
        np.testing.assert_array_equal(stale, jstale)
        assert ours.round_stats() == theirs.round_stats()
        peek, jpeek = ours.peek_next_ids(), theirs.peek_next_ids()
        assert (peek is None) == (jpeek is None)
        if peek is not None:
            np.testing.assert_array_equal(peek, jpeek)
        assert (ours.issued_total, ours.folded_total) == \
            (theirs.issued_total, theirs.folded_total)
    assert stamps == jstamps
    _same_export(ours.export_state(), theirs.export_state())


# --- FedModel runs -----------------------------------------------------


def make_rounds(seed, d, dead_round=2, lowest=0):
    """ROUNDS rounds of W clients drawn without repeats from a
    permutation of clients ``lowest``.. (client 0 among them by
    default), 1..B samples each; slot 1 of ``dead_round`` holds none."""
    rs = np.random.RandomState(seed)
    perm = lowest + rs.permutation(NUM_CLIENTS - lowest)
    rounds = []
    for r in range(ROUNDS):
        batch = _host_batch(rs, perm[r * W:(r + 1) * W], d)
        batch["mask"][batch["mask"].sum(1) == 0, 0] = 1.0
        if r == dead_round:
            batch["mask"][1] = 0.0
        rounds.append(batch)
    return rounds


def run_port(kw, d, w0, rounds, k=0, alpha=0.0, sched=None,
             store="device", stop=None, resume=None):
    cfg = make_port_cfg(kw, async_buffer_size=k,
                        async_staleness_weight=alpha, clientstore=store)
    model = FedModel(None, torch.from_numpy(w0.copy()),
                     lambda p, b, a: torch_linear_loss(p, b), cfg,
                     padded_batch_size=B)
    opt = FedOptimizer([{"lr": LR}], cfg, model=model)
    if sched is not None:
        model.attach_arrival_process(sched)
    if resume is not None:
        checkpoint.load_checkpoint(resume, model, opt)
    ids_of = [b["client_ids"] for b in rounds]
    model.attach_participant_feed(
        lambda: (ids_of[model.round_index + 1]
                 if model.round_index + 1 < len(ids_of) else None))
    out = []
    for batch in rounds[model.round_index:stop]:
        met = model(dict(batch))
        opt.step()
        out.append((model.ps_weights.numpy().copy(),
                    [np.asarray(m) for m in met],
                    model.last_updated.copy()))
    return out, model, opt


def make_port_cfg(kw, **extra):
    base = vars(make_cfg(**dict(kw, num_workers=W)))
    base.update(extra)
    fields = {f.name for f in dataclasses.fields(Config)}
    return Config(device="cpu", num_clients=NUM_CLIENTS,
                  **{k: v for k, v in base.items()
                     if k in fields and k not in ("device",
                                                  "num_clients")})


def run_jax(kw, d, w0, rounds, k, alpha, sched, stop=None):
    cfg = dataclasses.replace(
        make_cfg(**dict(kw, num_workers=W)), num_clients=NUM_CLIENTS,
        async_buffer_size=k, async_staleness_weight=alpha)
    cfg.grad_size = d
    model = JaxFedModel(None, {"p": jnp.asarray(w0)},
                        lambda p, b, a: linear_loss(p["p"], b), cfg,
                        padded_batch_size=B,
                        mesh=make_mesh([jax.devices()[0]]))
    opt = JaxFedOpt([{"lr": LR}], cfg, model=model)
    model.attach_arrival_process(sched)
    out = []
    for batch in rounds[:stop]:
        met = model({"client_ids": batch["client_ids"],
                     **{k2: jnp.asarray(v) for k2, v in batch.items()
                        if k2 != "client_ids"}})
        opt.step()
        out.append((np.asarray(model.ps_weights),
                    [np.asarray(m) for m in met],
                    np.asarray(model.last_updated).copy()))
    return out, model, opt


MODES = {
    "sketch": dict(mode="sketch", error_type="virtual",
                   virtual_momentum=0.9, weight_decay=0.01, k=6,
                   num_rows=3, num_cols=32, num_blocks=2),
    "true_topk": dict(mode="true_topk", error_type="virtual",
                      local_momentum=0.9, k=4),
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, weight_decay=0.01, k=5),
    "robust_median": dict(mode="sketch", error_type="virtual",
                          virtual_momentum=0.9, k=6, num_rows=3,
                          num_cols=32, robust_agg="median"),
    "fedavg": dict(mode="fedavg", local_batch_size=-1, fedavg_batch_size=2,
                   virtual_momentum=0.9),
    "sketch_int8": dict(mode="sketch", error_type="virtual",
                        virtual_momentum=0.9, k=6, num_rows=3,
                        num_cols=32, sketch_dtype="int8",
                        downlink_encoding="delta"),
}
D = 33


def _w0(seed):
    return np.random.RandomState(seed).randn(D).astype(np.float32) * 0.3


@pytest.mark.parametrize("mode,store", [
    ("sketch", "device"), ("true_topk", "device"), ("local_topk", "device"),
    ("fedavg", "device"), ("sketch_int8", "device"), ("true_topk", "host"),
    ("local_topk", "host")])
def test_degenerate_async_round_is_the_synchronous_round(mode, store):
    # no dead slot: the asynchronous round bills no download to a slot
    # with no sample (a pad slot), where the synchronous round bills a
    # dropped client, as in the reference
    rounds = make_rounds(1, D, dead_round=None)
    sync, _, _ = run_port(MODES[mode], D, _w0(1), rounds, store=store)
    deg, model, _ = run_port(MODES[mode], D, _w0(1), rounds, k=W,
                             alpha=0.0, store=store,
                             sched=ArrivalSchedule("uniform"))
    for (ps, met, lu), (ps2, met2, lu2) in zip(sync, deg, strict=True):
        assert np.array_equal(ps, ps2)
        assert np.array_equal(lu, lu2)
        for a, b in zip(met, met2, strict=True):
            assert np.array_equal(a, b)
    assert len(model.async_round_stats) == ROUNDS
    assert all(s["async_buffer_occupancy"] == 1.0
               and s["async_staleness_max"] == 0.0
               for s in model.async_round_stats)
    model.finalize()


def _staleness(kind, seed=11):
    """One fold's staleness from ``kind``'s trace; the last slot is a
    dead pad slot (staleness 0 by construction)."""
    st = JaxSchedule(kind, seed=seed, max_delay=4,
                     burst_start_prob=1.0).delays(W).astype(np.float32)
    st[-1] = 0.0
    return st


# the reference's weighted round of each mode, built (and jitted) once
# for both traces
_JAX_ROUNDS = {}


@pytest.mark.parametrize("kind", ["churny", "bursty"])
@pytest.mark.parametrize("mode", ["sketch", "true_topk", "local_topk",
                                  "robust_median", "sketch_int8"])
def test_weighted_fold_matches_the_reference_round(mode, kind):
    kw = dict(MODES[mode], num_workers=W, async_buffer_size=W,
              async_staleness_weight=0.7)
    jcfg = dataclasses.replace(make_cfg(**kw), grad_size=D)
    tcfg = make_port_cfg(kw)
    tcfg.grad_size = D
    batch = make_rounds(4, D)[0]
    batch["mask"][-1] = 0.0  # a dead pad slot
    ids = batch.pop("client_ids")
    stale = _staleness(kind)
    w0 = _w0(4)
    if mode not in _JAX_ROUNDS:
        _JAX_ROUNDS[mode] = jax_client(jcfg, linear_loss, B,
                                       client_weights=True)
        if mode != "sketch_int8":
            _JAX_ROUNDS[mode] = jax.jit(_JAX_ROUNDS[mode])
    jround = _JAX_ROUNDS[mode]
    jstates = JaxStates.init(jcfg, NUM_CLIENTS, jnp.asarray(w0))
    jargs = (jnp.asarray(w0), jstates,
             {k: jnp.asarray(v) for k, v in batch.items()},
             jnp.asarray(ids), jax.random.PRNGKey(0), jnp.float32(LR),
             jnp.asarray(stale))
    if mode == "sketch_int8":
        # op by op: under jax.jit XLA multiplies by 1/qmax where the
        # reference divides (tests/test_torch_quant_round.py)
        with jax.disable_jit():
            want = np.asarray(jround(*jargs).aggregated)
    else:
        want = np.asarray(jround(*jargs).aggregated)
    tround = build_client_round(tcfg, torch_linear_loss, B,
                                client_weights=True)
    states = ClientStates.init(tcfg, NUM_CLIENTS, torch.from_numpy(w0),
                               "cpu")
    got = tround(torch.from_numpy(w0),
                 {k: torch.from_numpy(v) for k, v in batch.items()},
                 states, torch.from_numpy(ids.astype(np.int64)), LR, 0,
                 staleness=torch.from_numpy(stale)).aggregated.numpy()
    assert stale.max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the unweighted round differs: the weights are engaged
    plain = build_client_round(tcfg, torch_linear_loss, B)(
        torch.from_numpy(w0),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        ClientStates.init(tcfg, NUM_CLIENTS, torch.from_numpy(w0), "cpu"),
        torch.from_numpy(ids.astype(np.int64)), LR, 0).aggregated.numpy()
    assert not np.allclose(plain, got, rtol=1e-3)


@pytest.mark.parametrize("kind", ["churny", "bursty"])
@pytest.mark.parametrize("mode", ["sketch", "true_topk", "local_topk",
                                  "robust_median"])
def test_async_fedmodel_runs_match_the_reference(mode, kind):
    """ROUNDS asynchronous rounds at K = 2 < W, alpha 0.5, through both
    packages' FedModel with the same schedule: weights every round
    within rtol 1e-5 / atol 1e-6, losses likewise, the selected sets and
    both byte vectors equal."""
    rounds = make_rounds(2, D)
    w0 = _w0(2)
    ours, model, _ = run_port(MODES[mode], D, w0, rounds, k=2, alpha=ALPHA,
                              sched=ArrivalSchedule(kind, seed=3,
                                                    **SCHEDULES[kind]))
    theirs, jmodel, _ = run_jax(MODES[mode], D, w0, rounds, 2, ALPHA,
                                JaxSchedule(kind, seed=3,
                                            **SCHEDULES[kind]))
    for (ps, met, lu), (jps, jmet, jlu) in zip(ours, theirs, strict=True):
        np.testing.assert_allclose(ps, jps, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(met[0], jmet[0], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(lu, jlu)
        np.testing.assert_array_equal(met[-2], jmet[-2])
        np.testing.assert_array_equal(met[-1], jmet[-1])
    # the reference's driver keeps the last fold's statistics
    assert model.async_round_stats[-1] == \
        jmodel._async_driver.round_stats()
    # the trace made some fold stale
    assert max(s["async_staleness_max"]
               for s in model.async_round_stats) > 0
    jmodel.finalize()


def test_pad_slots_write_no_row_and_bill_client_0_nothing():
    """K = 2 of W = 4, punctual: every fold holds 2 live slots and 2 pad
    slots of id 0. Client 0 never takes part: its error and velocity
    rows stay zero and it is billed no byte, in either placement."""
    rounds = make_rounds(5, D, lowest=1)
    for store in ("device", "host"):
        out, model, _ = run_port(MODES["local_topk"], D, _w0(5), rounds,
                                 k=2, store=store)
        down = sum(met[-2] for _, met, _ in out)
        up = sum(met[-1] for _, met, _ in out)
        assert down[0] == 0 and up[0] == 0 and down.sum() > 0
        if store == "device":
            assert float(model.client_states.errors[0].abs().sum()) == 0
            assert float(model.client_states.velocities[0].abs().sum()) == 0
        else:
            model._store_writeback()
            rows, _ = model.client_store.gather(np.array([0]))
            assert all(float(np.abs(v).sum()) == 0 for v in rows.values())
        assert all(s["async_buffer_occupancy"] == 1.0
                   for s in model.async_round_stats)
        assert model.async_round_stats[-1]["async_backlog"] > 0
        model.finalize()


def test_host_store_async_run_equals_device_run_and_prefetches():
    """A churny local_topk run: the host store's weights and rows equal
    the device placement's bit for bit; the driver's exact lookahead
    makes prefetch hits."""
    rounds = make_rounds(6, D)
    runs = {}
    for store in ("device", "host"):
        out, model, _ = run_port(
            MODES["local_topk"], D, _w0(6), rounds, k=3, alpha=ALPHA,
            store=store, sched=ArrivalSchedule("churny", seed=2,
                                               **SCHEDULES["churny"]))
        runs[store] = (out, model)
    for (ps, met, lu), (ps2, met2, lu2) in zip(runs["device"][0],
                                               runs["host"][0], strict=True):
        assert np.array_equal(ps, ps2) and np.array_equal(lu, lu2)
        assert all(np.array_equal(a, b) for a, b in zip(met, met2))
    host = runs["host"][1]
    assert any(t["prefetch_hit"] for t in host.store_timings)
    host._store_writeback()
    rows, _ = host.client_store.gather(np.arange(NUM_CLIENTS))
    dev = runs["device"][1].client_states
    np.testing.assert_array_equal(rows["errors"],
                                  dev.errors[:NUM_CLIENTS].numpy())
    host.finalize()


def test_dp_epsilon_after_weighted_rounds_equals_the_references():
    kw = dict(MODES["sketch"], weight_decay=0.0, dp="sketch", dp_clip=1.0,
              dp_noise_mult=1.1)
    rounds = make_rounds(7, D)
    _, model, _ = run_port(kw, D, _w0(7), rounds, k=2, alpha=ALPHA,
                           sched=ArrivalSchedule("churny", seed=4,
                                                 **SCHEDULES["churny"]))
    _, jmodel, _ = run_jax(kw, D, _w0(7), rounds, 2, ALPHA,
                           JaxSchedule("churny", seed=4,
                                       **SCHEDULES["churny"]))
    eps = model.privacy_epsilon()
    assert eps == jmodel._accountant.epsilon() > 0
    # the staleness discount charged less than unweighted rounds would
    _, plain, _ = run_port(kw, D, _w0(7), rounds, k=2, alpha=0.0,
                           sched=ArrivalSchedule("churny", seed=4,
                                                 **SCHEDULES["churny"]))
    assert eps < plain.privacy_epsilon()


def _advanced(kind, rounds):
    sched = ArrivalSchedule(kind, seed=8, **SCHEDULES[kind])
    for r in range(rounds):
        sched(r, W)
    return sched


def _load(path):
    with np.load(path) as z:
        return (json.loads(str(z["meta"])),
                {k: np.array(z[k]) for k in z.files if k != "meta"})


@pytest.mark.parametrize("mode", ["sketch", "local_topk"])
def test_resume_mid_backlog_is_bit_for_bit(mode, tmp_path):
    rounds = make_rounds(8, D)
    cut = 3
    straight, _, _ = run_port(MODES[mode], D, _w0(8), rounds, k=2,
                              alpha=ALPHA, sched=_advanced("churny", 0))
    first, model, opt = run_port(MODES[mode], D, _w0(8), rounds, k=2,
                                 alpha=ALPHA, sched=_advanced("churny", 0),
                                 stop=cut)
    assert len(model._async_driver.queue) > 0  # a backlog in flight
    path = checkpoint.save_checkpoint(str(tmp_path / "ours.npz"), model, opt)
    model.finalize()
    rest, _, _ = run_port(MODES[mode], D, _w0(8), rounds, k=2, alpha=ALPHA,
                          sched=_advanced("churny", cut), resume=path)
    for (ps, met, lu), (ps2, met2, lu2) in zip(straight, first + rest,
                                               strict=True):
        assert np.array_equal(ps, ps2) and np.array_equal(lu, lu2)
        assert all(np.array_equal(a, b) for a, b in zip(met, met2))
    # the archive's asynchronous keys equal the reference's
    _, jmodel, jopt = run_jax(MODES[mode], D, _w0(8), rounds, 2, ALPHA,
                              JaxSchedule("churny", seed=8,
                                          **SCHEDULES["churny"]), stop=cut)
    jpath = jax_checkpoint.save_checkpoint(str(tmp_path / "jax.npz"),
                                           jmodel, jopt)
    jmodel.finalize()
    meta, arrays = _load(path)
    jmeta, jarrays = _load(jpath)
    assert meta["asyncfed"] == jmeta["asyncfed"]
    assert meta["asyncfed"]["pending"] > 0
    keys = sorted(k for k in jarrays if k.startswith("async"))
    assert sorted(k for k in arrays if k.startswith("async")) == keys
    for key in keys:
        assert arrays[key].dtype == jarrays[key].dtype, key
        np.testing.assert_array_equal(arrays[key], jarrays[key])


def test_archive_backlog_without_a_driver_raises(tmp_path):
    rounds = make_rounds(9, D)
    _, model, opt = run_port(MODES["sketch"], D, _w0(9), rounds, k=2,
                             sched=_advanced("churny", 0), stop=3)
    path = checkpoint.save_checkpoint(str(tmp_path / "a.npz"), model, opt)
    with pytest.raises(ValueError, match="queued async arrival"):
        run_port(MODES["sketch"], D, _w0(9), rounds, resume=path)
    sync_path = str(tmp_path / "sync.npz")
    _, smodel, sopt = run_port(MODES["sketch"], D, _w0(9), rounds, stop=3)
    checkpoint.save_checkpoint(sync_path, smodel, sopt)
    with pytest.warns(UserWarning, match="arrival buffer resumes empty"):
        run_port(MODES["sketch"], D, _w0(9), rounds, k=2, resume=sync_path)


BASE_ARGV = ["--num_workers", "4", "--mode", "sketch", "--error_type",
             "virtual", "--local_momentum", "0"]


@pytest.mark.parametrize("argv,match", [
    (["--async_buffer_size", "-1"], "async_buffer_size must be >= 0"),
    (["--async_buffer_size", "5"], "must be <= --num_workers"),
    (["--async_staleness_weight", "-0.5"], "must be >= 0"),
    (["--async_buffer_size", "2", "--client_chunk", "2"], "client_chunk"),
    (["--async_buffer_size", "2", "--pipeline_depth", "2"],
     "pipeline_depth"),
])
def test_config_asserts_as_the_reference(argv, match):
    from commefficient_tpu.config import parse_args as jax_parse_args
    for parse in (parse_args, jax_parse_args):
        with pytest.raises(AssertionError, match=match):
            parse(argv=BASE_ARGV + argv).validate_runtime()
    cfg = parse_args(argv=BASE_ARGV + ["--async_buffer_size", "3",
                                       "--async_staleness_weight", "0.5"])
    assert (cfg.async_buffer_size, cfg.async_staleness_weight) == (3, 0.5)
    # the job service's alarm knob parses as the reference's, and so does
    # --async_buffer_size beside --seq_devices (whose round the
    # reference's sequence-parallel model runs synchronously)
    assert parse_args(argv=BASE_ARGV + ["--alarm_job_starvation", "2"]
                      ).alarm_job_starvation == jax_parse_args(
        argv=BASE_ARGV + ["--alarm_job_starvation", "2"]
    ).alarm_job_starvation == 2.0
    argv = BASE_ARGV + ["--async_buffer_size", "2", "--seq_devices", "2"]
    for cfg in (parse_args(argv=argv), jax_parse_args(argv=argv)):
        cfg.validate_runtime()
        assert (cfg.async_buffer_size, cfg.seq_devices) == (2, 2)


def test_both_trainers_run_buffered_rounds(tmp_path):
    """``--async_buffer_size 1`` of 2 clients with staleness weighting
    through both trainers' ``main`` (``--test``): finite losses, and the
    FedModel folded one client a round."""
    from commefficient_tpu_torch.runtime import fed_model
    from commefficient_tpu_torch.train import cv_train, gpt2_train

    from test_torch_gpt2_train import ARGV
    flags = ["--async_buffer_size", "1", "--async_staleness_weight", "0.5"]
    rows = cv_train.main(["--device", "cpu", "--test", "--dataset_name",
                          "Synthetic", "--local_momentum", "0",
                          "--num_clients", "10", "--num_workers", "2",
                          "--num_epochs", "2"] + flags)
    stats = fed_model._CURRENT_MODEL.async_round_stats
    assert all(np.isfinite(r["train_loss"]) for r in rows) and stats
    assert all(s["async_buffer_occupancy"] == 1.0 for s in stats)
    rows = gpt2_train.main(["--device", "cpu", "--dataset_dir",
                            str(tmp_path)] + ARGV + flags)
    assert all(np.isfinite(r["train_loss"]) for r in rows)
    assert fed_model._CURRENT_MODEL.async_round_stats[-1][
        "async_backlog"] >= 1

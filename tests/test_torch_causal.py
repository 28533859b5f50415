"""Causal round tracing and critical paths of the port
(``commefficient_tpu_torch/telemetry/causal.py``, ``critpath.py``, the
causal frames of ``telemetry/core.py``, the asynchronous driver's spans
and the flight recorder's critical-path diff) against the JAX package.

- ``trace_id``/``span_id`` mint the reference's strings; the bucket map
  is the reference's and total.
- ``critical_path`` (with its ``device_time`` overlay),
  ``dominant_bucket``, ``median_buckets`` and ``critpath_diff`` on the
  reference's golden DAGs give equal buckets; ``assemble_traces`` equal
  DAGs.
- A traced port FedModel round on ``test_modes.linear_loss`` (and an
  asynchronous one, with ``cohort_issue``/``arrival_dequeue``) gives a
  DAG with the reference's span names and parent structure, and its
  critical path sums to its wall within ``CLOCK_TOLERANCE``.
- ``--causal_trace`` leaves the round's numbers alone, bit for bit, and
  adds only the ``causal`` key to the ledger.
- A flight-recorder bundle dumped by a latency alarm carries the
  reference's ``critpath_diff``.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.runtime.fed_model import FedOptimizer as JaxFedOpt
from commefficient_tpu.telemetry import causal as jax_causal
from commefficient_tpu.telemetry import critpath as jax_critpath
from commefficient_tpu.telemetry.flightrec import \
    FlightRecorder as JaxFlightRecorder
from commefficient_tpu.telemetry.flightrec import \
    load_postmortem as jax_load_postmortem
from commefficient_tpu.telemetry.record import \
    make_round_record as jax_round_record
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.runtime.fed_model import FedModel, FedOptimizer
from commefficient_tpu_torch.telemetry import causal, critpath
from commefficient_tpu_torch.telemetry.causal import (SEQ_GRANT, SEQ_ROOT,
                                                      span_id, trace_id)
from commefficient_tpu_torch.telemetry.flightrec import (FlightRecorder,
                                                         load_postmortem)
from commefficient_tpu_torch.telemetry.record import (make_round_record,
                                                      validate_record)

from test_modes import linear_loss
from test_torch_modes import torch_linear_loss

W, B, DIM, NUM_CLIENTS = 4, 2, 32, 16


# --- ids and buckets ---------------------------------------------------


@pytest.mark.parametrize("job", [None, 0, 7, "service", "a.b"])
def test_ids_are_the_references(job):
    for r in (0, 3, 12):
        assert trace_id(job, r) == jax_causal.trace_id(job, r)
        for seq in (SEQ_ROOT, causal.SEQ_ADMIT, SEQ_GRANT,
                    causal.SEQ_DYNAMIC, 41):
            assert span_id(job, r, seq) == jax_causal.span_id(job, r, seq)
    assert trace_id(None, 3) == "jsolo.r3"
    assert span_id(2, 5, SEQ_GRANT) == "j2.r5.s2"


def test_bucket_map_is_the_references_and_total():
    assert causal.BUCKETS == jax_causal.BUCKETS
    assert causal.BUCKET_OF == jax_causal.BUCKET_OF
    assert (causal.SEQ_ROOT, causal.SEQ_ADMIT, causal.SEQ_GRANT,
            causal.SEQ_DYNAMIC) == (jax_causal.SEQ_ROOT,
                                    jax_causal.SEQ_ADMIT,
                                    jax_causal.SEQ_GRANT,
                                    jax_causal.SEQ_DYNAMIC)
    assert set(causal.BUCKET_OF.values()) <= set(causal.BUCKETS)
    for name in list(causal.BUCKET_OF) + ["brand_new_phase", "", "round"]:
        assert causal.bucket_of(name) == jax_causal.bucket_of(name)
        assert causal.bucket_of(name) in causal.BUCKETS
    assert causal.bucket_of("brand_new_phase") == "host_other"
    assert critpath.CLOCK_TOLERANCE == jax_critpath.CLOCK_TOLERANCE


# --- golden DAGs ---------------------------------------------------------


def _gspan(seq, name, b, e, parent_seq=SEQ_ROOT, job=None, r=0):
    return {"id": span_id(job, r, seq),
            "parent": None if parent_seq is None
            else span_id(job, r, parent_seq),
            "name": name, "bucket": causal.bucket_of(name),
            "b": float(b), "e": float(e)}


def _root(job=None, r=0, wall=10.0):
    root = _gspan(SEQ_ROOT, "round", 0, wall, parent_seq=None, job=job, r=r)
    root["bucket"] = "host_other"
    return root


GOLDEN = {
    # gather [1,3], h2d [3,4], dispatch [4,8] nesting a collective
    # [6,7], flush [8,9.5]
    "reference": [_root(), _gspan(8, "gather", 1, 3), _gspan(9, "h2d", 3, 4),
                  _gspan(10, "round_dispatch", 4, 8),
                  _gspan(11, "collective", 6, 7, parent_seq=10),
                  _gspan(12, "flush", 8, 9.5)],
    # a sibling inside an earlier child, a child past the root's end
    "clipped": [_root(), _gspan(8, "gather", 1, 6), _gspan(9, "h2d", 4, 5),
                _gspan(10, "flush", 8, 12)],
    # the asynchronous front end and a foreign grant
    "async": [_root(), _gspan(8, "async_fold", 0.5, 2),
              _gspan(9, "cohort_issue", 0.6, 1.0, parent_seq=8),
              _gspan(10, "arrival_dequeue", 1.0, 1.9, parent_seq=8),
              _gspan(11, "h2d", 2, 2.5), _gspan(12, "round_dispatch", 2.5, 7),
              _gspan(13, "server", 7, 9), _gspan(14, "brand_new", 9, 9.7),
              dict(_gspan(SEQ_GRANT, "sched_grant", -3, 0.2),
                   trace="jsolo.r0")],
}

DEVICE_TIMES = [None,
                {"per_device": [{"collective_s": 2.0, "overlapped_s": 1.5}]},
                {"per_device": [{"collective_s": 1.0, "overlapped_s": 3.0}]},
                {"per_device": {"collective_s": 99.0, "overlapped_s": 0.0}},
                {"per_device": {"0": {"collective_s": 5.0}}}]


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_critical_path_is_the_references_on_golden_dags(name):
    stamp = {"trace": "jsolo.r0", "job": None, "round": 0, "wall": 10.0,
             "spans": GOLDEN[name]}
    for dt in DEVICE_TIMES:
        got = critpath.critical_path(stamp, dt)
        want = jax_critpath.critical_path(stamp, dt)
        assert got == want
        assert sum(got["buckets"].values()) == got["wall"] == 10.0
        assert critpath.dominant_bucket(got) == \
            jax_critpath.dominant_bucket(want)
    if name == "reference":
        crit = critpath.critical_path(stamp)
        assert crit["buckets"] == pytest.approx(
            {"sched_wait": 0.0, "arrival_wait": 0.0, "host_gather": 2.0,
             "h2d": 1.0, "compute": 3.0, "collective_exposed": 1.0,
             "writeback": 0.0, "flush": 1.5, "host_other": 1.5})


def test_critical_path_rejects_what_the_reference_rejects():
    grant = dict(_gspan(SEQ_GRANT, "sched_grant", 0, 1, parent_seq=None),
                 trace="j0.r0")
    for bad in (None, {}, {"spans": []}, {"spans": [grant]}, "x"):
        assert critpath.critical_path(bad) is None
        assert jax_critpath.critical_path(bad) is None


def test_median_and_diff_are_the_references():
    rs = np.random.RandomState(0)
    crits = []
    for r in range(7):
        b = {k: float(rs.uniform(0, 2)) * (rs.rand() < 0.7)
             for k in causal.BUCKETS}
        crits.append({"round": r, "wall": sum(b.values()), "buckets": b})
    for n in (1, 2, 5, 6):
        base = critpath.median_buckets(crits[:n])
        assert base == jax_critpath.median_buckets(crits[:n])
        assert critpath.critpath_diff(crits[-1], base) == \
            jax_critpath.critpath_diff(crits[-1], base)
    assert critpath.median_buckets([]) is None
    assert critpath.critpath_diff(None, {}) is None
    assert critpath.dominant_bucket(None) is None


# --- the tracer ------------------------------------------------------------


def _drive(tracer):
    tracer.begin_round(2)
    with tracer.span("gather"):
        pass
    with tracer.span("round_dispatch"):
        with tracer.span("collective"):
            pass
        tracer.open("server")
        tracer.close_span()
    tracer.add_event("sched_grant", 1.0, 2.0, trace=trace_id(0, 5),
                     sid=span_id(0, 5, SEQ_GRANT),
                     parent=span_id(0, 5, SEQ_ROOT))
    return tracer.end_round()


def _shape(stamp):
    return [(s["id"], s["parent"], s["name"], s["bucket"], s.get("trace"))
            for s in stamp["spans"]]


@pytest.mark.parametrize("job", [None, 4, "service"])
def test_tracer_mints_the_references_dag(job):
    ours = _drive(causal.CausalTracer(job=job))
    theirs = _drive(jax_causal.CausalTracer(job=job))
    assert _shape(ours) == _shape(theirs)
    assert (ours["trace"], ours["job"], ours["round"]) == \
        (theirs["trace"], theirs["job"], theirs["round"])
    by = {s["name"]: s for s in ours["spans"]}
    assert by["collective"]["parent"] == by["round_dispatch"]["id"]
    assert by["server"]["parent"] == by["round_dispatch"]["id"]
    crit = critpath.critical_path(ours)
    assert abs(sum(crit["buckets"].values()) - crit["wall"]) \
        <= critpath.CLOCK_TOLERANCE
    rec = make_round_record(2)
    rec["causal"] = ours
    assert validate_record(rec) == []
    t = causal.CausalTracer()
    assert t.end_round() is None


def test_tracer_ignores_non_owner_threads():
    t = causal.CausalTracer()
    t.begin_round(0)
    worker = threading.Thread(target=lambda: t.open("gather"))
    worker.start()
    worker.join()
    assert [s["name"] for s in t.end_round()["spans"]] == ["round"]


def test_assemble_traces_is_the_references():
    svc, tenant = causal.CausalTracer(job="service"), causal.CausalTracer(0)
    svc.begin_round(0)
    svc.add_event("admission", 0.0, 0.5, trace=trace_id(0, 0),
                  sid=span_id(0, 0, causal.SEQ_ADMIT), parent=None)
    svc.add_event("sched_grant", 1.0, 2.0, trace=trace_id(0, 5),
                  sid=span_id(0, 5, SEQ_GRANT),
                  parent=span_id(0, 5, SEQ_ROOT))
    recs = [{"kind": "round", "causal": svc.end_round()}]
    for r in (0, 5):
        tenant.begin_round(r)
        with tenant.span("h2d"):
            pass
        recs.append({"kind": "round", "causal": tenant.end_round()})
    recs.append({"kind": "round", "causal": {
        "trace": "j9.r9", "round": 9, "wall": 0.0,
        "spans": [_gspan(8, "h2d", 0, 1, job=9, r=9)]}})
    recs.append({"kind": "meta"})
    got = causal.assemble_traces(recs)
    assert got == jax_causal.assemble_traces(recs)
    assert got["j0.r5"]["orphans"] == [] and got["j0.r5"]["round"] == 5
    assert got["j9.r9"]["orphans"] == [span_id(9, 9, 8)]


def test_build_causal_tracer_gates_on_the_flag():
    assert causal.build_causal_tracer(Config(device="cpu")) is None
    t = causal.build_causal_tracer(Config(device="cpu", causal_trace=True),
                                   job=3)
    assert isinstance(t, causal.CausalTracer) and t.job == 3


# --- traced FedModel rounds against the reference's ----------------------


def _rounds(seed, n, dead=False):
    rs = np.random.RandomState(seed)
    out = []
    for r in range(n):
        ids = rs.choice(NUM_CLIENTS, W, replace=False).astype(np.int32)
        mask = np.ones((W, B), np.float32)
        if dead and r == 1:
            mask[1] = 0.0
        out.append({"client_ids": ids,
                    "x": rs.randn(W, B, DIM).astype(np.float32),
                    "y": rs.randn(W, B).astype(np.float32), "mask": mask})
    return out


KW = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
          virtual_momentum=0.9, weight_decay=0.0, k=6, num_rows=3,
          num_cols=64, num_blocks=1, num_workers=W, local_batch_size=B,
          num_clients=NUM_CLIENTS, seed=11, probe_every=2)


def _port(ledger, rounds, **kw):
    cfg = Config(device="cpu", ledger=ledger, **dict(KW, **kw))
    model = FedModel(None, torch.zeros(DIM),
                     lambda p, b, a: torch_linear_loss(p, b), cfg,
                     padded_batch_size=B)
    opt = FedOptimizer([{"lr": 0.1}], cfg, model=model)
    for batch in rounds:
        model(batch)
        opt.step()
    weights = model.ps_weights.clone()
    model.finalize()
    with open(ledger) as f:
        return [json.loads(line) for line in f], weights


def _jax(ledger, rounds, **kw):
    cfg = JaxConfig(ledger=ledger, **dict(KW, **kw))
    cfg.grad_size = DIM
    model = JaxFedModel(None, {"p": jnp.zeros(DIM, jnp.float32)},
                        lambda p, b, a: linear_loss(p["p"], b), cfg,
                        padded_batch_size=B,
                        mesh=make_mesh([jax.devices()[0]]))
    opt = JaxFedOpt([{"lr": 0.1}], cfg, model=model)
    for batch in rounds:
        model({"client_ids": batch["client_ids"],
               **{k: jnp.asarray(v) for k, v in batch.items()
                  if k != "client_ids"}})
        opt.step()
    model.finalize()
    with open(ledger) as f:
        return [json.loads(line) for line in f]


def _structure(rec):
    """The round DAG as (name, parent name) pairs, in span order."""
    spans = rec["causal"]["spans"]
    names = {s["id"]: s["name"] for s in spans}
    return [(s["name"], names.get(s["parent"])) for s in spans]


@pytest.mark.parametrize("kw", [
    {}, {"async_buffer_size": 3, "async_staleness_weight": 0.5}],
    ids=["sync", "async"])
def test_traced_round_has_the_references_dag(tmp_path, kw):
    rounds = _rounds(5, 3, dead="async_buffer_size" in kw)
    ours, _ = _port(str(tmp_path / "ours.jsonl"), rounds,
                    causal_trace=True, **kw)
    theirs = _jax(str(tmp_path / "theirs.jsonl"), rounds,
                  causal_trace=True, **kw)
    ours = [r for r in ours if r["kind"] == "round"]
    theirs = [r for r in theirs if r["kind"] == "round"]
    assert len(ours) == len(theirs) == 3
    for rec, jrec in zip(ours, theirs):
        assert validate_record(rec) == []
        assert _structure(rec) == _structure(jrec)
        assert [s["id"] for s in rec["causal"]["spans"]] == \
            [s["id"] for s in jrec["causal"]["spans"]]
        assert rec["causal"]["trace"] == jrec["causal"]["trace"]
        crit = critpath.critical_path(rec["causal"],
                                      rec.get("device_time"))
        assert abs(sum(crit["buckets"].values()) - rec["causal"]["wall"]) \
            <= critpath.CLOCK_TOLERANCE
        assert abs(crit["wall"] - rec["causal"]["wall"]) \
            <= critpath.CLOCK_TOLERANCE
        if kw:
            names = dict(_structure(rec))
            assert names["cohort_issue"] == names["arrival_dequeue"] \
                == "async_fold"
    traces = causal.assemble_traces(ours)
    assert sorted(traces) == ["jsolo.r0", "jsolo.r1", "jsolo.r2"]
    assert all(not t["orphans"] for t in traces.values())


@pytest.mark.parametrize("kw", [
    {}, {"async_buffer_size": 3, "async_staleness_weight": 0.5}],
    ids=["sync", "async"])
def test_causal_trace_is_inert(tmp_path, kw):
    """On or off, the weights are bit-equal and the ledger gains the
    ``causal`` key alone."""
    rounds = _rounds(6, 3, dead="async_buffer_size" in kw)
    on, w_on = _port(str(tmp_path / "on.jsonl"), rounds,
                     causal_trace=True, **kw)
    off, w_off = _port(str(tmp_path / "off.jsonl"), rounds, **kw)
    assert torch.equal(w_on, w_off)
    on_r = [r for r in on if r["kind"] == "round"]
    off_r = [r for r in off if r["kind"] == "round"]
    assert [set(a) - set(b) for a, b in zip(on_r, off_r)] == [{"causal"}] * 3
    assert all("causal" not in r for r in off)
    for a, b in zip(on_r, off_r):
        assert a["probes"] == b["probes"]
        assert (a["uplink_bytes"], a["downlink_bytes"]) == \
            (b["uplink_bytes"], b["downlink_bytes"])


# --- the flight recorder's diff --------------------------------------------


def _recorder(cls, make, tmp_path, rule, rounds=5):
    fr = cls(JaxConfig() if cls is JaxFlightRecorder
             else Config(device="cpu"), ring_rounds=8,
             out_dir=str(tmp_path / cls.__module__))
    for r in range(rounds):
        rec = make(r)
        slow = 10.0 if r == rounds - 1 else 1.0 + 0.1 * r
        root = _root(r=r, wall=slow)
        rec["causal"] = {"trace": trace_id(None, r), "job": None,
                         "round": r, "wall": slow,
                         "spans": [root, _gspan(8, "h2d", 0, 0.5 * slow, r=r),
                                   _gspan(9, "server", 0.6 * slow, 0.9 * slow,
                                          r=r)]}
        if r == rounds - 1:
            rec["alarms"] = [{"rule": rule, "round": r, "value": slow,
                              "threshold": 2.0}]
        fr.write(rec)
    return fr


@pytest.mark.parametrize("rule", ["step_time_regression", "slo_burn",
                                  "nan_inf"])
def test_alarm_bundle_carries_the_references_critpath_diff(tmp_path, rule):
    ours = _recorder(FlightRecorder, make_round_record, tmp_path, rule)
    theirs = _recorder(JaxFlightRecorder, jax_round_record, tmp_path, rule)
    bundle, problems = load_postmortem(ours.last_bundle)
    jbundle, _ = jax_load_postmortem(theirs.last_bundle)
    assert problems == []
    if rule == "nan_inf":
        assert "critpath_diff" not in bundle["context"]
        assert "critpath_diff" not in jbundle["context"]
        return
    diff = bundle["context"]["critpath_diff"]
    assert diff == jbundle["context"]["critpath_diff"]
    assert diff["round"] == 4 and diff["wall"] == pytest.approx(10.0)
    assert diff["rows"][0]["bucket"] in ("h2d", "host_other")

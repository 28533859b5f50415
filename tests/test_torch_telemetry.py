"""The port's telemetry (``commefficient_tpu_torch/telemetry``) against
the JAX package's, on the CPU.

- Records: the port's makers validate under the reference's
  ``validate_record`` and the reference's under the port's, and broken
  records get the same problem lists from both.
- The span lifecycle: disabled is a no-op that keeps nothing; spans and
  counters accumulate; a round emits once it is closed and carries its
  bytes (the deferred emit of ``--pipeline_depth``), in round order; a
  close flushes byteless rounds; an alarm adds a summary record. Both
  packages' Telemetry emit the same record sequences.
- Sinks: the JSONL ledger's torn-tail recovery, resume deduplication and
  one-writer guard; the console summary equals the reference's.
- The flight recorder: its ring, the bundle an alarm dumps, the crash
  hook, ``load_postmortem``.
- The alarm rules on the reference's cases (tests/test_probes.py,
  tests/test_telemetry.py), both engines fed the same probes.
- A short ResNet9 ``--ledger --probe_every 2`` run of both trainers from
  the same weights: the same records and keys, the same byte counts and
  alarms, probe values at rtol 1e-5 / atol 1e-6, the same selected
  coordinates; timings are not compared. Depth 3 gives depth 1's probes.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import json
import math
import os
import sys

import jax
import numpy as np
import pytest

from commefficient_tpu.config import parse_args as jax_parse_args
from commefficient_tpu.telemetry import alarms as jax_alarms
from commefficient_tpu.telemetry import core as jax_core
from commefficient_tpu.telemetry import record as jax_record
from commefficient_tpu.telemetry import sinks as jax_sinks
from commefficient_tpu.train import cv_train as jax_cv_train
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.telemetry import alarms, core, record, sinks
from commefficient_tpu_torch.telemetry.flightrec import (FlightRecorder,
                                                         install_crash_hook,
                                                         load_postmortem)
from commefficient_tpu_torch.train import cv_train

# record fields that are timings or host state, never compared
VOLATILE = ("ts", "spans", "host_rss_peak_bytes", "hbm_peak_bytes")


class ListSink:
    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(json.loads(json.dumps(rec)))

    def close(self):
        pass


def _stable(rec):
    out = {k: v for k, v in rec.items() if k not in VOLATILE}
    if "counters" in out:
        out["counters"] = {k: v for k, v in out["counters"].items()
                           if not k.startswith("compile_")}
    return out


# --- records ------------------------------------------------------------


def _records(mod):
    rnd = mod.make_round_record(3)
    rnd["probes"] = {"agg_norm": 1.0}
    rnd["device_time"] = {"window_s": 1.0, "busy_s": 0.5,
                          "per_device": {"cuda:0": {"busy_s": 0.5}},
                          "skew": {"n_collectives": 0}}
    return [mod.make_meta_record(plan={"mode": "sketch"}), rnd,
            mod.make_round_record(0), mod.make_epoch_record({"a": 1}, 1),
            mod.make_bench_record("x", 1.0, "s"),
            mod.make_summary_record(alarm_fired={"nan_inf": 2})]


def _broken():
    rnd = record.make_round_record(1)
    return [None, {"schema": 99, "kind": "nope"},
            dict(rnd, spans={"a": "x"}), dict(rnd, uplink_bytes="1"),
            {k: v for k, v in rnd.items() if k != "probes"},
            dict(rnd, device_time={"busy_s": "a", "skew": 1}),
            dict(rnd, causal={"trace": 1, "spans": [{"id": 1}]}),
            dict(record.make_summary_record(), alarm_fired={"a": "b"}),
            {"schema": 7, "kind": "bench", "ts": 0.0},
            {"schema": 7, "kind": "epoch", "ts": 0.0, "process": "p"}]


def test_records_validate_under_both_packages():
    assert record.LEDGER_SCHEMA_VERSION == jax_record.LEDGER_SCHEMA_VERSION
    for mod in (record, jax_record):
        for rec in _records(mod):
            assert jax_record.validate_record(rec) == [], rec
            assert record.validate_record(rec) == [], rec
    assert sorted(record.make_round_record(0)) == \
        sorted(jax_record.make_round_record(0))
    for rec in _broken():
        problems = record.validate_record(rec)
        assert problems and problems == jax_record.validate_record(rec)


# --- the span lifecycle -------------------------------------------------


def test_disabled_telemetry_is_a_noop_that_keeps_nothing():
    for tel in (core.Telemetry(), core.NULL_TELEMETRY):
        assert not tel.enabled
        assert tel.begin_round(0) is None
        assert tel.span("h2d") is core.NULL_SPAN
        with tel.span("h2d"):
            pass
        tel.count("prefetch_hit")
        tel.merge_round_probes(0, {"agg_norm": 1.0})
        tel.flag_alarm(0, {"rule": "nan_inf"})
        tel.set_round_bytes(0, 1.0, 1.0)
        assert not tel._records and tel._current is None


def _drive(mod):
    """One scenario on a Telemetry of ``mod``: a synchronous round, three
    pipelined rounds whose bytes arrive late and out of order, probes,
    an alarm, an epoch row and a byteless round at the close."""
    sink = ListSink()
    tel = mod.Telemetry([sink])
    tel.emit_meta(num_clients=4, plan={"mode": "sketch"})
    tel.begin_round(0)
    with tel.span("h2d"):
        pass
    with tel.span("h2d"):
        pass
    tel.count("prefetch_hit")
    tel.count("prefetch_hit", 2)
    tel.merge_round_probes(0, {"agg_norm": 1.5})
    tel.set_round_bytes(0, 10.0, 4.0)
    for r in (1, 2, 3):
        tel.begin_round(r)
    seen = [len(sink.records)]
    tel.set_round_bytes(2, 1.0, 2.0)
    seen.append(len(sink.records))
    tel.merge_round_probes(1, {"residual_norm": 2.0})
    tel.flag_alarm(1, {"rule": "nan_inf", "value": 1.0})
    tel.set_round_bytes(1, 3.0, 4.0)
    seen.append(len(sink.records))
    tel.set_round_privacy(3, 1.25, 1e-5, 0.5)
    tel.epoch({"epoch": 1, "train_loss": 0.5}, 1)
    tel.begin_round(4)
    tel.close()
    return sink.records, seen


def test_lifecycle_and_deferred_emit_match_the_reference():
    ours, seen = _drive(core)
    theirs, jseen = _drive(jax_core)
    # round 0 emits at round 1's begin; 2's bytes wait for 1's
    assert seen == jseen == [2, 2, 4]
    assert [r["kind"] for r in ours] == [
        "meta", "round", "round", "round", "epoch", "round", "round",
        "summary"]
    assert [_stable(r) for r in ours] == [_stable(r) for r in theirs]
    rounds = [r for r in ours if r["kind"] == "round"]
    assert [r["round"] for r in rounds] == [0, 1, 2, 3, 4]
    assert rounds[0]["counters"]["prefetch_hit"] == 3
    assert rounds[0]["spans"]["h2d"] >= 0.0
    assert rounds[-1]["uplink_bytes"] is None  # byteless, flushed
    assert ours[-1]["alarm_fired"] == {"nan_inf": 1}
    for rec in ours:
        assert jax_record.validate_record(rec) == []


def test_hold_emission_and_device_time_merge():
    sink = ListSink()
    tel = core.Telemetry([sink])
    fired = []
    tel.on_device_time = lambda ridx, b: fired.append((ridx, b))
    tel.hold_emission(True)
    tel.begin_round(0)
    tel.set_round_bytes(0, 1.0, 1.0)
    tel.begin_round(1)
    assert sink.records == []
    tel.merge_round_device_time(0, {"window_s": 1.0, "busy_s": 0.25})
    tel.hold_emission(False)
    assert [r["round"] for r in sink.records] == [0]
    assert sink.records[0]["device_time"]["busy_s"] == 0.25
    assert fired == [(0, {"window_s": 1.0, "busy_s": 0.25})]
    tel.close()


# --- sinks ------------------------------------------------------------------


def test_jsonl_sink_recovers_torn_tail_dedups_resume_and_has_one_writer(
        tmp_path):
    path = str(tmp_path / "run.jsonl")
    rec = {"schema": 7, "kind": "round", "round": 0, "x": np.float32(1.5),
           "n": np.int64(2), "a": np.arange(2)}
    sink = sinks.JSONLSink(path)
    with pytest.raises(RuntimeError, match="already has a live"):
        sinks.JSONLSink(path)
    sink.write(rec)
    sink.write(dict(rec, round=1))
    sink.close()
    with open(path, "a") as f:
        f.write('{"schema": 7, "kind": "rou')  # a torn tail
    assert sinks.last_round_index(path) == 1
    resumed = sinks.JSONLSink(path, resume_after=sinks.last_round_index(
        path))
    resumed.write(dict(rec, round=1))   # replayed: dropped
    resumed.write(dict(rec, round=2))
    resumed.close()
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    assert [r["round"] for r in lines] == [0, 1, 2]
    assert lines[0]["x"] == 1.5 and lines[0]["a"] == [0, 1]
    with open(path, "a") as f:
        f.write("{}\n" + "x" * 10)
    assert sinks.recover_torn_tail(path) == 10
    assert jax_sinks.recover_torn_tail(path) == 0


def test_console_sink_summary_equals_the_reference(capsys):
    recs, _ = _drive(core)
    ours, theirs = sinks.ConsoleSink(), jax_sinks.ConsoleSink()
    for rec in recs:
        ours.write(rec)
        theirs.write(rec)
    assert _stable(ours.summary()) == _stable(theirs.summary())
    ours.close()
    out = capsys.readouterr().out
    assert "telemetry summary (5 rounds)" in out and "alarms fired" in out


def test_tensorboard_sink_writes_or_warns(tmp_path, monkeypatch):
    sink = sinks.TensorBoardSink(str(tmp_path / "tb"))
    sink.write({"kind": "epoch", "epoch": 1, "row": {"train loss": 0.5,
                                                     "name": "x"}})
    sink.write({"kind": "round", "round": 0, "spans": {"h2d": 0.001},
                "uplink_bytes": 4.0, "downlink_bytes": None})
    sink.close()
    if sink._writer is None:
        return
    assert any(n.startswith("events") for n in os.listdir(tmp_path / "tb"))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.warns(UserWarning, match="--tensorboard ignored"):
        assert sinks.TensorBoardSink(str(tmp_path / "x"))._writer is None


# --- the flight recorder ------------------------------------------------


def test_flight_recorder_ring_dump_and_crash_hook(tmp_path, monkeypatch):
    cfg = Config(device="cpu", flightrec_rounds=3, ledger="x.jsonl")
    rec = FlightRecorder(cfg, 3, labels={"run": "r"},
                         out_dir=str(tmp_path))
    tel = core.Telemetry([rec])
    tel.emit_meta(num_clients=4)
    for r in range(5):
        tel.begin_round(r)
        tel.set_round_bytes(r, 1.0, 1.0)
    assert rec.last_bundle is None
    tel.begin_round(5)
    tel.flag_alarm(5, {"rule": "nan_inf", "value": 1.0})
    tel.set_round_bytes(5, 1.0, 1.0)
    tel.close()
    bundle, problems = load_postmortem(rec.last_bundle)
    assert problems == []
    assert bundle["reason"] == "alarm" and bundle["rule"] == "nan_inf"
    assert [r["round"] for r in bundle["rounds"]] == [3, 4, 5]
    assert bundle["meta"]["num_clients"] == 4
    assert "ledger" not in bundle["config"]   # an observability knob
    assert bundle["labels"] == {"run": "r"}
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    # one bundle an incident; a crash dumps its own through the hook
    assert rec.dump("alarm", rule="nan_inf") == rec.last_bundle
    seen = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: seen.append(a[0]))
    hook = install_crash_hook(rec)
    assert sys.excepthook is hook
    hook(ValueError, ValueError("boom"), None)
    assert seen == [ValueError]
    crash, problems = load_postmortem(rec.last_bundle)
    assert problems == [] and crash["reason"] == "crash"
    assert crash["context"] == {"exception": "ValueError: boom"}
    assert len(os.listdir(tmp_path)) == 2
    with pytest.raises(ValueError):
        FlightRecorder(cfg, 0)


# --- the alarm rules ----------------------------------------------------


def _cfgs(**kw):
    base = dict(probe_every=1, on_divergence="log",
                alarm_residual_ratio=2.0, alarm_residual_rounds=2,
                alarm_recovery_error=0.9)
    base.update(kw)
    from commefficient_tpu.config import Config as JaxConfig
    return Config(device="cpu", **base), JaxConfig(**base)


ALARM_CASES = [
    ("nan_inf", {}, [{"agg_nan": 0.0, "agg_inf": 0.0},
                     {"agg_nan": 2.0, "agg_inf": 0.0}]),
    ("residual_growth", {}, [{"residual_growth": 3.0},
                             {"residual_growth": 3.0},
                             {"residual_growth": 1.0},
                             {"residual_growth": 3.0},
                             {"residual_growth": math.inf}]),
    ("recovery_error", {}, [{"recovery_error": 0.5},
                            {"recovery_error": 0.95},
                            {"recovery_error": math.nan}]),
    ("byzantine", {"alarm_byzantine_ratio": 3.0},
     [{"client_norm_max": 2.0, "client_norm_mean": 1.0},
      {"client_norm_max": 5.0, "client_norm_mean": 1.0},
      {"client_norm_max": 1.0, "client_norm_mean": 0.0}]),
    ("fold_rejection", {"alarm_fold_rejection": 0.2},
     [{"fold_rejection_rate": 0.1}, {"fold_rejection_rate": 0.3}]),
    ("async_staleness", {"alarm_async_staleness": 2.0},
     [{"async_staleness_max": 1.0},
      {"async_staleness_max": 3.0, "async_buffer_occupancy": 0.5,
       "async_backlog": 4}]),
    ("privacy", {"dp": "sketch", "dp_epsilon": 1.0, "dp_noise_mult": 1.0,
                 "mode": "sketch", "probe_every": 0},
     [{"dp_epsilon": 0.5, "dp_rounds_left": 3},
      {"dp_epsilon": 1.0, "dp_delta": 1e-5, "dp_sigma": 1.0,
       "dp_rounds_left": 0}]),
]


@pytest.mark.parametrize("name,kw,probes", ALARM_CASES,
                         ids=[c[0] for c in ALARM_CASES])
def test_alarm_rules_fire_as_the_reference(name, kw, probes):
    cfg, jcfg = _cfgs(**kw)
    ours, theirs = (alarms.build_alarm_engine(cfg),
                    jax_alarms.build_alarm_engine(jcfg))
    fired = []
    for r, p in enumerate(probes):
        a, b = ours.check(r, dict(p)), theirs.check(r, dict(p))
        assert json.dumps(a) == json.dumps(b)
        fired += a
    assert fired


def test_step_time_and_collective_skew_rules_as_the_reference():
    cfg, jcfg = _cfgs(alarm_step_time_ratio=2.0, alarm_step_time_window=8,
                      alarm_collective_skew=0.5, probe_every=0)
    ours, theirs = (alarms.build_alarm_engine(cfg),
                    jax_alarms.build_alarm_engine(jcfg))
    for r, t in enumerate([1.0, 9.0, 1.0, 1.0, 1.0, 1.1, 3.0, 3.5, 1.0]):
        assert ours.check_step_time(r, t) == theirs.check_step_time(r, t)
    assert any(a["rule"] == "step_time_regression"
               for a in ours.check_step_time(9, 50.0))
    for b in ({"collective_s": 1.0, "skew": {"max_enter_delta_s": 0.6,
                                             "straggler_device": "cuda:1"}},
              {"collective_s": 1.0, "skew": {"max_enter_delta_s": 0.4}},
              {"collective_s": 0.0, "skew": {}}):
        assert ours.check_device_time(0, b) == theirs.check_device_time(0, b)
    assert alarms.build_alarm_engine(Config(device="cpu")) is None


def test_abort_raises_after_flagging_the_record():
    cfg, _ = _cfgs(on_divergence="abort")
    sink = ListSink()
    tel = core.Telemetry([sink])
    tel.begin_round(4)
    eng = alarms.AlarmEngine(cfg, telemetry=tel)
    with pytest.raises(alarms.DivergenceAbort) as exc:
        eng.check(4, {"agg_nan": 1.0})
    assert exc.value.round_index == 4 and "nan_inf" in str(exc.value)
    tel.close()
    assert sink.records[0]["alarms"][0]["action"] == "abort"


# --- a ResNet9 ledger run of both trainers --------------------------------

ARGV = ["--test", "--dataset_name", "Synthetic", "--mode", "sketch",
        "--error_type", "virtual", "--local_momentum", "0",
        "--virtual_momentum", "0.9", "--num_clients", "10",
        "--num_workers", "2", "--local_batch_size", "4",
        "--num_epochs", "4", "--lr_scale", "0.1", "--pivot_epoch", "1",
        "--seed", "5", "--probe_every", "2"]


@pytest.fixture(scope="module")
def ledger_runs(tmp_path_factory):
    """The JAX trainer's ledger and the port's at depth 1 and 3, the port
    started from the JAX trainer's initial weights."""
    tmp = tmp_path_factory.mktemp("ledgers")
    port_build = cv_train.build_model

    def build_model(args, device="cpu"):
        module, _ = port_build(args, device)
        _, params, _ = jax_cv_train.build_model(
            jax_parse_args(default_lr=cv_train.DEFAULT_LR, argv=ARGV))
        return module, module.from_jax_params(
            jax.tree_util.tree_map(np.asarray, params), device)

    cv_train.build_model = build_model
    try:
        from commefficient_tpu.runtime import fed_model as jfm
        from commefficient_tpu_torch.runtime import fed_model as tfm
        paths, updated = {}, {}
        for name, argv in (("ours", ["--device", "cpu"]),
                           ("ours3", ["--device", "cpu",
                                      "--pipeline_depth", "3"]),
                           ("theirs", [])):
            paths[name] = str(tmp / f"{name}.jsonl")
            run = jax_cv_train.main if name == "theirs" else cv_train.main
            run(argv + ARGV + ["--ledger", paths[name]])
            mod = jfm if name == "theirs" else tfm
            updated[name] = mod._CURRENT_MODEL.last_updated.copy()
    finally:
        cv_train.build_model = port_build
    out = {}
    for name, path in paths.items():
        with open(path) as f:
            out[name] = [json.loads(line) for line in f]
    return out, updated


def _close(a, b, what):
    assert sorted(a) == sorted(b), what
    for key in a:
        np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{what}: {key}")


def test_resnet9_ledger_matches_the_jax_trainers(ledger_runs):
    runs, updated = ledger_runs
    ours, theirs = runs["ours"], runs["theirs"]
    assert [r["kind"] for r in ours] == [r["kind"] for r in theirs]
    for rec in ours:
        assert jax_record.validate_record(rec) == [], rec
        assert record.validate_record(rec) == []
    rounds = [r for r in ours if r["kind"] == "round"]
    jrounds = [r for r in theirs if r["kind"] == "round"]
    assert [r["round"] for r in rounds] == [0, 1, 2, 3]
    for r, j in zip(rounds, jrounds):
        assert sorted(r) == sorted(j)
        assert sorted(r["spans"]) == sorted(j["spans"])
        # the round variants' first-dispatch stamps (vcompile_*:<key>)
        # match by name; their values are the port's own
        assert sorted(r["counters"]) == sorted(j["counters"])
        assert (r["uplink_bytes"], r["downlink_bytes"]) == \
            (j["uplink_bytes"], j["downlink_bytes"])
        _close(r["probes"], j["probes"], f"round {r['round']}")
        assert [a["rule"] for a in r["alarms"]] == \
            [a["rule"] for a in j["alarms"]]
        for a, b in zip(r["alarms"], j["alarms"]):
            _close({"v": a["value"]}, {"v": b["value"]}, a["rule"])
    # the recovery probe on the cadence rounds only
    assert ["recovery_error" in r["probes"] for r in rounds] == \
        [True, False, True, False]
    assert "residual_growth" in rounds[-1]["probes"]
    np.testing.assert_array_equal(updated["ours"], updated["theirs"])
    meta, jmeta = ours[0], theirs[0]
    assert sorted(meta) == sorted(jmeta)
    assert meta["plan"]["mode"] == jmeta["plan"]["mode"] == "sketch"
    epochs = [r for r in ours if r["kind"] == "epoch"]
    assert len(epochs) == 4
    assert sorted(epochs[0]["row"]) == sorted(
        [r for r in theirs if r["kind"] == "epoch"][0]["row"])


def test_pipelined_ledger_has_depth_1_probes(ledger_runs):
    runs, _ = ledger_runs
    one = [r for r in runs["ours"] if r["kind"] == "round"]
    three = [r for r in runs["ours3"] if r["kind"] == "round"]
    assert [r["round"] for r in three] == [r["round"] for r in one]
    for a, b in zip(one, three):
        assert a["probes"] == b["probes"]
        assert (a["uplink_bytes"], a["downlink_bytes"]) == \
            (b["uplink_bytes"], b["downlink_bytes"])

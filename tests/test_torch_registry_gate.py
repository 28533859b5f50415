"""The run registry (``telemetry/registry.py``) and the perf gate
(``telemetry/gate.py``, ``python -m commefficient_tpu_torch.perf_gate``)
against the reference's, on the CPU.

- On a port ledger from a small ``--profile`` run: every record
  validates under the reference's ``validate_record``;
  ``metrics_from_records``, ``compare`` (a baseline from the run, and
  the run slowed and sped up) and ``render_verdict`` JSON-equal to the
  reference gate's, and so are the baseline helpers and topology keys;
- manifests: written only for a run with ``--ledger`` and never under
  ``--test``, by process 0, atomically; the reference's readers
  (``run_key``, ``latest_ledgers``) read them as the port's do; the
  flight recorder stamps its bundle into the registry;
- the gate's exit codes: a capture, a passing check, a hard regression
  (1), a re-baseline refused over it (1) unless ``--force``, and the
  missing-baseline and empty-ledger failures.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import copy
import json
import os

import pytest

from commefficient_tpu.telemetry import gate as jax_gate
from commefficient_tpu.telemetry import registry as jax_registry
from commefficient_tpu.telemetry.record import \
    validate_record as jax_validate_record
from commefficient_tpu_torch import perf_gate
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.telemetry import gate, registry
from commefficient_tpu_torch.telemetry.flightrec import FlightRecorder
from commefficient_tpu_torch.train import cv_train

ARGV = ["--device", "cpu", "--test", "--dataset_name", "Synthetic",
        "--mode", "sketch", "--error_type", "virtual", "--local_momentum",
        "0", "--virtual_momentum", "0.9", "--num_clients", "10",
        "--num_workers", "2", "--local_batch_size", "4", "--num_epochs",
        "3", "--lr_scale", "0.1", "--pivot_epoch", "1", "--seed", "5"]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def ledger(tmp_path_factory):
    root = tmp_path_factory.mktemp("gate")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        path = str(root / "run.jsonl")
        cv_train.main(ARGV + ["--ledger", path, "--profile"])
    finally:
        os.chdir(cwd)
    return path


def _dumps(x):
    return json.dumps(x, sort_keys=True)


def _scaled(metrics, factor):
    out = copy.deepcopy(metrics)
    for entry in out.values():
        for key in ("median", "p50", "p95"):
            entry[key] = entry[key] * factor
    return out


def test_port_ledger_validates_under_the_reference(ledger):
    recs = _records(ledger)
    assert {r["kind"] for r in recs} >= {"meta", "round", "epoch"}
    for rec in recs:
        assert jax_validate_record(rec) == [], rec


def test_metrics_compare_and_verdict_equal_the_reference(ledger):
    recs = _records(ledger)
    ours, theirs = (gate.metrics_from_records(recs),
                    jax_gate.metrics_from_records(recs))
    assert _dumps(ours) == _dumps(theirs)
    assert any(k.startswith("span:") for k in ours)
    assert any(k.startswith("device:") for k in ours)
    base = gate.make_baseline(ours, source="a", device_count=1,
                              process_count=1, config_hash="c")
    jbase = jax_gate.make_baseline(theirs, source="a", device_count=1,
                                   process_count=1, config_hash="c")
    for b in (base, jbase):
        b["ts"] = 0.0
        for entry in b["topologies"].values():
            entry["ts"] = 0.0
    assert _dumps(base) == _dumps(jbase)
    for factor in (1.0, 3.0, 0.2):
        cur = _scaled(ours, factor)
        v = gate.compare(base, cur, device_count=1, process_count=1)
        jv = jax_gate.compare(jbase, cur, device_count=1, process_count=1)
        assert _dumps(v) == _dumps(jv)
        assert gate.render_verdict(v) == jax_gate.render_verdict(jv)
    slow = gate.compare(base, _scaled(ours, 3.0), device_count=1,
                        process_count=1)
    assert slow["regressions"]
    with pytest.raises(ValueError, match="no baseline entry"):
        gate.compare(base, ours, device_count=8, process_count=1)


@pytest.mark.parametrize("kw", [
    dict(), dict(device_count=1, process_count=1),
    dict(device_count=1, process_count=1, wire_dtype="int8", async_k=4),
    dict(device_count=2, process_count=1, overlap_depth=2, dp_epsilon=0.0),
    dict(wire_dtype="fp8"),
])
def test_topology_keys_and_baseline_entries_equal_the_reference(kw):
    assert gate.topology_key(**kw) == jax_gate.topology_key(**kw)
    metrics = {"span:x:ms": gate.summarize_samples([1.0, 2.0, 4.0],
                                                   "lower")}
    base = gate.update_baseline({}, metrics, **kw)
    jbase = jax_gate.update_baseline({}, metrics, **kw)
    assert set(base["topologies"]) == set(jbase["topologies"])
    assert gate.baseline_entry(base, **kw)["metrics"] == metrics
    old = {"schema": 1, "metrics": metrics, "source": "s"}
    assert gate.baseline_entry(old, **kw)["metrics"] == metrics
    assert gate.mad([1.0, 2.0, 4.0]) == jax_gate.mad([1.0, 2.0, 4.0])


def test_manifests_only_with_a_ledger_never_under_test(tmp_path,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    # a --test run with a ledger writes none
    cv_train.main(ARGV + ["--ledger", str(tmp_path / "t.jsonl")])
    assert registry.list_manifests("runs") == []
    cfg = Config(device="cpu")
    assert registry.maybe_write_manifest(cfg) is None
    assert registry.maybe_write_manifest(
        Config(device="cpu", do_test=True, ledger="x.jsonl")) is None
    assert registry.list_manifests("runs") == []
    led = tmp_path / "run.jsonl"
    led.write_text("")
    cfg = Config(device="cpu", ledger=str(led), sketch_dtype="int8")
    path = registry.maybe_write_manifest(cfg, mesh_shape={"clients": 1},
                                         extra={"trainer": "cv_train"})
    assert path and os.path.exists(path)
    assert not [n for n in os.listdir(os.path.dirname(path))
                if n.endswith(".tmp")]
    (_, m), = registry.list_manifests("runs")
    assert m["config_hash"] == registry.config_hash(cfg)
    assert m["config"] == registry.config_dict(cfg)
    assert "ledger" not in m["config"]   # an observability knob
    assert m["ledger"] == str(led) and m["trainer"] == "cv_train"
    assert (m["backend"], m["device_count"], m["process_count"],
            m["device_kind"]) == ("cpu", 1, 1, "cpu")
    assert "torch_version" in m and "jax_version" not in m
    # the reference's readers read the port's manifest as the port's do
    assert registry.run_key(m) == jax_registry.run_key(m)
    assert registry.run_key(m)[1:] == (1, 1, "qint8")
    assert [p for p, _, _ in registry.latest_ledgers("runs")] == \
        [p for p, _, _ in jax_registry.latest_ledgers("runs")] == [path]
    # rank 0 alone writes
    monkeypatch.setattr(registry, "_process_index", lambda: 1)
    assert registry.maybe_write_manifest(cfg) is None


def test_flight_recorder_stamps_its_bundle_into_the_registry(tmp_path,
                                                             monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = Config(device="cpu", flightrec_rounds=2, ledger="x.jsonl")
    rec = FlightRecorder(cfg, 2, labels={"run": "r"}, runs_dir="runs",
                         out_dir=str(tmp_path / "pm"))
    path = rec.dump("alarm", rule="nan_inf")
    with open(path) as f:
        bundle = json.load(f)
    (mpath, m), = registry.list_manifests("runs")
    assert bundle["manifest"] == os.path.abspath(mpath)
    assert m["postmortem"] == os.path.abspath(path)
    assert (m["postmortem_reason"], m["postmortem_rule"]) == ("alarm",
                                                             "nan_inf")
    assert bundle["config_hash"] == registry.config_hash(cfg)


def test_gate_cli_exit_codes_and_force(ledger, tmp_path, capsys):
    base = str(tmp_path / "base.json")
    assert perf_gate.main(["--ledger", ledger, "--check",
                           "--baseline", base]) == 1
    assert "missing" in capsys.readouterr().out
    assert perf_gate.main(["--ledger", ledger, "--write-baseline", base]) == 0
    assert perf_gate.main(["--ledger", ledger, "--baseline", base,
                           "--check"]) == 0
    assert "PASS" in capsys.readouterr().out
    # a baseline 10x faster than the run: a hard regression
    saved = json.load(open(base))
    for entry in saved["topologies"].values():
        for m in entry["metrics"].values():
            if m["better"] == "lower":
                m["median"] /= 10.0
                m["mad"] = 0.0
    json.dump(saved, open(base, "w"))
    assert perf_gate.main(["--ledger", ledger, "--baseline", base,
                           "--check"]) == 1
    assert "REGRESSION" in capsys.readouterr().out
    assert perf_gate.main(["--ledger", ledger, "--write-baseline",
                           base]) == 1
    assert "NOT writing" in capsys.readouterr().out
    assert json.load(open(base)) == saved
    assert perf_gate.main(["--ledger", ledger, "--write-baseline", base,
                           "--force"]) == 0
    assert perf_gate.main(["--ledger", ledger, "--baseline", base,
                           "--check"]) == 0
    # another topology point is ungated
    assert perf_gate.main(["--ledger", ledger, "--baseline", base,
                           "--check", "--device_count", "8"]) == 1
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert perf_gate.main(["--ledger", str(empty), "--check",
                           "--baseline", base]) == 1

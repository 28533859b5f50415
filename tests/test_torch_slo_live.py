"""Per-job SLOs and the live exporter of the port
(``commefficient_tpu_torch/telemetry/slo.py``, ``live.py``, the
``slo_burn``/``job_starvation``/``admission_rejected`` alarm rules and
the job-shard helpers of ``sinks.py``) against the JAX package.

- Both ``SLOEngine``s, fed one float stream, give equal burns, stamps
  and ``burning`` flags, exactly; ``SLOSpec.from_config`` reads the same
  spec from the same command line.
- ``LiveRegistry.render`` and a ``LiveMetricsSink`` fed one record
  stream give the reference's text, byte for byte.
- The exporter serves ``/metrics`` and ``/healthz`` on an ephemeral
  port; with every knob unset nothing is built.
- The three alarm rules fire with the reference's alarm dicts; the SLO
  rule warns under ``log`` and raises under ``--on_divergence abort``,
  through ``check_slo`` and through a FedModel run.
- The lock maps (``_LOCK_MAP``) hold: every write to, or iteration
  over, a declared attribute sits inside ``with <lock>:``.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import ast
import json
import os
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from commefficient_tpu.config import parse_args as jax_parse_args
from commefficient_tpu.telemetry import alarms as jax_alarms
from commefficient_tpu.telemetry import live as jax_live
from commefficient_tpu.telemetry import sinks as jax_sinks
from commefficient_tpu.telemetry import slo as jax_slo
from commefficient_tpu.telemetry.record import \
    make_round_record as jax_round_record
from commefficient_tpu_torch.config import Config, parse_args
from commefficient_tpu_torch.runtime.fed_model import FedModel, FedOptimizer
from commefficient_tpu_torch.telemetry import alarms, live, sinks, slo
from commefficient_tpu_torch.telemetry.core import Telemetry
from commefficient_tpu_torch.telemetry.record import make_round_record

from test_torch_modes import torch_linear_loss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> str:
    """A TCP port on 127.0.0.1 that nothing holds right now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


#: reads the exporter directly: no proxy from the environment
_DIRECT = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def urlopen(url):
    return _DIRECT.open(url, timeout=10)


@pytest.fixture(autouse=True)
def _fresh_plane():
    yield
    live.shutdown_plane()
    jax_live.shutdown_plane()


# --- the SLO engine ------------------------------------------------------


SPECS = {
    "latency": dict(round_p95_s=1.0, error_budget=0.05, window=16,
                    fast_window=4),
    "staleness": dict(staleness_max=2.0, error_budget=0.1, window=8,
                      fast_window=3),
    "privacy": dict(eps_horizon=10, eps_budget=1.0, window=4,
                    fast_window=2),
    "starvation": dict(starvation_ticks=3.0, window=6, fast_window=6),
    "all": dict(round_p95_s=0.9, staleness_max=1.0, eps_horizon=20,
                eps_budget=2.0, starvation_ticks=2.0, error_budget=0.25,
                window=12, fast_window=5),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_slo_engines_give_the_references_burns_and_stamps(name):
    ours = slo.SLOEngine(slo.SLOSpec(**SPECS[name]))
    theirs = jax_slo.SLOEngine(jax_slo.SLOSpec(**SPECS[name]))
    rs = np.random.RandomState(len(name))
    for i in range(64):
        sig = {}
        # each signal present on some rounds only: objectives advance
        # on their own streams
        if rs.rand() < 0.8:
            sig["round_s"] = float(rs.uniform(0.5, 1.5))
        if rs.rand() < 0.7:
            sig["staleness_max"] = float(rs.randint(0, 4))
        if rs.rand() < 0.9:
            sig["dp_epsilon"] = float(0.08 * (i + 1) * rs.uniform(0.8, 1.3))
        if rs.rand() < 0.6:
            sig["starved_ticks"] = float(rs.randint(0, 6))
        got, want = ours.observe(i, **sig), theirs.observe(i, **sig)
        assert got == want, i
        assert ours.stamp() == theirs.stamp(), i
        assert ours.burning == theirs.burning
        assert ours.last_burn == theirs.last_burn


@pytest.mark.parametrize("argv", [
    [], ["--slo_round_p95", "0.25"],
    ["--slo_staleness_max", "2", "--slo_window", "8",
     "--slo_fast_window", "2", "--slo_error_budget", "0.2"],
    ["--dp", "sketch", "--dp_noise_mult", "1.1", "--dp_epsilon", "4",
     "--slo_eps_rounds", "30"],
    ["--slo_starvation", "3"],
], ids=["off", "latency", "staleness", "privacy", "starvation"])
def test_slo_spec_from_the_command_line_is_the_references(argv):
    ours = slo.SLOSpec.from_config(parse_args(argv=argv))
    theirs = jax_slo.SLOSpec.from_config(jax_parse_args(None, argv))
    assert vars(ours) == vars(theirs)
    built = slo.build_slo_engine(parse_args(argv=argv))
    assert (built is None) == (jax_slo.build_slo_engine(
        jax_parse_args(None, argv)) is None) == (not argv)


def test_slo_engine_refuses_what_the_reference_refuses():
    for bad in (dict(), dict(round_p95_s=1.0, error_budget=0.0),
                dict(round_p95_s=1.0, window=2, fast_window=3)):
        with pytest.raises(AssertionError):
            slo.SLOEngine(slo.SLOSpec(**bad))
        with pytest.raises(AssertionError):
            jax_slo.SLOEngine(jax_slo.SLOSpec(**bad))


# --- the registry and its text ----------------------------------------


def _fill(reg):
    labels = {"job": 'we"ird\\job', "run": "r1"}
    reg.counter_add("c_total", 2, labels)
    reg.counter_add("c_total", 3, labels)
    reg.counter_add("c_total", 1.5, {"job": "b"})
    reg.gauge_set("g", -1.5, labels)
    reg.gauge_set("g", 1e-7, {"job": "line\nbreak"})
    for v in np.random.RandomState(0).uniform(0, 4, 300):
        reg.observe("s_seconds", float(v), labels)
    reg.observe("s_seconds", 2.0, {"job": "b"})


def test_registry_renders_the_references_text():
    ours, theirs = live.LiveRegistry(), jax_live.LiveRegistry()
    _fill(ours)
    _fill(theirs)
    text = ours.render()
    assert text == theirs.render()
    assert 's_seconds{job="b",quantile="0.95"} 2' in text
    assert 'job="we\\"ird\\\\job"' in text
    # the window keeps the last SUMMARY_WINDOW samples, the sum all
    snap = ours.snapshot()
    window, total, count = snap["summaries"]["s_seconds"][
        live._labels_key({"job": 'we"ird\\job', "run": "r1"})]
    assert len(window) == live.SUMMARY_WINDOW and count == 300


def _causal(r, wall):
    root = {"id": f"jsolo.r{r}.s0", "parent": None, "name": "round",
            "bucket": "host_other", "b": 0.0, "e": wall}
    kids = [{"id": f"jsolo.r{r}.s8", "parent": root["id"], "name": "h2d",
             "bucket": "h2d", "b": 0.1, "e": 0.3},
            {"id": f"jsolo.r{r}.s9", "parent": root["id"],
             "name": "round_dispatch", "bucket": "compute", "b": 0.3,
             "e": wall - 0.1}]
    return {"trace": f"jsolo.r{r}", "job": None, "round": r,
            "wall": wall, "spans": [root] + kids}


def _records(make):
    recs = [{"kind": "meta", "plan": {"num_workers": 8}}]
    for r in range(5):
        rec = make(r)
        rec.update(
            spans={"h2d": 0.25 * (r + 1), "server": 0.5},
            uplink_bytes=1000.0 * (r + 1),
            downlink_bytes=0.0 if r == 0 else 250.0,
            dp_epsilon=0.1 * r,
            probes={"async_staleness_max": float(r),
                    "job_backlog_total": 3.0 - r,
                    "slo_burn_round_latency": 0.5 * r,
                    "slo_burn_max": 0.5 * r},
            causal=_causal(r, 1.0 + r),
            alarms=([{"rule": "slo_burn", "value": 10.0}]
                    if r % 2 else []))
        recs.append(rec)
    recs.append({"kind": "summary", "alarm_fired": {"slo_burn": 2}})
    return recs


def test_live_sink_renders_the_references_scrape():
    ours, theirs = live.LiveRegistry(), jax_live.LiveRegistry()
    labels = {"job": 0, "process": 0, "run": "abcd1234"}
    sink = live.LiveMetricsSink(ours, labels)
    jsink = jax_live.LiveMetricsSink(theirs, labels)
    for rec, jrec in zip(_records(make_round_record),
                         _records(jax_round_record)):
        sink.write(rec)
        jsink.write(jrec)
    text = ours.render()
    assert text == theirs.render()
    for series in ("commeff_rounds_total", "commeff_round_seconds_count",
                   'commeff_slo_burn{job="0",objective="round_latency"',
                   'commeff_critpath_seconds{bucket="compute"',
                   'commeff_alarms_total{job="0"',
                   "commeff_alarms_run_total", "commeff_clients_per_s"):
        assert series in text, series


# --- the exporter ------------------------------------------------------


def test_exporter_serves_metrics_and_healthz():
    reg = live.LiveRegistry()
    reg.counter_add(live.PREFIX + "rounds_total", 7, {"job": "a"})
    server = live.LiveServer(reg, port=0)
    try:
        assert server.host == "127.0.0.1" and server.port > 0
        with urlopen(server.url + "/metrics") as resp:
            assert "version=0.0.4" in resp.headers["Content-Type"]
            body = resp.read().decode()
        assert f'{live.PREFIX}rounds_total{{job="a"}} 7' in body
        with urlopen(server.url + "/healthz") as resp:
            assert resp.read() == b"ok\n"
        with pytest.raises(urllib.error.HTTPError):
            urlopen(server.url + "/nope")
    finally:
        server.close()


def test_plane_off_is_never_constructed():
    tel = Telemetry()
    assert live.attach_live_plane(tel, Config(device="cpu")) == (None, None)
    assert not tel.enabled
    assert live._PLANE == {"registry": None, "server": None}


def test_one_exporter_a_process_whatever_the_ports():
    port = int(free_port())
    first = live.ensure_server(port)
    assert live.ensure_server(port + 1) is first
    tel = Telemetry()
    sink, rec = live.attach_live_plane(
        tel, Config(device="cpu", live_port=port + 2), labels={"job": 1})
    assert rec is None and isinstance(sink, live.LiveMetricsSink)
    assert sink.registry is live.live_registry() and tel.enabled
    live.shutdown_plane()
    assert live._PLANE == {"registry": None, "server": None}


def _linear_model(tmp_path, **kw):
    cfg = Config(device="cpu", mode="uncompressed", error_type="none",
                 local_momentum=0.0, virtual_momentum=0.0,
                 weight_decay=0.0, num_workers=2, local_batch_size=2,
                 num_clients=8, seed=3, **kw)
    model = FedModel(None, torch.zeros(4),
                     lambda p, b, a: torch_linear_loss(p, b), cfg,
                     padded_batch_size=2)
    return model, FedOptimizer([{"lr": 0.1}], cfg, model=model)


def _linear_batch(r):
    rs = np.random.RandomState(r)
    return {"client_ids": np.array([r % 8, (r + 3) % 8], np.int32),
            "x": rs.randn(2, 2, 4).astype(np.float32),
            "y": rs.randn(2, 2).astype(np.float32),
            "mask": np.ones((2, 2), np.float32)}


def test_a_fedmodel_run_is_scraped_live(tmp_path):
    """--live_port: the exporter serves the run's rounds and its SLO
    burn while the run goes on; the job label comes from a job shard's
    ledger path."""
    port = free_port()
    ledger = str(tmp_path / "svc.jsonl.job2.jsonl")
    model, opt = _linear_model(tmp_path, live_port=int(port),
                               ledger=ledger, slo_round_p95=1e-9,
                               slo_window=2, slo_fast_window=1)
    assert model.live_sink.labels["job"] == "2"
    for r in range(3):
        model(_linear_batch(r))
        opt.step()
    model.telemetry.begin_round(3)  # closes (and emits) round 2
    with urlopen(f"http://127.0.0.1:{port}/metrics") as resp:
        text = resp.read().decode()
    model.finalize()
    assert 'commeff_rounds_total{job="2",process="0"' in text
    assert 'commeff_slo_burn{job="2",objective="round_latency"' in text
    assert "commeff_uplink_bytes_total" in text


# --- the alarm rules -----------------------------------------------------


def _both_engines(argv):
    return (alarms.AlarmEngine(parse_args(argv=argv)),
            jax_alarms.AlarmEngine(jax_parse_args(None, argv)))


@pytest.mark.parametrize("probes", [
    {}, {"slo_burn_max": 1.9, "slo_burn_round_latency": 1.9},
    {"slo_burn_max": 12.0, "slo_burn_round_latency": 12.0,
     "slo_burn_staleness": 0.5},
    {"slo_burn_max": float("nan")},
], ids=["empty", "under", "over", "nan"])
def test_slo_rule_fires_as_the_references(probes):
    argv = ["--alarm_slo_burn", "2", "--slo_round_p95", "0.1",
            "--slo_window", "4", "--slo_fast_window", "2"]
    ours, theirs = _both_engines(argv)
    got, want = ours.check_slo(3, dict(probes)), \
        theirs.check_slo(3, dict(probes))
    assert json.dumps(got) == json.dumps(want)
    if probes.get("slo_burn_max", 0) > 2:
        # the alarm names WHICH objective burns
        assert got[0]["slo_burn_round_latency"] == 12.0
        assert got[0]["slo_burn_staleness"] == 0.5


@pytest.mark.parametrize("probes", [
    {"job_starved_rounds": 2.0, "job_starved_index": 1.0},
    {"job_starved_rounds": 3.0, "job_starved_index": 1.0,
     "job_occupancy_min": 0.25},
    {"admission_rejected": 1.0, "job_active": 2.0},
    {"admission_rejected": 0.0},
    {"slo_burn_max": 4.0, "job_starved_rounds": 9.0,
     "admission_rejected": 2.0},
], ids=["starved_at", "starved_over", "rejected", "none", "all"])
def test_service_rules_fire_as_the_references(probes):
    argv = ["--alarm_job_starvation", "2", "--alarm_slo_burn", "3"]
    ours, theirs = _both_engines(argv)
    assert json.dumps(ours.check(5, dict(probes))) == \
        json.dumps(theirs.check(5, dict(probes)))
    # admission_rejected is armed on any engine, like nan_inf
    bare = alarms.AlarmEngine(parse_args(argv=[]))
    assert [a["rule"] for a in bare.check(0, {"admission_rejected": 1.0})] \
        == ["admission_rejected"]


def test_build_alarm_engine_arms_on_the_new_rules():
    for argv in (["--alarm_job_starvation", "1"],
                 ["--alarm_slo_burn", "1"]):
        assert alarms.build_alarm_engine(parse_args(argv=argv)) is not None
        assert jax_alarms.build_alarm_engine(
            jax_parse_args(None, argv)) is not None
    assert alarms.build_alarm_engine(parse_args(argv=[])) is None


def test_slo_alarm_warns_then_aborts_a_fedmodel_run(tmp_path, caplog):
    """An SLO below every round's wall burns from the first round after
    the fast window: the slo_burn rule warns under ``log`` (the run goes
    on, each round's record flagged) and raises ``DivergenceAbort`` at
    that round under ``--on_divergence abort``."""
    ledger = str(tmp_path / "log.jsonl")
    model, opt = _linear_model(tmp_path, slo_round_p95=1e-9,
                               slo_window=3, slo_fast_window=2,
                               alarm_slo_burn=1.0, ledger=ledger)
    with caplog.at_level("WARNING"):
        for r in range(3):
            model(_linear_batch(r))
            opt.step()
    model.finalize()
    assert sum("slo_burn" in m for m in caplog.messages) == 2
    with open(ledger) as f:
        rounds = [r for r in map(json.loads, f) if r["kind"] == "round"]
    assert [[a["rule"] for a in r["alarms"]] for r in rounds] == \
        [[], ["slo_burn"], ["slo_burn"]]
    assert rounds[1]["alarms"][0]["slo_burn_round_latency"] == 20.0
    assert rounds[1]["probes"]["slo_burn_max"] == 20.0
    model, opt = _linear_model(tmp_path, slo_round_p95=1e-9,
                               slo_window=3, slo_fast_window=2,
                               alarm_slo_burn=1.0, on_divergence="abort")
    model(_linear_batch(0))
    opt.step()
    with pytest.raises(alarms.DivergenceAbort, match="slo_burn") as exc:
        model(_linear_batch(1))
    assert exc.value.round_index == 1
    model.interrupted()
    model.finalize()


# --- the job shards ------------------------------------------------------


@pytest.mark.parametrize("path", [
    "runs/svc.jsonl.job3.jsonl", "runs/svc.jsonl.job3.jsonl.p1.jsonl",
    "runs/svc.jsonl", "", None, "a.job12.jsonl"])
def test_job_index_of_ledger_is_the_references(path):
    assert sinks.job_index_of_ledger(path) == \
        jax_sinks.job_index_of_ledger(path)
    if path:
        assert sinks.job_ledger_path(path, 4) == \
            jax_sinks.job_ledger_path(path, 4)


def test_recover_ledger_shards_sweeps_job_and_process_shards(tmp_path):
    base = str(tmp_path / "svc.jsonl")
    dropped = {}
    for i, path in enumerate([base, base + ".job0.jsonl",
                              base + ".job1.jsonl",
                              base + ".p1.jsonl"]):
        with open(path, "w") as f:
            f.write('{"kind":"round"}\n')
            if i != 1:
                f.write('{"kind":"ro')   # a torn tail
                dropped[path] = 11
    assert sinks.recover_ledger_shards(base) == dropped
    assert sinks.recover_ledger_shards(base) == {}
    for path in dropped:
        with open(path) as f:
            assert f.read() == '{"kind":"round"}\n'
    assert sinks.recover_ledger_shards("") == {}


# --- the lock maps -------------------------------------------------------


_MUTATORS = {"append", "extend", "pop", "popitem", "setdefault",
             "update", "clear", "remove", "insert", "move_to_end"}


def _lock_violations(path):
    """Writes to, and iterations over, the attributes a module's
    ``_LOCK_MAP`` declares that are not lexically inside ``with`` on
    the declared lock (module level and constructors excepted: nothing
    else sees the object yet)."""
    tree = ast.parse(open(path).read())
    lock_map = None
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_LOCK_MAP"
                for t in node.targets):
            lock_map = ast.literal_eval(node.value)
    assert lock_map, path

    def names(node):
        if isinstance(node, ast.Attribute):
            return {node.attr} | names(node.value)
        if isinstance(node, ast.Name):
            return {node.id}
        if isinstance(node, ast.Subscript):
            return names(node.value)
        return set()

    bad = []

    def visit(node, held, in_init):
        if isinstance(node, ast.With):
            held = held | {n for item in node.items
                           for n in names(item.context_expr)}
        if isinstance(node, ast.FunctionDef):
            in_init = node.name == "__init__"
        touched = set()
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (node.targets if isinstance(node, (ast.Assign,
                                                         ast.Delete))
                       else [node.target])
            for t in targets:
                touched |= names(t)
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            touched |= names(node.func.value)
        elif isinstance(node, (ast.For, ast.comprehension)):
            touched |= names(node.iter)
        for attr in touched & set(lock_map):
            if lock_map[attr] not in held and not in_init:
                bad.append((path, node.lineno, attr))
        for child in ast.iter_child_nodes(node):
            visit(child, held, in_init)

    visit(tree, frozenset(), True)
    return bad


@pytest.mark.parametrize("module", ["telemetry/live.py", "telemetry/sinks.py",
                                    "fedservice/service.py"])
def test_lock_maps_hold(module):
    path = os.path.join(ROOT, "commefficient_tpu_torch", module)
    assert _lock_violations(path) == []


def test_lock_scan_rejects_an_unlocked_write(tmp_path):
    src = ('_LOCK_MAP = {"_jobs": "_lock"}\n'
           "class S:\n"
           "    def __init__(self):\n"
           "        self._jobs = []\n"
           "    def ok(self):\n"
           "        with self._lock:\n"
           "            self._jobs.append(1)\n"
           "            return [j for j in self._jobs]\n"
           "    def bad(self):\n"
           "        self._jobs.append(2)\n"
           "        for j in self._jobs:\n"
           "            pass\n"
           "        self._jobs = []\n")
    path = tmp_path / "m.py"
    path.write_text(src)
    assert [(line, attr) for _, line, attr in _lock_violations(str(path))] \
        == [(10, "_jobs"), (11, "_jobs"), (13, "_jobs")]

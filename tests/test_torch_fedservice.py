"""The multi-tenant job service of the port
(``commefficient_tpu_torch/fedservice/``) against the JAX package.

- Two ``test_modes.linear_loss`` tenants under ``fair`` and under
  ``backlog``: both packages give the same fairness probes at every
  tick, exactly (the service ledger's tick records), job shards with
  the same record keys, and final weights at rtol 1e-5 / atol 1e-6.
- Control plane only: a tenant through the service is bit-equal to its
  solo run, weights and ledger records (wall-clock fields aside).
- Refused admissions (a colliding seed or id, a spatial demand past the
  pod, DP without a budget) are counted and fire ``admission_rejected``;
  the backlog policy starves a tenant into ``job_starvation``; a service
  SLO burns and flags a later admission.
- The device rule: ``(1, 1)`` reserves a device and gives it back; a
  demand of two runs on a block in worker processes
  (tests/test_torch_fedservice_spatial.py holds those to the reference)
  and a job migrates onto one; on one card a demand of two is refused.
  Migration to and from a reserved device is exact.
- Per-job manifests, the single-writer ledger guard, the causal
  admission/grant spans stitched into the tenants' traces, one live
  scrape carrying the service's and the tenants' series, and the
  scheduler lock under probe threads.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.fedservice import FedService as JaxFedService
from commefficient_tpu.fedservice import JobSpec as JaxJobSpec
from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.runtime.fed_model import FedOptimizer as JaxFedOpt
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.fedservice import (AdmissionError, FedService,
                                                JobSpec)
from commefficient_tpu_torch.runtime.fed_model import FedModel, FedOptimizer
from commefficient_tpu_torch.telemetry import live, registry
from commefficient_tpu_torch.telemetry.causal import (assemble_traces,
                                                      trace_id)
from commefficient_tpu_torch.telemetry.sinks import (JSONLSink,
                                                     job_ledger_path)

import torch_mesh_workers as workers
from test_modes import linear_loss
from test_torch_modes import torch_linear_loss
from test_torch_slo_live import free_port, urlopen

W, B, DIM, NUM_CLIENTS = 4, 2, 48, 32
CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
#: wall-clock and host fields that differ between a solo run and a
#: service-interleaved one
NONDET_KEYS = ("ts", "spans", "counters", "device_time",
               "host_rss_peak_bytes", "hbm_peak_bytes")

JOB = dict(mode="local_topk", error_type="local", local_momentum=0.9,
           virtual_momentum=0.0, weight_decay=0.0, k=8, num_workers=W,
           local_batch_size=B, num_clients=NUM_CLIENTS)
SVC = dict(num_workers=W, local_batch_size=B, num_clients=NUM_CLIENTS)


def _job_cfg(seed, ledger="", **kw):
    return Config(device="cpu", seed=seed, ledger=ledger,
                  **dict(JOB, **kw))


def _svc_cfg(ledger="", **kw):
    return Config(device="cpu", ledger=ledger, **dict(SVC, **kw))


def _builder(cfg, device):
    model = FedModel(None, torch.zeros(DIM),
                     lambda p, b, a: torch_linear_loss(p, b), cfg,
                     padded_batch_size=B)
    assert device in (None, CPU) and model.device == CPU
    return model, FedOptimizer([{"lr": 0.25}], cfg, model=model)


def _jax_builder(cfg, mesh):
    model = JaxFedModel(None, {"p": jnp.zeros(DIM, jnp.float32)},
                        lambda p, b, a: linear_loss(p["p"], b), cfg,
                        padded_batch_size=B,
                        mesh=mesh or make_mesh([jax.devices()[0]]))
    return model, JaxFedOpt([{"lr": 0.25}], cfg, model=model)


def _batches(seed, n):
    rs = np.random.RandomState(seed)
    return [{"client_ids": rs.choice(NUM_CLIENTS, W, replace=False)
             .astype(np.int32),
             "x": rs.randn(W, B, DIM).astype(np.float32),
             "y": rs.randn(W, B).astype(np.float32),
             "mask": np.ones((W, B), np.float32)} for _ in range(n)]


def _jax_batches(seed, n):
    return [{k: v if k == "client_ids" else jnp.asarray(v)
             for k, v in b.items()} for b in _batches(seed, n)]


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _canon(path):
    return [{k: v for k, v in rec.items() if k not in NONDET_KEYS}
            for rec in _read(path) if rec.get("kind") == "round"]


def _solo(seed, batches, ledger=""):
    model, opt = _builder(_job_cfg(seed, ledger), None)
    for batch in batches:
        model(batch)
        opt.step()
    final = model.ps_weights.numpy().copy()
    model.finalize()
    return final


# --- parity with the reference's service --------------------------------


TENANTS = [("big", 3, 7, 6), ("small", 4, 9, 2)]


@pytest.mark.parametrize("policy", ["fair", "backlog"])
def test_service_is_the_references(tmp_path, policy):
    led, jled = str(tmp_path / "svc.jsonl"), str(tmp_path / "jsvc.jsonl")
    svc = FedService(_svc_cfg(led, alarm_job_starvation=2), policy=policy,
                     devices=[CPU])
    jsvc = JaxFedService(JaxConfig(ledger=jled, alarm_job_starvation=2,
                                   **SVC), policy=policy,
                         devices=jax.devices()[:1])
    for job_id, seed, bseed, rounds in TENANTS:
        bs, jbs = _batches(bseed, rounds), _jax_batches(bseed, rounds)
        svc.admit(JobSpec(job_id, _job_cfg(seed), _builder,
                          lambda r, bs=bs: bs[r], rounds=rounds))
        jsvc.admit(JaxJobSpec(job_id, JaxConfig(seed=seed, **JOB),
                              _jax_builder, lambda r, bs=jbs: bs[r],
                              rounds=rounds))
    fired, jfired = [], []
    while svc.active_jobs() or jsvc.active_jobs():
        fired += svc.tick()
        jfired += jsvc.tick()
    weights = {j: svc.job_state(j) for j, *_ in TENANTS}
    jweights = {j: jsvc.job_state(j) for j, *_ in TENANTS}
    assert svc._ticks == jsvc._ticks
    svc.close()
    jsvc.close()
    ticks = [r for r in _read(led) if r["kind"] == "round"]
    jticks = [r for r in _read(jled) if r["kind"] == "round"]
    assert [r["probes"] for r in ticks] == [r["probes"] for r in jticks]
    assert [[a["rule"] for a in r["alarms"]] for r in ticks] == \
        [[a["rule"] for a in r["alarms"]] for r in jticks]
    assert json.dumps(fired) == json.dumps(jfired)
    assert bool(fired) == (policy == "backlog")
    for j, (job_id, *_, rounds) in enumerate(TENANTS):
        np.testing.assert_allclose(weights[job_id],
                                   np.asarray(jweights[job_id]),
                                   rtol=RTOL, atol=ATOL)
        shard = _read(job_ledger_path(led, j))
        jshard = _read(job_ledger_path(jled, j))
        assert [r["kind"] for r in shard] == [r["kind"] for r in jshard]
        for r, jr in zip(shard, jshard):
            assert sorted(r) == sorted(jr)
        assert sum(r["kind"] == "round" for r in shard) == rounds
    meta = [r for r in _read(led) if r["kind"] == "meta"][-1]
    jmeta = [r for r in _read(jled) if r["kind"] == "meta"][-1]
    for key in ("service_jobs", "service_policy", "service_ticks",
                "service_rejected", "pod_devices"):
        assert meta[key] == jmeta[key], key


@pytest.mark.parametrize("policy", ["fair", "backlog"])
def test_a_tenant_is_bit_equal_to_its_solo_run(tmp_path, policy):
    solo_leds = [str(tmp_path / f"solo{j}.jsonl") for j in range(2)]
    solo = [_solo(seed, _batches(bseed, rounds), solo_leds[j])
            for j, (_, seed, bseed, rounds) in enumerate(TENANTS)]
    led = str(tmp_path / "svc.jsonl")
    svc = FedService(_svc_cfg(led), policy=policy, devices=[CPU])
    for job_id, seed, bseed, rounds in TENANTS:
        bs = _batches(bseed, rounds)
        svc.admit(JobSpec(job_id, _job_cfg(seed), _builder,
                          lambda r, bs=bs: bs[r], rounds=rounds))
    svc.run()
    got = [svc.job_state(j) for j, *_ in TENANTS]
    svc.close()
    for j in range(2):
        assert np.array_equal(got[j], solo[j])
        assert _canon(job_ledger_path(led, j)) == _canon(solo_leds[j])


# --- admission -------------------------------------------------------------


def test_refused_admissions_are_counted_and_alarmed(tmp_path):
    led = str(tmp_path / "svc.jsonl")
    svc = FedService(_svc_cfg(led), devices=[CPU])
    bs = _batches(7, 2)
    svc.admit(JobSpec("a", _job_cfg(3), _builder, lambda r: bs[r],
                      rounds=2))
    bad = [JobSpec("a", _job_cfg(5), _builder, lambda r: None, rounds=1),
           JobSpec("b", _job_cfg(3), _builder, lambda r: None, rounds=1),
           JobSpec("c", _job_cfg(6), _builder, lambda r: None, rounds=1,
                   mesh_demand=(2, 1)),
           JobSpec("d", _job_cfg(7, dp="sketch", dp_noise_mult=1.0,
                                 mode="sketch", error_type="virtual",
                                 local_momentum=0.0),
                   _builder, lambda r: None, rounds=1),
           JobSpec("", _job_cfg(8), _builder, lambda r: None, rounds=1),
           JobSpec("e", _job_cfg(8), _builder, lambda r: None, rounds=0)]
    for spec in bad:
        with pytest.raises(AdmissionError):
            svc.admit(spec)
    assert svc._rejected == len(bad) and svc.active_jobs() == 1
    svc.run()
    svc.close()
    recs = _read(led)
    rejected = [r for r in recs if r["kind"] == "round"
                and r["probes"].get("admission_rejected")]
    assert len(rejected) == len(bad)
    assert all([a["rule"] for a in r["alarms"]] == ["admission_rejected"]
               for r in rejected)
    summary = [r for r in recs if r["kind"] == "summary"][0]
    assert summary["alarm_fired"] == {"admission_rejected": len(bad)}


def test_backlog_policy_starves_into_the_alarm(tmp_path):
    led = str(tmp_path / "svc.jsonl")
    svc = FedService(_svc_cfg(led, alarm_job_starvation=2),
                     policy="backlog", devices=[CPU])
    big, small = _batches(7, 8), _batches(9, 2)
    svc.admit(JobSpec("big", _job_cfg(3), _builder, lambda r: big[r],
                      rounds=8))
    svc.admit(JobSpec("small", _job_cfg(4), _builder, lambda r: small[r],
                      rounds=2))
    fired = []
    for _ in range(5):
        fired += svc.tick()
    svc.close()
    starve = [a for a in fired if a["rule"] == "job_starvation"]
    assert starve and starve[0]["job"] == 1.0 and starve[0]["value"] == 3.0
    fair = FedService(_svc_cfg(alarm_job_starvation=2), devices=[CPU])
    for j, seed in ((0, 3), (1, 4)):
        bs = _batches(7 + j, 3)
        fair.admit(JobSpec(f"j{j}", _job_cfg(seed), _builder,
                           lambda r, bs=bs: bs[r], rounds=3))
    fired = []
    while fair.active_jobs():
        fired += fair.tick()
    fair.close()
    assert not fired


def test_a_burning_service_slo_flags_the_next_admission(tmp_path, capsys):
    led = str(tmp_path / "svc.jsonl")
    svc = FedService(_svc_cfg(led, slo_starvation=1.0, slo_window=4,
                              slo_fast_window=2, alarm_slo_burn=1.0),
                     policy="backlog", devices=[CPU])
    big, small = _batches(7, 10), _batches(9, 2)
    svc.admit(JobSpec("big", _job_cfg(3), _builder, lambda r: big[r],
                      rounds=10))
    svc.admit(JobSpec("small", _job_cfg(4), _builder, lambda r: small[r],
                      rounds=2))
    fired = []
    for _ in range(5):
        fired += svc.tick()
    burn = [a for a in fired if a["rule"] == "slo_burn"]
    assert burn and burn[0]["slo_burn_starvation"] == burn[0]["value"] >= 1
    assert svc.slo_burning_jobs() == ["service"]
    late = _batches(11, 1)
    svc.admit(JobSpec("late", _job_cfg(5), _builder, lambda r: late[r],
                      rounds=1))
    assert "burning their SLO error budget" in capsys.readouterr().out
    svc.close()
    recs = _read(led)
    assert any(r["kind"] == "round" and (r.get("slo") or {}).get(
        "starvation") for r in recs)
    metas = [r for r in recs if r.get("slo_burning_at_admission")]
    assert metas and metas[0]["admitted_job"] == "late"


# --- devices and migration -----------------------------------------------


def test_one_card_reservation_and_the_multi_gpu_rule():
    """A (1, 1) demand reserves a device in the daemon; a (1, 2) demand
    runs on a block of two in worker processes; a job migrates from one
    card onto a block of two; on one card a demand of two is refused."""
    pod = [CPU, torch.device("cpu", 1), torch.device("cpu", 2)]
    svc = FedService(_svc_cfg(), devices=pod)
    bs = _batches(7, 2)
    svc.admit(JobSpec("a", _job_cfg(3), workers.service_builder,
                      lambda r: bs[r], rounds=2, mesh_demand=(1, 1)))
    assert svc._jobs[0].device == CPU and svc._free == pod[1:]
    svc.admit(JobSpec("b", _job_cfg(4, mode="uncompressed",
                                    error_type="none", local_momentum=0.0),
                      workers.service_builder, lambda r: None, rounds=1,
                      mesh_demand=(1, 2)))
    assert svc._jobs[1].spatial is not None and svc._free == []
    assert svc._rejected == 0 and svc._admitted == 2
    svc.tick()
    # b ran out of work and gave its block back
    assert svc._jobs[1].done and svc._free == pod[1:]
    before = svc.job_state("a")
    svc.migrate("a", mesh_demand=(2, 1))
    assert svc._jobs[0].spatial is not None and svc._free == [CPU]
    assert np.array_equal(before, svc.job_state("a"))
    svc.run()
    assert sorted(map(str, svc._free)) == sorted(map(str, pod))
    svc.close()
    # on one card the reference's capacity check refuses it first
    one = FedService(_svc_cfg(), devices=[CPU])
    with pytest.raises(AdmissionError, match="needs 2 devices"):
        one.admit(JobSpec("c", _job_cfg(5), _builder, lambda r: None,
                          rounds=1, mesh_demand=(2, 1)))
    assert one._rejected == 1
    one.close()


def test_a_tenant_is_pinned_to_one_card(monkeypatch):
    """On a machine with several cards a tenant's own --num_devices
    (-1: every visible card) would build a mesh: the service pins each
    tenant to the one card it places it on (on one card, as in the other
    tests here, the tenant's config is left as it is)."""
    from commefficient_tpu_torch.parallel import mesh as pm
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    job = Config(device="cuda", seed=3, **JOB)
    assert job.num_devices == -1 and job.on_mesh
    seen = []

    def builder(cfg, device):
        seen.append((cfg.num_devices, cfg.on_mesh, pm.resolve_world(cfg),
                     pm.build_mesh(cfg)))
        return _builder(dataclasses.replace(cfg, device="cpu"), device)

    svc = FedService(_svc_cfg(), devices=[CPU])
    bs = _batches(7, 1)
    svc.admit(JobSpec("a", job, builder, lambda r: bs[r], rounds=1,
                      mesh_demand=(1, 1)))
    svc.run()
    svc.close()
    assert seen == [(1, False, 1, None)]


def test_migration_is_exact(tmp_path):
    R = 6
    batches = _batches(7, R)
    solo = _solo(3, batches)
    led = str(tmp_path / "svc.jsonl")
    svc = FedService(_svc_cfg(led), ckpt_dir=str(tmp_path / "ckpt"),
                     devices=[CPU])
    svc.admit(JobSpec("m", _job_cfg(3), _builder, lambda r: batches[r],
                      rounds=R, mesh_demand=(1, 1)))
    svc.tick()
    svc.tick()
    before = svc.job_state("m")
    svc.migrate("m", mesh_demand=None)
    assert np.array_equal(before, svc.job_state("m"))
    assert svc._free == [CPU]
    svc.tick()
    svc.migrate("m", mesh_demand=(1, 1))
    assert svc._free == []
    svc.run()
    got = svc.job_state("m")
    svc.close()
    assert np.array_equal(got, solo)
    shard = [r["round"] for r in _read(job_ledger_path(led, 0))
             if r["kind"] == "round"]
    assert shard == list(range(R))
    with pytest.raises(ValueError, match="already finished"):
        svc.migrate("m")
    with pytest.raises(KeyError, match="no admitted job"):
        svc.job_state("zzz")


# --- registry, sinks, tracing, the live plane, locks ------------------------


def test_per_job_manifests(tmp_path):
    led, runs = str(tmp_path / "svc.jsonl"), str(tmp_path / "runs")
    svc = FedService(_svc_cfg(led), runs_dir=runs, devices=[CPU])
    for j, seed in enumerate((3, 4)):
        bs = _batches(7 + j, 2)
        svc.admit(JobSpec(f"t{j}", _job_cfg(seed), _builder,
                          lambda r, bs=bs: bs[r], rounds=2))
    svc.run()
    svc.close()
    hits = registry.latest_ledgers(runs, n=5, job="t0")
    assert len(hits) == 1
    _, manifest, ledger = hits[0]
    assert registry.run_job_id(manifest) == "t0"
    assert manifest["service_run"] is True
    # the builder stamps the model's size on the config, as a solo run
    cfg = _job_cfg(3)
    cfg.grad_size = DIM
    assert manifest["config_hash"] == registry.config_hash(cfg)
    assert ledger.endswith(".job0.jsonl")
    assert len(registry.latest_ledgers(runs, n=5)) == 2


def test_single_writer_guard(tmp_path):
    path = str(tmp_path / "led.jsonl")
    sink = JSONLSink(path)
    with pytest.raises(RuntimeError, match="already has a live"):
        JSONLSink(path)
    sink.close()
    JSONLSink(path).close()
    shards = [JSONLSink(job_ledger_path(path, j)) for j in range(2)]
    for s in shards:
        s.close()
    # a tenant builder that ignored the shard and opened the service's
    # own ledger is refused by the guard
    led = str(tmp_path / "svc.jsonl")
    svc = FedService(_svc_cfg(led), devices=[CPU])

    def rogue(cfg, device):
        return _builder(_job_cfg(9, led), device)

    with pytest.raises(RuntimeError, match="already has a live"):
        svc.admit(JobSpec("r", _job_cfg(9), rogue, lambda r: None,
                          rounds=1))
    svc.close()


def test_grants_stitch_into_the_tenants_traces(tmp_path):
    R = 2
    led = str(tmp_path / "svc.jsonl")
    svc = FedService(_svc_cfg(led, causal_trace=True), devices=[CPU])
    for j, seed in enumerate((3, 4)):
        bs = _batches(7 + j, R)
        svc.admit(JobSpec(f"t{j}", _job_cfg(seed), _builder,
                          lambda r, bs=bs: bs[r], rounds=R))
    svc.run()
    svc.close()
    recs = _read(led) + _read(job_ledger_path(led, 0)) + \
        _read(job_ledger_path(led, 1))
    traces = assemble_traces(recs)
    for j in range(2):
        for r in range(R):
            t = traces[trace_id(j, r)]
            assert t["orphans"] == [], (j, r)
            names = {s["name"] for s in t["spans"].values()}
            assert {"sched_grant", "round"} <= names, names
        assert any(s["name"] == "admission"
                   for s in traces[trace_id(j, 0)]["spans"].values())


def test_one_scrape_carries_the_service_and_its_tenants(tmp_path):
    port = free_port()
    led = str(tmp_path / "svc.jsonl")
    svc = FedService(_svc_cfg(led, live_port=int(port), flightrec_rounds=4,
                              postmortem_dir=str(tmp_path / "pm")),
                     devices=[CPU])
    try:
        for j, seed in enumerate((3, 4)):
            bs = _batches(7 + j, 2)
            svc.admit(JobSpec(f"t{j}", _job_cfg(seed), _builder,
                              lambda r, bs=bs: bs[r], rounds=2))
        job = svc._jobs[0]
        assert job.model.live_sink.labels["job"] == "0"
        assert job.model.flightrec.out_dir == str(tmp_path / "pm")
        svc.run()
        with urlopen(f"http://127.0.0.1:{port}/metrics") as resp:
            text = resp.read().decode()
    finally:
        svc.close()
        live.shutdown_plane()
    assert 'commeff_rounds_total{job="service"}' in text
    for j in ("0", "1"):
        assert f'commeff_rounds_total{{job="{j}",process="0"' in text
    assert 'commeff_job_active{job="service"}' in text


def test_scheduler_lock_under_probe_threads():
    svc = FedService(_svc_cfg(), devices=[CPU])
    errors, stop = [], threading.Event()

    def scrape():
        while not stop.is_set():
            try:
                svc.active_jobs()
                svc.slo_burning_jobs()
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=scrape) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for j, seed in enumerate((3, 4, 5)):
            bs = _batches(7 + j, 2)
            svc.admit(JobSpec(f"j{j}", _job_cfg(seed), _builder,
                              lambda r, bs=bs: bs[r] if r < 2 else None,
                              rounds=3))
        svc.run(max_ticks=6)
    finally:
        stop.set()
        for t in threads:
            t.join()
        svc.close()
    assert errors == [] and svc.active_jobs() == 0

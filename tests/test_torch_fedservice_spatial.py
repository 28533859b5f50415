"""Spatial jobs of several cards in the port's job service
(``fedservice/spatial.py``: a job on a block of C·M devices runs in C·M
worker processes joined into a process group of their own) against the
JAX package, on a pod of four CPU devices (gloo).

- **Partition and release** (reference ``tests/test_fedservice.py:323``,
  its 4x1 jobs on eight devices cut to 2x1 on four): two (2, 1) jobs
  fill the pod, a third spatial admission is refused with a counted
  ``AdmissionError``, and every device comes back when they drain. Each
  job ends at the weights of its solo one-device run (rtol 1e-5, atol
  1e-6: the clients' updates are summed over two ranks) and of the JAX
  service's run of the same two jobs (atol 1e-4); each job's rank 0
  records reach the daemon's live plane (one scrape, 2 rounds a job).
- **Migration** (reference ``tests/test_fedservice.py:341``): a (2, 1)
  job moved to (1, 1) after two rounds, and a (1, 1) job moved to
  (2, 1): the restore is bit-exact, and the finished weights are within
  the reference's atol 1e-4 of a never-migrated run and of the JAX
  service's run of the same migration.
- **Ledgers**: the spatial job's rank 1 writes
  ``<ledger>.job<j>.jsonl.p1.jsonl`` with the job shard's round ids,
  and the reference's ``scripts/ledger_merge.py`` merges the service's
  shards to what the port's merge gives.
- **Failure**: a builder raising on rank 1 fails the admission with
  rank 1's traceback and gives the block back; no worker is left.

The tenants' builder is ``torch_mesh_workers.service_builder`` (it must
pickle, and the workers import no JAX).
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.fedservice import FedService as JaxFedService
from commefficient_tpu.fedservice import JobSpec as JaxJobSpec
from commefficient_tpu_torch.fedservice import (AdmissionError, FedService,
                                                JobSpec)
from commefficient_tpu_torch.fedservice.spatial import SpatialJobError
from commefficient_tpu_torch.telemetry import live, merge

from test_torch_fedservice import (JOB, SVC, _batches, _jax_batches,
                                   _jax_builder, _job_cfg, _svc_cfg)
from test_torch_slo_live import free_port, urlopen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POD = [torch.device("cpu", i) for i in range(4)]
RTOL, ATOL = 1e-5, 1e-6
MIGRATE_ATOL = 1e-4
R = 4


def _jax_cfg(seed):
    return JaxConfig(seed=seed, **JOB)


def _solo(seed, batches):
    model, opt = workers.service_builder(_job_cfg(seed), None)
    for b in batches:
        model(b)
        opt.step()
    out = model.ps_weights.numpy().copy()
    model.finalize()
    return out


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _rounds(path):
    return [r["round"] for r in _read(path) if r["kind"] == "round"]


@pytest.fixture(scope="module")
def partition(tmp_path_factory):
    led = str(tmp_path_factory.mktemp("spatial") / "svc.jsonl")
    port = free_port()
    svc = FedService(_svc_cfg(led, live_port=int(port)), devices=POD)
    try:
        bs = [_batches(7, 2), _batches(9, 2)]
        for i, seed in enumerate((3, 4)):
            svc.admit(JobSpec(f"j{i}", _job_cfg(seed),
                              workers.service_builder,
                              lambda r, i=i: bs[i][r], rounds=2,
                              mesh_demand=(2, 1)))
        full = len(svc._free)
        with pytest.raises(AdmissionError, match="needs 1 devices"):
            svc.admit(JobSpec("j2", _job_cfg(5), workers.service_builder,
                              lambda r: None, rounds=1, mesh_demand=(1, 1)))
        rejected = svc._rejected
        svc.run()
        with urlopen(f"http://127.0.0.1:{port}/metrics") as resp:
            scrape = resp.read().decode()
        out = {"full": full, "rejected": rejected, "free": list(svc._free),
               "states": [svc.job_state(f"j{i}") for i in range(2)],
               "ledger": led, "batches": bs, "scrape": scrape}
    finally:
        svc.close()
        live.shutdown_plane()
    return out


def test_spatial_partition_and_release(partition):
    assert partition["full"] == 0 and partition["rejected"] == 1
    assert sorted(map(str, partition["free"])) == sorted(map(str, POD))
    # rank 0's records reach the daemon's live plane
    for j in ("0", "1"):
        assert re.search(r'commeff_rounds_total\{job="%s",process="0"[^}]*\}'
                         r' 2(\.0)?$' % j, partition["scrape"], re.M), j
    jsvc = JaxFedService(JaxConfig(**SVC))
    jbs = [_jax_batches(7, 2), _jax_batches(9, 2)]
    for i, seed in enumerate((3, 4)):
        jsvc.admit(JaxJobSpec(f"j{i}", _jax_cfg(seed),
                              _jax_builder, lambda r, i=i: jbs[i][r],
                              rounds=2, mesh_demand=(2, 1)))
    assert len(jsvc._free) == len(jax.devices()) - 4
    jsvc.run()
    for i, seed in enumerate((3, 4)):
        got = partition["states"][i]
        np.testing.assert_allclose(got, _solo(seed, partition["batches"][i]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, np.asarray(jsvc.job_state(f"j{i}")),
                                   rtol=0, atol=MIGRATE_ATOL)
    jsvc.close()


@pytest.mark.parametrize("src,dst", [((2, 1), (1, 1)), ((1, 1), (2, 1))])
def test_migration_is_checkpoint_exact(tmp_path, src, dst):
    batches = _batches(7, R)
    solo = _solo(3, batches)
    svc = FedService(_svc_cfg(), devices=POD,
                     ckpt_dir=str(tmp_path / "ckpt"))
    svc.admit(JobSpec("m", _job_cfg(3), workers.service_builder,
                      lambda r: batches[r], rounds=R, mesh_demand=src))
    svc.tick()
    svc.tick()
    before = svc.job_state("m")
    svc.migrate("m", mesh_demand=dst)
    assert (svc._jobs[0].spatial is not None) == (dst != (1, 1))
    assert np.array_equal(before, svc.job_state("m"))
    svc.run()
    migrated = svc.job_state("m")
    svc.close()
    np.testing.assert_allclose(migrated, solo, rtol=0, atol=MIGRATE_ATOL)

    jbatches = _jax_batches(7, R)
    jsvc = JaxFedService(JaxConfig(**SVC), ckpt_dir=str(tmp_path / "jckpt"))
    jsvc.admit(JaxJobSpec("m", _jax_cfg(3), _jax_builder,
                          lambda r: jbatches[r], rounds=R,
                          mesh_demand=src))
    jsvc.tick()
    jsvc.tick()
    jsvc.migrate("m", mesh_demand=dst)
    jsvc.run()
    np.testing.assert_allclose(migrated, np.asarray(jsvc.job_state("m")),
                               rtol=0, atol=MIGRATE_ATOL)
    jsvc.close()


def test_spatial_ranks_write_job_sub_shards(partition, tmp_path):
    led = partition["ledger"]
    for j in range(2):
        shard = f"{led}.job{j}.jsonl"
        assert [k for k, _ in merge.discover_shards(shard)] == [1]
        assert _rounds(shard) == _rounds(shard + ".p1.jsonl") == [0, 1]
        assert {r.get("process") for r in _read(shard + ".p1.jsonl")} == {1}
    ours, theirs = str(tmp_path / "ours.jsonl"), str(tmp_path / "theirs.jsonl")
    assert merge.main([led, "-o", ours]) == 0
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "ledger_merge.py"),
         led, "-o", theirs], env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "WARNING" not in out.stderr, out.stderr
    assert _read(ours) == _read(theirs)
    joined = [r for r in _read(ours) if r.get("job") is not None
              and r.get("shards")]
    assert len(joined) == 4


def test_a_failing_rank_fails_the_admission_and_frees_the_block():
    svc = FedService(_svc_cfg(), devices=POD)
    with pytest.raises(SpatialJobError, match="rank 1 cannot build"):
        svc.admit(JobSpec("x", _job_cfg(3), workers.broken_builder,
                          lambda r: None, rounds=1, mesh_demand=(2, 1)))
    assert sorted(map(str, svc._free)) == sorted(map(str, POD))
    assert svc.active_jobs() == 0
    svc.close()

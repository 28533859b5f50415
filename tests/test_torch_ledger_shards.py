"""Per-rank ledger shards and their merge (``telemetry/sinks.py``
``shard_ledger_path``, ``telemetry/core.py`` ``build_telemetry``,
``telemetry/registry.py``'s ``ledger_shards``, ``telemetry/merge.py``)
against the JAX package.

- **The layout.** ``shard_ledger_path`` is the reference's. With a rank
  and a world passed in, ``build_telemetry`` opens the reference's paths
  for the same process index and count: rank 0 the canonical ledger,
  rank k its ``.p<k>.jsonl`` shard, each record stamped with its rank
  on a world of more than one, the one-line note on rank k, the console
  summary on rank 0 only; a ``--resume`` rank drops the rounds its own
  shard already holds.
- **A mesh run.** ``cv_train.main`` on two gloo ranks (``--ledger
  --profile --causal_trace``, CPU) leaves the canonical ledger and shard
  p1 with the same round ids, every shard record stamped with its rank,
  and each rank's ``device_time`` from its own trace.
- **The merge.** The reference's ``scripts/ledger_merge.py``, run as a
  subprocess on the port's shards (and on a job service's job shards
  beside them), writes the merged ledger the port's ``python -m
  commefficient_tpu_torch.telemetry.merge`` writes, record for record
  and field for field; every joined round has ``host_gap_by_process``
  for both ranks.
- **The manifest.** A manifest written on a launched group of two lists
  the reference's ``ledger_shards``.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import json
import os
import subprocess
import sys

import pytest

import torch_mesh_workers as workers
from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.telemetry import core as jax_core
from commefficient_tpu.telemetry import sinks as jax_sinks
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.parallel.mesh import launch
from commefficient_tpu_torch.telemetry import core, merge, sinks
from commefficient_tpu_torch.telemetry.record import make_round_record

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_ARGV = ["--dataset_name", "Synthetic", "--mode", "sketch",
              "--error_type", "virtual", "--virtual_momentum", "0.9",
              "--local_momentum", "0", "--num_workers", "4",
              "--local_batch_size", "2", "--num_epochs", "0.3",
              "--pivot_epoch", "0.1", "--device", "cpu", "--test",
              "--synthetic_per_class", "8", "--num_devices", "2",
              "--profile", "--causal_trace"]


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _sink_paths(tel):
    return [(type(s).__name__, getattr(s, "path", None),
             getattr(s, "process", None)) for s in tel._sinks]


@pytest.mark.parametrize("path", ["runs/a.jsonl", "/x/l", "l.jsonl.job3.jsonl"])
@pytest.mark.parametrize("k", [0, 1, 7])
def test_shard_path_is_the_references(path, k):
    assert sinks.shard_ledger_path(path, k) == \
        jax_sinks.shard_ledger_path(path, k)


@pytest.mark.parametrize("pidx,pcount", [(0, 1), (0, 4), (1, 4), (3, 4)])
def test_build_telemetry_opens_the_references_shards(tmp_path, capsys,
                                                     pidx, pcount):
    led = str(tmp_path / "l.jsonl")
    kw = dict(ledger=led, telemetry_console=True)
    tel = core.build_telemetry(Config(device="cpu", **kw),
                               process_index=pidx, process_count=pcount)
    ours = _sink_paths(tel)
    note = capsys.readouterr().out
    tel.close()
    jtel = jax_core.build_telemetry(JaxConfig(**kw), process_index=pidx,
                                    process_count=pcount)
    theirs = _sink_paths(jtel)
    jnote = capsys.readouterr().out
    jtel.close()
    assert ours == theirs
    assert ours[0] == ("JSONLSink", sinks.shard_ledger_path(led, pidx),
                       pidx if pcount > 1 else None)
    assert (len(ours) == 2) == (pidx == 0)
    assert ("writing ledger shard" in note) == (pidx != 0) == \
        ("writing ledger shard" in jnote)


def test_a_resumed_rank_drops_the_rounds_of_its_own_shard(tmp_path):
    led = str(tmp_path / "l.jsonl")
    shard = sinks.shard_ledger_path(led, 1)
    with open(shard, "w") as f:
        for r in range(3):
            f.write(json.dumps(make_round_record(r)) + "\n")
    cfg = Config(device="cpu", ledger=led, do_resume=True)
    tel = core.build_telemetry(cfg, process_index=1, process_count=2)
    assert tel._sinks[0].resume_after == 2
    for r in range(2, 5):
        tel._sinks[0].write(make_round_record(r))
    tel.close()
    recs = _read(shard)
    assert [r["round"] for r in recs] == [0, 1, 2, 3, 4]
    assert [r.get("process") for r in recs[3:]] == [1, 1]


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The two-rank trainer run's ledger, from its own working
    directory (``--profile`` writes under ``runs/``)."""
    from commefficient_tpu_torch.train import cv_train
    tmp = tmp_path_factory.mktemp("shards")
    led = str(tmp / "run.jsonl")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        cv_train.main(TRAIN_ARGV + ["--ledger", led])
    finally:
        os.chdir(cwd)
    return led


def test_every_rank_writes_its_shard(mesh_run):
    led = mesh_run
    assert [k for k, _ in merge.discover_shards(led)] == [1]
    canon, shard = _read(led), _read(led + ".p1.jsonl")
    rounds = [r["round"] for r in canon if r["kind"] == "round"]
    assert rounds and rounds == [r["round"] for r in shard
                                 if r["kind"] == "round"]
    assert {r.get("process") for r in canon} == {0}
    assert {r.get("process") for r in shard} == {1}
    for r in canon + shard:
        if r["kind"] == "round":
            assert r["device_time"]["host_gap_s"] >= 0
            assert r["causal"]["spans"]


def _merged(path):
    recs = _read(path)
    assert recs
    return recs


def test_the_port_merge_is_the_reference_script(mesh_run, tmp_path):
    from commefficient_tpu_torch.fedservice import FedService, JobSpec
    from test_torch_fedservice import _batches, _builder, _job_cfg, _svc_cfg
    led = mesh_run
    # a job service's job shards beside the rank shards
    svc = FedService(_svc_cfg(led + ".svc", causal_trace=True))
    bs = [_batches(7, 2), _batches(9, 2)]
    for i in range(2):
        svc.admit(JobSpec(f"j{i}", _job_cfg(3 + i), _builder,
                          lambda r, i=i: bs[i][r], rounds=2))
    svc.run()
    svc.close()
    for base in (led, led + ".svc"):
        ours, theirs = base + ".ours.jsonl", base + ".theirs.jsonl"
        assert merge.main([base, "-o", ours]) == 0
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "scripts", "ledger_merge.py"),
             base, "-o", theirs], env=env, capture_output=True, text=True,
            timeout=300)
        assert out.returncode == 0, out.stderr
        assert "WARNING" not in out.stderr, out.stderr
        a, b = _merged(ours), _merged(theirs)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x == y
    joined = [r for r in _read(led + ".ours.jsonl") if r.get("shards")]
    assert joined
    for r in joined:
        assert sorted(r["host_gap_by_process"]) == ["p0", "p1"]
    jobs = {r["job"] for r in _read(led + ".svc.ours.jsonl") if "job" in r}
    assert jobs == {0, 1}


def test_the_manifest_lists_the_rank_shards(tmp_path):
    led = str(tmp_path / "m.jsonl")
    outs = launch(2, workers.manifest_shards, str(tmp_path / "runs"), led,
                  device_type="cpu")
    assert outs[0] == [led + ".p1.jsonl"]
    assert outs[1] is None

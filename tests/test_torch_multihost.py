"""Multi-host launch in the port (``--coordinator_address``,
``--num_processes``, ``--process_id``; ``parallel/mesh.py`` ``launch``,
``hosts_of``, ``host_rendezvous``), on the CPU with gloo.

- **Two hosts against one.** Two launcher subprocesses
  (``tests/torch_multihost_main.py``: ``cv_train.main`` with the flags)
  of one gloo rank each, joined through a rendezvous on 127.0.0.1 at a
  port the test picks, run the ``--test`` ResNet9 round on the 1-D mesh
  (sketch) and on ``--mesh 1x2`` (the 2-D sketch server, and the 2-D
  dense server in uncompressed mode). Their final weights (``--checkpoint``'s
  ``ResNet9.pkl`` and the archive's ``ps_weights``, written by global
  rank 0 on host 0) are bit-equal to the single launcher's run of the
  same world (``--num_devices 2`` / ``--mesh 1x2``), and both launchers'
  losses are the single launcher's. The archive's topology counts two
  hosts of one device each against one host of two. Each subprocess
  is cut at 120 s, so a hang fails.
- **The flags' errors**, as the reference raises them
  (runtime/fed_model.py:148-152, parallel/mesh.py:242-262):
  ``--num_devices`` with several hosts, ``--process_id`` or
  ``--coordinator_address`` without ``--num_processes``, a host index
  out of range, a ``--mesh`` the hosts cannot fill, and hosts of
  unequal rank counts (each launcher raises naming both counts).
- ``topology_summary`` and ``hosts_of`` outside a launch.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import json
import os
import pickle
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.parallel import mesh as pm
from commefficient_tpu_torch.train import cv_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN = os.path.join(REPO, "tests", "torch_multihost_main.py")
TRAIN_ARGV = ["--dataset_name", "Synthetic", "--mode", "sketch",
              "--error_type", "virtual", "--virtual_momentum", "0.9",
              "--local_momentum", "0", "--num_workers", "4",
              "--local_batch_size", "2", "--num_epochs", "0.2",
              "--pivot_epoch", "0.1", "--device", "cpu", "--test",
              "--synthetic_per_class", "8"]
UNCOMPRESSED = ["--mode", "uncompressed", "--error_type", "none"]
# name: (flags after TRAIN_ARGV, the single launcher's flags)
RUNS = {
    "1d": ([], ["--num_devices", "2"]),
    "1x2": (["--mesh", "1x2"], ["--mesh", "1x2"]),
    "1x2_dense": (UNCOMPRESSED + ["--mesh", "1x2"], ["--mesh", "1x2"]),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _hosts(extra, tmp):
    """Two launcher subprocesses of ``TRAIN_ARGV + extra`` on 127.0.0.1;
    their stdout lines and the checkpoint directory host 0's rank 0
    wrote."""
    port = _free_port()
    ck = os.path.join(tmp, "hosts")
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    procs = [subprocess.Popen(
        [sys.executable, MAIN] + TRAIN_ARGV + extra + [
            "--coordinator_address", f"127.0.0.1:{port}",
            "--num_processes", "2", "--process_id", str(i),
            "--checkpoint", "--checkpoint_path", ck],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs, ck


def _losses(out):
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert len(line) == 1, out[-2000:]
    return json.loads(line[0][len("RESULT "):])


def _archive(ck):
    with open(os.path.join(ck, "ResNet9.pkl"), "rb") as f:
        params = pickle.load(f)
    with np.load(os.path.join(ck, "ckpt_ResNet9.npz")) as z:
        meta = json.loads(str(z["meta"]))
        ps = np.asarray(z["ps_weights"])
    return params, ps, meta


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, (extra, single) in RUNS.items():
        tmp = str(tmp_path_factory.mktemp(name))
        host_outs, ck = _hosts(extra, tmp)
        one_ck = os.path.join(tmp, "one")
        rows = cv_train.main(TRAIN_ARGV + extra + single + [
            "--checkpoint", "--checkpoint_path", one_ck])
        out[name] = (host_outs, _archive(ck), rows[-1]["round_losses"],
                     _archive(one_ck))
    return out


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [np.asarray(tree)]


@pytest.mark.parametrize("name", list(RUNS))
def test_two_hosts_are_the_single_launcher_bit_for_bit(runs, name):
    host_outs, (params, ps, meta), losses, (params1, ps1, meta1) = \
        runs[name]
    for i, out in enumerate(host_outs):
        assert f"multihost: process {i}/2, 2 devices" in out
        assert _losses(out) == losses
    assert ps.tobytes() == ps1.tobytes()
    for a, b in zip(_flat(params), _flat(params1)):
        assert a.tobytes() == b.tobytes()
    assert meta["topology"]["device_count"] == 2
    assert meta["topology"]["process_count"] == 2
    assert meta1["topology"]["device_count"] == 2
    assert meta1["topology"]["process_count"] == 1
    assert meta["topology"]["mesh_shape"] == meta1["topology"]["mesh_shape"]


HOST_FLAGS = ["--coordinator_address", "127.0.0.1:1", "--num_processes",
              "2", "--process_id", "0"]


@pytest.mark.parametrize("flags,match", [
    (["--num_devices", "2"] + HOST_FLAGS, "single-host knob"),
    (["--process_id", "1"], "need --num_processes"),
    (["--coordinator_address", "127.0.0.1:1"], "need --num_processes"),
    (["--num_processes", "2", "--process_id", "2",
      "--coordinator_address", "127.0.0.1:1"], "outside the 2 hosts"),
    (["--num_processes", "2", "--process_id", "1"], "needs --process_id"),
    (["--mesh", "2x2"] + HOST_FLAGS, "needs 4 devices"),
], ids=["num_devices", "process_id_alone", "address_alone", "out_of_range",
        "no_address", "mesh_too_big"])
def test_multihost_flag_errors(flags, match):
    """Each raises before any rendezvous (the address is never
    contacted)."""
    with pytest.raises(ValueError, match=match):
        cv_train.main(TRAIN_ARGV + flags)


def test_unequal_hosts_raise_naming_both_counts():
    port = _free_port()
    errs = {}

    def host(i, local):
        try:
            pm.host_rendezvous(f"127.0.0.1:{port}", 2, i, local,
                               timeout_s=60)
        except ValueError as e:
            errs[i] = str(e)

    threads = [threading.Thread(target=host, args=(i, 1 + i))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(90)
    assert "host 1 launches 2 ranks and host 0 launches 1" in errs[0]
    assert "host 0 launches 1 ranks and host 1 launches 2" in errs[1]


def test_hosts_and_topology_outside_a_launch():
    assert pm.hosts_of(Config(device="cpu")) is None
    assert pm.hosts_of(Config(device="cpu", num_processes=1)) is None
    cfg = Config(device="cpu", num_processes=3, process_id=2,
                 coordinator_address="10.0.0.1:1234")
    assert pm.hosts_of(cfg) == ("10.0.0.1:1234", 3, 2)
    assert pm.resolve_world(cfg) == 3
    assert pm.needs_launch(cfg)
    assert cfg.on_mesh
    topo = pm.topology_summary()
    assert (topo["process_index"], topo["process_count"]) == (0, 1)
    assert topo["device_count"] == 1

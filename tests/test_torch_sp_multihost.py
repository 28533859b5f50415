"""Sequence parallelism over two launchers (the reference's
scripts/multihost_smoke.py scenario 5), on the CPU with gloo.

Two launcher subprocesses (``tests/torch_multihost_sp_main.py``:
``gpt2_train.main`` with ``--coordinator_address``, ``--num_processes 2``
and ``--process_id``) of two gloo ranks each, joined through a
rendezvous on 127.0.0.1 at a port the test picks, run the ``--test``
GPT-2 sketch round at ``--seq_devices 2`` (the 2x2 mesh: each launcher
holds one client row, whose aggregate crosses to the other). Their
final weights (``--checkpoint``'s archive, written by global rank 0 on
host 0) and both launchers' losses and validation NLLs equal the single
launcher's four-rank run of the same flags (run meanwhile), bit for
bit. Each subprocess is cut at 120 s, so a hang fails.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from commefficient_tpu_torch.data import fed_persona as tfp
from commefficient_tpu_torch.train import gpt2_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN = os.path.join(REPO, "tests", "torch_multihost_sp_main.py")
ARGV = ["--test", "--dataset_name", "PERSONA", "--mode", "sketch",
        "--error_type", "virtual", "--local_momentum", "0",
        "--virtual_momentum", "0.9", "--num_workers", "2",
        "--local_batch_size", "2", "--valid_batch_size", "2",
        "--num_epochs", "2", "--seed", "5", "--device", "cpu"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _hosts(argv, tmp):
    """Two launcher subprocesses of ``argv`` on 127.0.0.1, started; the
    checkpoint directory host 0's rank 0 writes."""
    port = _free_port()
    ck = os.path.join(tmp, "hosts")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    procs = [subprocess.Popen(
        [sys.executable, MAIN] + argv + [
            "--coordinator_address", f"127.0.0.1:{port}",
            "--num_processes", "2", "--process_id", str(i),
            "--checkpoint", "--checkpoint_path", ck],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    return procs, ck


def _outputs(procs):
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
    return outs


def _result(out):
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert len(line) == 1, out[-2000:]
    return json.loads(line[0][len("RESULT "):])


def _ps(ck):
    with np.load(os.path.join(ck, "ckpt_gpt2.npz")) as z:
        return np.asarray(z["ps_weights"]), json.loads(str(z["meta"]))


def test_two_launchers_are_the_single_launcher_bit_for_bit(tmp_path):
    data = str(tmp_path / "data")
    tfp.generate_synthetic_personachat(data)
    argv = ARGV + ["--dataset_dir", data, "--seq_devices", "2"]
    procs, ck = _hosts(argv, str(tmp_path))
    # the single launcher's run while the two launchers run theirs
    one_ck = str(tmp_path / "one")
    try:
        rows = gpt2_train.main(argv + ["--num_devices", "4", "--checkpoint",
                                       "--checkpoint_path", one_ck])
    finally:
        outs = _outputs(procs)
    want = [[r["train_loss"], r["val_nll"]] for r in rows]
    for i, out in enumerate(outs):
        assert f"multihost: process {i}/2, 4 devices" in out
        assert _result(out) == want
    (ps, meta), (ps1, meta1) = _ps(ck), _ps(one_ck)
    assert ps.tobytes() == ps1.tobytes()
    assert meta["topology"]["device_count"] == 4
    assert meta["topology"]["process_count"] == 2
    assert meta1["topology"]["process_count"] == 1

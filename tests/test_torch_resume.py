"""Full-state checkpoint and resume (``runtime/checkpoint.py``) on the CPU.

- After the same ``--test`` rounds, the port's ``ckpt_<model>.npz``
  against the JAX trainer's, key for key: the same array keys and
  ``meta`` keys (``topology`` and the segments' topology entries name
  each package's device), the counters and RNG states equal, the
  arrays within the round tolerance (rtol 1e-5, atol 1e-6; the port
  starts from the JAX trainer's initial weights). ``--checkpoint``
  leaves the reference's file names behind.
- In the port, a run interrupted and resumed equals the uninterrupted
  run bit for bit: at epoch cadence, and mid-epoch at round cadence
  after a ``PreemptionDrill`` SIGTERM, under both client-state
  placements, with client dropout on (a tiny ResNet9 with several
  rounds an epoch).
- The port resumes from the JAX trainer's archive and goes on matching
  the JAX trainer's uninterrupted run.
- A torn archive falls back to the newest valid autosave,
  ``--checkpoint_keep`` keeps the newest snapshots, ``--resume`` without
  ``--checkpoint`` raises, an archive holding asynchronous updates in
  flight raises in a synchronous run (``ValueError``, as the
  reference), and one of several ranks missing a side shard raises
  ``TornCheckpointError`` naming it.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from commefficient_tpu.config import parse_args as jax_parse_args
from commefficient_tpu.train import cv_train as jax_cv_train
from commefficient_tpu_torch.data.chaos import PreemptionDrill
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.runtime import checkpoint, fed_model
from commefficient_tpu_torch.train import cv_train

TEST_ARGV = ["--test", "--dataset_name", "Synthetic", "--num_clients", "10",
             "--num_workers", "2", "--local_batch_size", "4",
             "--lr_scale", "0.1", "--pivot_epoch", "1", "--seed", "3"]
MODES = {
    "sketch": ["--mode", "sketch", "--error_type", "virtual",
               "--local_momentum", "0", "--virtual_momentum", "0.9"],
    "local_topk_host": ["--mode", "local_topk", "--error_type", "local",
                        "--local_momentum", "0.9", "--clientstore", "host",
                        "--clientstore_bytes", "20000"],
}
RTOL, ATOL = 1e-5, 1e-6


def _from_jax_weights(monkeypatch, argv):
    """The port's trainer starts from the JAX trainer's initial weights."""
    port_build = cv_train.build_model

    def build_model(args, device="cpu"):
        module, _ = port_build(args, device)
        _, params, _ = jax_cv_train.build_model(
            jax_parse_args(default_lr=cv_train.DEFAULT_LR, argv=argv))
        return module, module.from_jax_params(
            jax.tree_util.tree_map(np.asarray, params), device)

    monkeypatch.setattr(cv_train, "build_model", build_model)


def _load(path):
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        return meta, {k: np.array(z[k]) for k in z.files if k != "meta"}


def _strip_topology(meta):
    meta = dict(meta)
    meta.pop("topology")
    meta["segments"] = [seg["round_index"] for seg in meta["segments"]]
    return meta


@pytest.mark.parametrize("mode", sorted(MODES))
def test_archive_matches_the_reference_key_for_key(mode, tmp_path,
                                                   monkeypatch):
    argv = TEST_ARGV + MODES[mode] + ["--num_epochs", "2", "--checkpoint"]
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    _from_jax_weights(monkeypatch, argv)
    cv_train.main(["--device", "cpu", "--checkpoint_path", ours] + argv)
    jax_cv_train.main(["--checkpoint_path", theirs] + argv)
    # the --checkpoint repair: the same files as the reference's run
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == [
        "ResNet9.pkl", "ResNet9.pt", "ckpt_ResNet9.npz"]
    meta, arrays = _load(os.path.join(ours, "ckpt_ResNet9.npz"))
    jmeta, jarrays = _load(os.path.join(theirs, "ckpt_ResNet9.npz"))
    assert sorted(arrays) == sorted(jarrays)
    assert sorted(meta) == sorted(jmeta)
    assert meta["topology"] == {"device_count": 1, "process_count": 1,
                                "platform": "cpu"}
    assert _strip_topology(meta) == _strip_topology(jmeta)
    if mode == "local_topk_host":
        assert any(k.startswith("store:") for k in arrays)
    for key, want in jarrays.items():
        got = arrays[key]
        assert got.shape == want.shape, key
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


# --- the port's own resume: bit for bit ---------------------------------

CH = {"prep": 2, "layer1": 4, "layer2": 4, "layer3": 8}
RUN_ARGV = ["--device", "cpu", "--dataset_name", "Synthetic",
            "--num_clients", "10", "--num_workers", "3",
            "--local_batch_size", "4", "--synthetic_per_class", "4",
            "--synthetic_num_val", "10", "--valid_batch_size", "4",
            "--mode", "local_topk", "--error_type", "local",
            "--local_momentum", "0.9", "--k", "50", "--lr_scale", "0.05",
            "--pivot_epoch", "1", "--schedule_epochs", "2",
            "--dropout_prob", "0.2", "--seed", "7"]
PLACEMENTS = {"device": [],
              "host": ["--clientstore", "host", "--clientstore_bytes",
                       "30000"]}


@pytest.fixture
def tiny_resnet9(monkeypatch):
    def build_model(args, device="cpu"):
        module = ResNet9(num_classes=10, channels=CH)
        return module, module.init_flat(args.seed, device)

    monkeypatch.setattr(cv_train, "build_model", build_model)


_STRAIGHT = {}


def _final(argv, cache=False):
    """(results, final weights) of ``cv_train.main(argv)``; with
    ``cache`` a run of the same flags is made once (the uninterrupted
    runs both cadence tests compare with)."""
    key = tuple(argv)
    if cache and key in _STRAIGHT:
        return _STRAIGHT[key]
    out = cv_train.main(argv), fed_model._CURRENT_MODEL.ps_weights.clone()
    if cache:
        _STRAIGHT[key] = out
    return out


@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
def test_resume_at_epoch_cadence_is_bit_exact(placement, tmp_path,
                                              tiny_resnet9):
    argv = RUN_ARGV + PLACEMENTS[placement]
    straight, want = _final(argv + ["--num_epochs", "2"], cache=True)
    ck = ["--checkpoint", "--checkpoint_path", str(tmp_path)]
    first, _ = _final(argv + ck + ["--num_epochs", "1"])
    assert os.path.exists(tmp_path / "ckpt_ResNet9.npz")
    rest, got = _final(argv + ck + ["--num_epochs", "2", "--resume"])
    assert len(first) == len(rest) == 1
    assert torch.equal(got, want)
    assert [r["train_loss"] for r in first + rest] == \
        [r["train_loss"] for r in straight]


@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
def test_sigterm_then_resume_mid_epoch_is_bit_exact(placement, tmp_path,
                                                    tiny_resnet9,
                                                    monkeypatch):
    argv = RUN_ARGV + PLACEMENTS[placement] + ["--num_epochs", "2"]
    straight, want = _final(argv, cache=True)
    rounds = sum(len(r["round_times"]) for r in straight)
    # 3 rounds an epoch (10 clients of one batch, W = 3): round 2 is
    # mid-epoch
    assert rounds == 6
    drill = PreemptionDrill(min_round=2, max_round=2,
                            signals=(signal.SIGTERM,))
    saver = checkpoint.RoundAutosaver.__call__

    def autosave_then_drill(self, epoch):
        saver(self, epoch)
        if drill.should_kill(self.model.round_index):
            drill.execute()

    ck = ["--checkpoint", "--checkpoint_path", str(tmp_path),
          "--checkpoint_every_rounds", "1", "--checkpoint_keep", "2"]
    with monkeypatch.context() as m:
        m.setattr(checkpoint.RoundAutosaver, "__call__",
                  autosave_then_drill)
        assert cv_train.main(argv + ck) == []
    assert drill.fired
    model = fed_model._CURRENT_MODEL
    assert model.client_store is None  # finalize closed it
    k = drill.kill_round
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_ResNet9.npz", f"ckpt_ResNet9_r{k - 1:08d}.npz",
        f"ckpt_ResNet9_r{k:08d}.npz"]
    meta = checkpoint.validate_checkpoint(
        str(tmp_path / "ckpt_ResNet9.npz"))
    assert meta["round_index"] == k and meta["sampler_mid_epoch"]
    _, got = _final(argv + ck + ["--resume"])
    assert torch.equal(got, want)


def test_torn_archive_falls_back_to_the_newest_valid_autosave(
        tmp_path, tiny_resnet9):
    ck = ["--checkpoint", "--checkpoint_path", str(tmp_path),
          "--checkpoint_every_rounds", "1", "--checkpoint_keep", "3"]
    cv_train.main(RUN_ARGV + ck + ["--num_epochs", "1"])
    snaps = sorted(n for n in os.listdir(tmp_path) if "_r" in n)
    assert len(snaps) == 3
    newest, older = (str(tmp_path / n) for n in (snaps[-1], snaps[-2]))
    canonical = str(tmp_path / "ckpt_ResNet9.npz")
    # the canonical archive and the newest snapshot are links of one
    # file: tear a copy of the canonical and the newest snapshot
    for path in (canonical, newest):
        data = open(path, "rb").read()
        os.unlink(path)
        with open(path, "wb") as f:
            f.write(data[:len(data) // 2])
    with pytest.raises(checkpoint.TornCheckpointError, match="torn"):
        checkpoint.validate_checkpoint(canonical)
    assert checkpoint._resolve_resume_source(
        str(tmp_path), canonical, "ResNet9") == older
    os.unlink(older)
    for name in os.listdir(tmp_path):
        if "_r" in name:
            os.unlink(tmp_path / name)
    with pytest.raises(checkpoint.TornCheckpointError):
        checkpoint._resolve_resume_source(str(tmp_path), canonical,
                                          "ResNet9")


def test_resume_needs_checkpoint_and_an_archive(tmp_path):
    base = ["--device", "cpu"] + TEST_ARGV + MODES["sketch"]
    with pytest.raises(ValueError, match="--resume requires --checkpoint"):
        cv_train.main(base + ["--resume"])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        cv_train.main(base + ["--resume", "--checkpoint",
                              "--checkpoint_path", str(tmp_path)])


@pytest.mark.parametrize("what", ["asyncfed", "processes"])
def test_archives_the_port_cannot_restore_raise(what, tmp_path):
    argv = ["--device", "cpu"] + TEST_ARGV + MODES["sketch"] + [
        "--num_epochs", "1", "--checkpoint", "--checkpoint_path",
        str(tmp_path)]
    cv_train.main(argv)
    path = str(tmp_path / "ckpt_ResNet9.npz")
    meta, arrays = _load(path)
    if what == "asyncfed":
        # a backlog in flight, resumed by a synchronous run: its updates
        # would be dropped (the reference refuses it too)
        meta["asyncfed"] = {"pending": 2}
        match, exc = "synchronous", ValueError
    else:
        # an archive of 3 ranks whose side shard 2 is gone: the restore
        # names the missing shard (shards of several ranks restore since
        # the store's process shards were ported)
        meta["clientstore"] = {"fields": [], "processes": 3}
        np.savez(path + ".shard1.npz", ids=np.zeros(0, np.int64))
        match, exc = "shard2.npz", checkpoint.TornCheckpointError
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)
    with pytest.raises(exc, match=match):
        cv_train.main(argv + ["--resume", "--num_epochs", "2"])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_port_continues_from_the_references_archive(mode, tmp_path,
                                                    monkeypatch):
    """Two JAX rounds saved, then the port resumes for a third; the JAX
    trainer's own three-round run is the reference."""
    argv = TEST_ARGV + MODES[mode] + ["--schedule_epochs", "3",
                                      "--checkpoint", "--checkpoint_path",
                                      str(tmp_path)]
    straight = jax_cv_train.main([a if a != str(tmp_path)
                                  else str(tmp_path / "straight")
                                  for a in argv] + ["--num_epochs", "3"])
    jax_cv_train.main(argv + ["--num_epochs", "2"])
    results = cv_train.main(["--device", "cpu"] + argv
                            + ["--num_epochs", "3", "--resume"])
    assert len(results) == 1
    np.testing.assert_allclose(results[0]["train_loss"],
                               straight[-1]["train_loss"], rtol=RTOL)
    assert results[0]["up (MiB)"] == straight[-1]["up (MiB)"]
    assert results[0]["down (MiB)"] == straight[-1]["down (MiB)"]
    _, ref = _load(str(tmp_path / "straight" / "ckpt_ResNet9.npz"))
    _, ours = _load(str(tmp_path / "ckpt_ResNet9.npz"))
    np.testing.assert_allclose(ours["ps_weights"], ref["ps_weights"],
                               rtol=RTOL, atol=ATOL)
    for key in ref:
        if key.startswith(("store:", "cs_", "ss_")):
            np.testing.assert_allclose(ours[key], ref[key], rtol=RTOL,
                                       atol=ATOL, err_msg=key)

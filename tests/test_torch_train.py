"""The port's trainer on the CPU, against the JAX trainer.

``main(["--device", "cpu", "--test", ...])`` finishes with a finite
loss; with the same seed its sampled cohorts and round batches and its
upload/download byte totals equal the JAX trainer's (exactly: both are
host-side numpy and integer counts). Started from the JAX trainer's
initial weights, the other modes' rounds also give the JAX trainer's
bytes exactly and its losses within rtol 1e-5. Without ``--device`` the
trainer runs on cuda, and with no card it raises instead of falling
back.
"""

import jax
import numpy as np
import pytest
import torch

from commefficient_tpu.config import parse_args as jax_parse_args
from commefficient_tpu.train import cv_train as jax_cv_train
from commefficient_tpu_torch.config import parse_args
from commefficient_tpu_torch.train import cv_train

ARGV = ["--test", "--dataset_name", "Synthetic", "--mode", "sketch",
        "--error_type", "virtual", "--local_momentum", "0",
        "--num_clients", "10", "--num_workers", "2",
        "--local_batch_size", "4", "--num_epochs", "2",
        "--lr_scale", "0.1", "--pivot_epoch", "1"]


def test_trainer_matches_jax_bytes_and_finishes():
    results = cv_train.main(["--device", "cpu"] + ARGV)
    jax_results = jax_cv_train.main(ARGV)
    assert len(results) == len(jax_results) == 2
    for row, jrow in zip(results, jax_results):
        assert np.isfinite(row["train_loss"])
        assert np.isfinite(row["test_loss"])
        assert row["up (MiB)"] == jrow["up (MiB)"] > 0
        assert row["down (MiB)"] == jrow["down (MiB)"]


@pytest.mark.parametrize("extra", [[], ["--iid"], ["--num_workers", "3"]])
def test_cohorts_and_batches_match_jax(extra):
    argv = ["--dataset_name", "Synthetic", "--num_clients", "20",
            "--local_batch_size", "8"] + extra
    loaders = cv_train.get_data_loaders(
        parse_args(argv=["--device", "cpu"] + argv))[0]
    jax_loaders = jax_cv_train.get_data_loaders(jax_parse_args(argv=argv))
    jloader = jax_loaders[0]
    for epoch in range(2):
        ours, theirs = list(loaders), list(jloader)
        assert len(ours) == len(theirs) > 0
        for a, b in zip(ours, theirs):
            assert set(a) == set(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    assert parse_args(argv=[]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cv_train.main(ARGV)


MODE_ARGV = {
    "true_topk": ["--mode", "true_topk", "--error_type", "virtual",
                  "--local_momentum", "0.9"],
    "local_topk": ["--mode", "local_topk", "--error_type", "local",
                   "--local_momentum", "0.9"],
    "fedavg": ["--mode", "fedavg", "--error_type", "none",
               "--local_momentum", "0", "--local_batch_size", "-1",
               "--fedavg_batch_size", "2"],
    # the delta-coded downlink over a dense update (every coordinate)
    # and over local_topk's value-compared support; with 2 clients both
    # take part in every round (--iid: two clients are no natural
    # partition), so each holds the previous support and
    # the repeats ship as bitmap bits
    "uncompressed_delta": ["--mode", "uncompressed", "--error_type",
                           "none", "--downlink_encoding", "delta",
                           "--num_clients", "2", "--iid"],
    "local_topk_delta": ["--mode", "local_topk", "--error_type", "none",
                         "--local_momentum", "0", "--virtual_momentum",
                         "0.9", "--downlink_encoding", "delta",
                         "--num_clients", "2", "--iid"],
}


@pytest.mark.parametrize("mode", sorted(MODE_ARGV))
def test_mode_trainer_matches_jax_bytes_and_losses(mode, monkeypatch):
    """Three --test rounds (one an epoch) of each mode from the JAX
    trainer's initial weights: per-round upload and download bytes
    equal, per-round train losses within rtol 1e-5."""
    argv = ARGV + MODE_ARGV[mode] + ["--num_epochs", "3"]
    port_build = cv_train.build_model

    def build_model(args, device="cpu"):
        module, _ = port_build(args, device)
        _, params, _ = jax_cv_train.build_model(
            jax_parse_args(default_lr=cv_train.DEFAULT_LR, argv=argv))
        return module, module.from_jax_params(
            jax.tree_util.tree_map(np.asarray, params), device)

    monkeypatch.setattr(cv_train, "build_model", build_model)
    results = cv_train.main(["--device", "cpu"] + argv)
    jax_results = jax_cv_train.main(argv)
    assert len(results) == len(jax_results) == 3
    for row, jrow in zip(results, jax_results):
        assert row["up (MiB)"] == jrow["up (MiB)"] > 0
        assert row["down (MiB)"] == jrow["down (MiB)"]
        np.testing.assert_allclose(row["train_loss"], jrow["train_loss"],
                                   rtol=1e-5)
        assert np.isfinite(row["test_loss"])
    # the rounds moved the weights: some download was billed
    assert sum(row["down (MiB)"] for row in results) > 0


@pytest.mark.parametrize("argv,name", [
    (["--do_dp"], "--do_dp"),
    (["--client_chunk", "2"], "--client_chunk"),
    (["--model", "FixupResNet9"], "--model FixupResNet9"),
    (["--dataset_name", "CIFAR10"], "--dataset_name CIFAR10"),
])
def test_unported_options_raise(argv, name):
    base = ["--device", "cpu", "--test", "--local_momentum", "0",
            "--num_clients", "10", "--num_workers", "2"]
    if "--dataset_name" not in argv:
        base += ["--dataset_name", "Synthetic"]
    with pytest.raises(NotImplementedError, match=name):
        cv_train.main(base + argv)


def test_per_client_quantized_wire_raises():
    """Each client's clipped table would cross the wire quantized on
    its own: not ported."""
    with pytest.raises(NotImplementedError,
                       match="--max_grad_norm with --sketch_dtype int8"):
        cv_train.main(["--device", "cpu"] + ARGV + [
            "--max_grad_norm", "1", "--sketch_dtype", "int8"])


def test_gpt2_trainer_other_modes_raise():
    from commefficient_tpu_torch.train import gpt2_train
    with pytest.raises(NotImplementedError,
                       match="gpt2_train --mode true_topk"):
        gpt2_train.main(["--device", "cpu", "--test", "--mode",
                         "true_topk", "--error_type", "virtual"])

"""The port's trainer on the CPU, against the JAX trainer.

``main(["--device", "cpu", "--test", ...])`` finishes with a finite
loss; with the same seed its sampled cohorts and round batches and its
upload/download byte totals equal the JAX trainer's (exactly: both are
host-side numpy and integer counts). Without ``--device`` the trainer
runs on cuda, and with no card it raises instead of falling back.
"""

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


@pytest.mark.parametrize("argv,name", [
    (["--mode", "true_topk", "--error_type", "virtual"], "--mode true_topk"),
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

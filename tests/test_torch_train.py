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

import torch_threads  # noqa: F401  (the worker's share of the cores)
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
    (["--alarm_job_starvation", "2"], "--alarm_job_starvation"),
    (["--slo_window", "4", "--slo_fast_window", "2", "--slo_round_p95",
      "1e-9", "--alarm_slo_burn", "1"], "--slo_window"),
])
def test_ops_options_run_the_trainer(tmp_path, argv, name):
    """The job service's alarm knob and the SLO engine parse and the
    trainer runs with them as without, row for row; an SLO below every
    round's wall burns from the fast window on, and its alarm fires."""
    import json
    base = ["--device", "cpu", "--test", "--local_momentum", "0",
            "--num_clients", "10", "--num_workers", "2",
            "--dataset_name", "Synthetic", "--num_epochs", "3"]
    ledger = str(tmp_path / f"{name[2:]}.jsonl")
    keep = lambda rows: [{k: v for k, v in r.items()  # noqa: E731
                          if "time" not in k} for r in rows]
    plain = keep(cv_train.main(base))
    got = keep(cv_train.main(base + argv + ["--ledger", ledger]))
    assert got == plain
    with open(ledger) as f:
        rounds = [r for r in map(json.loads, f) if r["kind"] == "round"]
    assert len(rounds) == 3
    if name == "--slo_window":
        assert [r["slo"]["round_latency"]["burn"] for r in rounds] == \
            [0.0, 20.0, 20.0]
        assert [[a["rule"] for a in r["alarms"]] for r in rounds] == \
            [[], ["slo_burn"], ["slo_burn"]]
    else:
        assert all(r["slo"] is None and not r["alarms"] for r in rounds)


@pytest.mark.parametrize("argv,name", [
    (["--resume"], "--resume"),
    (["--seq_devices", "2"], "--seq_devices"),
])
def test_unported_options_raise(argv, name):
    """Options the port lacks raise naming themselves; ``--resume`` is
    ported, and raises naming itself without ``--checkpoint``."""
    base = ["--device", "cpu", "--test", "--local_momentum", "0",
            "--num_clients", "10", "--num_workers", "2"]
    if "--dataset_name" not in argv:
        base += ["--dataset_name", "Synthetic"]
    # --seq_devices: a ValueError, as the reference's (cv_train.py:485)
    with pytest.raises(ValueError, match=name):
        cv_train.main(base + argv)


def test_per_client_quantized_wire_raises():
    """The per-client quantized wire (each client's clipped table
    crosses the wire quantized on its own) raised until it was ported;
    now it runs, and each client's upload is priced at the int8
    wire."""
    results = cv_train.main(["--device", "cpu"] + ARGV + [
        "--max_grad_norm", "1", "--sketch_dtype", "int8"])
    assert len(results) == 2
    for row in results:
        assert np.isfinite(row["train_loss"])
        # one round an epoch (--test) of 2 clients, each one 1 x 10
        # int8 table and its row scale
        assert row["up (MiB)"] == 2 * (10 + 4) / 2**20


def test_gpt2_trainer_other_modes_raise(tmp_path):
    """GPT-2's other modes run (tests/test_torch_gpt2_modes.py), and so
    does a mode of the per-client round beside ``--remat``, which raised
    until its clients ran one after another in plain autograd
    (core/grad.py ``map_clients``)."""
    from commefficient_tpu_torch.train import gpt2_train
    base = ["--device", "cpu", "--test", "--dataset_dir", str(tmp_path),
            "--num_workers", "2", "--local_batch_size", "2",
            "--valid_batch_size", "2", "--num_epochs", "1"]
    results = gpt2_train.main(base + ["--mode", "true_topk",
                                      "--error_type", "virtual",
                                      "--local_momentum", "0"])
    assert np.isfinite(results[-1]["train_loss"])
    results = gpt2_train.main(base + ["--mode", "local_topk",
                                      "--error_type", "local",
                                      "--local_momentum", "0", "--remat"])
    assert np.isfinite(results[-1]["train_loss"])


# --- the download support as a packed bitmap; --pipeline_depth -------------


@pytest.mark.parametrize("d", [1, 13, 6_584_003])
def test_packbits_matches_numpy(d):
    """The device-side pack of a support mask (ops/vec.py) is
    ``np.packbits`` of it, bit for bit, at d not a multiple of 8."""
    from commefficient_tpu_torch.ops.vec import packbits
    mask = np.random.RandomState(d % 97).rand(d) < 0.3
    got = packbits(torch.from_numpy(mask)).numpy()
    assert got.dtype == np.uint8
    assert got.tobytes() == np.packbits(mask).tobytes()
    assert np.array_equal(np.unpackbits(got)[:d].astype(bool), mask)


SUPPORT_ARGV = {
    "local_topk": MODE_ARGV["local_topk"],
    # the bytes depend on the update's support, not on how much local
    # work made it: one local step over each client's whole batch
    "fedavg": MODE_ARGV["fedavg"] + ["--fedavg_batch_size", "-1"],
    "true_topk": MODE_ARGV["true_topk"],
    "sketch": [],
}


@pytest.mark.parametrize("mode", sorted(SUPPORT_ARGV))
def test_support_bitmap_bills_the_bytes_of_int64_indices(mode,
                                                         monkeypatch):
    """Four --test rounds of each mode, their supports crossing as packed
    bitmaps and, as before the bitmap, as the int64 indices of the
    changed coordinates (``torch.nonzero``): per-round, per-client
    download and upload bytes equal. The threshold-select paths (true_topk's
    and the sketch's bitmap) are made to engage at this small d."""
    from commefficient_tpu_torch.core import server
    from commefficient_tpu_torch.ops import topk
    from commefficient_tpu_torch.runtime import fed_model
    monkeypatch.setattr(topk, "_THRESHOLD_SELECT_MIN_D", 16)
    argv = (["--device", "cpu"] + ARGV + SUPPORT_ARGV[mode]
            + ["--num_epochs", "4"])

    def run():
        billed, forms = [], []
        account = fed_model.FedModel._account_bytes

        def record(self, *a, **kw):
            billed.append(account(self, *a, **kw))
            return billed[-1]

        note = fed_model.FedModel.note_update

        def seen(self, support):
            forms.append(type(support).__name__)
            return note(self, support)

        with monkeypatch.context() as m:
            m.setattr(fed_model.FedModel, "_account_bytes", record)
            m.setattr(fed_model.FedModel, "note_update", seen)
            cv_train.main(argv)
        return billed, forms

    bitmap, forms = run()
    assert len(bitmap) == 4 and set(forms) == {"dict"}

    def indices(mask):
        return torch.nonzero(mask).flatten()

    apply_note = fed_model.FedModel._apply_note

    def apply_indices(self, support):
        if isinstance(support, dict):  # the indices' form before
            idx = support["bitmap"]
            assert idx.dtype == torch.int64
            support = (idx, torch.ones(idx.shape))
        return apply_note(self, support)

    monkeypatch.setattr(server, "packbits", indices)
    monkeypatch.setattr(fed_model, "packbits", indices)
    monkeypatch.setattr(fed_model.FedModel, "_apply_note", apply_indices)
    before, _ = run()
    assert len(before) == 4
    for r, ((down, up), (down0, up0)) in enumerate(zip(bitmap, before)):
        np.testing.assert_array_equal(down, down0, err_msg=f"round {r}")
        np.testing.assert_array_equal(up, up0, err_msg=f"round {r}")
    assert sum(d.sum() for d, _ in bitmap) > 0


def _tiny_build(monkeypatch):
    """``--test``'s one-channel ResNet9, without ``--test``'s one round
    an epoch."""
    port_build = cv_train.build_model
    monkeypatch.setattr(cv_train, "build_model", lambda args, device="cpu":
                        port_build(args.replace(do_test=True), device))


# 5 rounds: 0.0625 of an 80-round epoch (10 clients x 64 samples in
# rounds of 2 x 4), the --test sketch
PIPE_ARGV = ["--device", "cpu", "--dataset_name", "Synthetic",
             "--num_clients", "10", "--num_workers", "2",
             "--local_batch_size", "4", "--k", "10", "--num_cols", "10",
             "--num_rows", "1", "--num_blocks", "1", "--num_epochs",
             "0.0625", "--pivot_epoch", "0.03", "--lr_scale", "0.1"]
PIPE_MODES = {
    "sketch": ["--mode", "sketch", "--error_type", "virtual",
               "--local_momentum", "0", "--virtual_momentum", "0.9"],
    "local_topk": ["--mode", "local_topk", "--error_type", "local",
                   "--local_momentum", "0.9"],
}


@pytest.mark.parametrize("mode", sorted(PIPE_MODES))
def test_pipelined_trainer_matches_depth_one(mode, monkeypatch):
    """5 rounds at --pipeline_depth 3 (a flush of 3, then a ragged one
    of 2 at the epoch's end) against depth 1: per-round losses, the
    epoch's accuracies and byte totals, bit for bit."""
    _tiny_build(monkeypatch)
    argv = PIPE_ARGV + PIPE_MODES[mode]
    one = cv_train.main(argv)
    model = fed_model_current()
    assert model.pipeline_depth == 1
    three = cv_train.main(argv + ["--pipeline_depth", "3"])
    model = fed_model_current()
    assert model.pipeline_depth == 3 and not model._inflight \
        and not model._oplog
    assert len(one) == len(three) == 1
    assert len(one[0]["round_losses"]) == 5
    for key in ("round_losses", "train_loss", "train_acc", "test_loss",
                "test_acc", "down (MiB)", "up (MiB)"):
        assert one[0][key] == three[0][key], key
    assert one[0]["down (MiB)"] > 0


def fed_model_current():
    from commefficient_tpu_torch.runtime import fed_model
    return fed_model._CURRENT_MODEL


def test_pipelined_divergence_stop(monkeypatch, capsys):
    """A loss over --nan_threshold stops training at the flush that
    brings it to the host: the first round's, after 3 rounds were
    dispatched at --pipeline_depth 3 (1 at depth 1)."""
    _tiny_build(monkeypatch)
    argv = PIPE_ARGV + PIPE_MODES["sketch"] + ["--nan_threshold", "-1"]
    for depth, dispatched in (("1", 1), ("3", 3)):
        assert cv_train.main(argv + ["--pipeline_depth", depth]) == []
        assert fed_model_current().round_index == dispatched
        assert "Stopping at batch 0: diverged" in capsys.readouterr().out


def test_chunk_and_pipeline_flags(tmp_path):
    """``--client_chunk`` and ``--pipeline_depth`` parse (the reference's
    defaults, 0 and 1); a depth below 1 is refused with the reference's
    message; gpt2_train runs the per-client round beside ``--attn_impl
    flash`` (its vmap rules) and beside ``--remat``."""
    from commefficient_tpu.config import Config as JaxConfig
    from commefficient_tpu_torch.config import NOT_PORTED_FLAGS, Config
    from commefficient_tpu_torch.train import gpt2_train
    assert "--client_chunk" not in NOT_PORTED_FLAGS
    assert "--pipeline_depth" not in NOT_PORTED_FLAGS
    cfg = parse_args(argv=["--client_chunk", "3", "--pipeline_depth", "2"])
    assert (cfg.client_chunk, cfg.pipeline_depth) == (3, 2)
    default = parse_args(argv=[])
    jdefault = jax_parse_args(argv=[])
    assert (default.client_chunk, default.pipeline_depth) == \
        (jdefault.client_chunk, jdefault.pipeline_depth) == (0, 1)
    with pytest.raises(AssertionError) as port_err:
        Config(pipeline_depth=0)
    with pytest.raises(AssertionError) as jax_err:
        JaxConfig(pipeline_depth=0)
    assert str(port_err.value) == str(jax_err.value)
    base = ["--device", "cpu", "--test"]
    # the per-client round beside --attn_impl flash passes the check (it
    # runs in tests/test_torch_attention.py)
    flash = parse_args(argv=base + ["--pipeline_depth", "2", "--attn_impl",
                                    "flash", "--microbatch_size", "1"])
    assert flash.validate_runtime().attn_impl == "flash"
    results = gpt2_train.main(base + ["--max_grad_norm", "1", "--remat",
                                      "--dataset_dir", str(tmp_path)])
    assert np.isfinite(results[-1]["train_loss"])

"""The reference's command lines on the port.

The eight flags the reference parses and never reads (``--num_results_train``,
``--num_results_val``, ``--port``, ``--share_ps_gpu``,
``--train_dataloader_workers``, ``--val_dataloader_workers``,
``--param_dtype``, ``--compute_dtype``) parse on the port, and at values
other than their defaults leave a small ResNet9 run bit for bit as it
was. The port's run-registry ``config_dict`` of an argv equals the
reference's, key by key, but for the keys listed below with their
reasons; ``scripts/gpt2_personachat.sh``'s own flags, read from the
file, reach the port's GPT-2 trainer with the reference trainer's
``config_dict``.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import dataclasses
import os

import pytest
import torch

from commefficient_tpu.config import parse_args as jax_parse_args
from commefficient_tpu.telemetry.registry import config_dict as jax_config_dict
from commefficient_tpu.train import gpt2_train as jax_gpt2_train
from commefficient_tpu_torch.config import NOT_PORTED_FLAGS, parse_args
from commefficient_tpu_torch.runtime import fed_model
from commefficient_tpu_torch.telemetry.registry import config_dict
from commefficient_tpu_torch.train import cv_train, gpt2_train
from commefficient_tpu_torch.utils import recipe_argv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

UNREAD = ["--num_results_train", "5", "--num_results_val", "3",
          "--port", "7001", "--share_ps_gpu",
          "--train_dataloader_workers", "4", "--val_dataloader_workers", "2",
          "--param_dtype", "bfloat16", "--compute_dtype", "bfloat16"]

ARGV = ["--device", "cpu", "--test", "--dataset_name", "Synthetic",
        "--mode", "sketch", "--error_type", "virtual", "--local_momentum",
        "0", "--virtual_momentum", "0.9", "--num_clients", "10",
        "--num_workers", "2", "--local_batch_size", "4", "--num_epochs",
        "2", "--lr_scale", "0.1", "--pivot_epoch", "1", "--seed", "5"]

# rows' wall-clock fields, never compared
TIMES = ("train_time", "test_time", "total_time", "round_times")


def _flag_field(flag):
    return flag[2:]


# the flags of the SLOs, the live exporter, causal tracing, the
# autopilot and the job service, each set away from its default
PORTED_OPS = ["--alarm_job_starvation", "2", "--live_port", "9100",
              "--causal_trace", "--slo_round_p95", "0.5",
              "--slo_staleness_max", "3", "--slo_eps_rounds", "40",
              "--slo_starvation", "4", "--slo_error_budget", "0.1",
              "--slo_window", "16", "--slo_fast_window", "4",
              "--alarm_slo_burn", "2", "--autopilot", "on",
              "--autopilot_band", "0.2:0.6", "--autopilot_cooldown", "3",
              "--autopilot_cache_size", "6", "--autopilot_warm_ahead", "0",
              "--autopilot_pin", "int8-k50000-r5-c250000-re9500",
              "--autopilot_geometry"]
# what those need to pass the reference's asserts
PORTED_OPS_NEEDS = ["--probe_every", "1", "--dp", "sketch",
                    "--dp_noise_mult", "1.0", "--dp_epsilon", "8"]


def test_not_ported_flags_are_7():
    # named when seven were left; the multi-host flags are ported, and
    # since sequence parallelism none is left
    assert NOT_PORTED_FLAGS == ()
    argv = ["--seq_devices", "4", "--seq_impl", "ulysses"]
    ours, ref = parse_args(argv=argv), jax_parse_args(None, argv)
    assert (ours.seq_devices, ours.seq_impl) == \
        (ref.seq_devices, ref.seq_impl) == (4, "ulysses")
    ours, ref = parse_args(argv=[]), jax_parse_args(None, [])
    assert (ours.seq_devices, ours.seq_impl) == \
        (ref.seq_devices, ref.seq_impl) == (1, "ring")
    for flag in ("--coordinator_address", "--num_processes",
                 "--process_id"):
        assert flag not in NOT_PORTED_FLAGS
    assert "--num_devices" not in NOT_PORTED_FLAGS
    assert "--mesh" not in NOT_PORTED_FLAGS
    for flag in UNREAD + PORTED_OPS:
        assert flag not in NOT_PORTED_FLAGS
    assert "--approx_topk" not in NOT_PORTED_FLAGS
    assert "--approx_recall" not in NOT_PORTED_FLAGS


def test_ported_ops_flags_take_the_reference_types_and_defaults():
    ours, ref = parse_args(argv=[]), jax_parse_args(None, [])
    argv = PORTED_OPS + PORTED_OPS_NEEDS
    set_ours, set_ref = parse_args(argv=argv), jax_parse_args(None, argv)
    flags = [f for f in PORTED_OPS if f.startswith("--")]
    assert len(flags) == 18
    for flag in flags:
        field = _flag_field(flag)
        assert getattr(ours, field) == getattr(ref, field), field
        assert type(getattr(ours, field)) is type(getattr(ref, field)), \
            field
        assert getattr(set_ours, field) == getattr(set_ref, field), field
        assert type(getattr(set_ours, field)) is \
            type(getattr(set_ref, field)), field
        assert getattr(set_ours, field) != getattr(ours, field), field


@pytest.mark.parametrize("argv", [
    ["--alarm_job_starvation", "-1"], ["--live_port", "70000"],
    ["--slo_round_p95", "-1"], ["--slo_eps_rounds", "5"],
    ["--slo_error_budget", "0"], ["--slo_window", "0"],
    ["--slo_window", "4", "--slo_fast_window", "8"],
    ["--alarm_slo_burn", "-1"], ["--autopilot_cooldown", "-1"],
    ["--autopilot_cache_size", "0"],
    ["--autopilot", "on", "--probe_every", "1"],
    ["--autopilot", "on", "--autopilot_band", "0.6:0.2",
     "--probe_every", "1"],
    ["--autopilot", "on", "--autopilot_band", "x", "--probe_every", "1"],
    ["--autopilot", "on", "--autopilot_band", "0.2:0.6"],
    ["--autopilot", "on", "--autopilot_band", "0.2:0.6",
     "--probe_every", "1", "--mode", "true_topk"],
], ids=lambda a: "_".join(x.strip("-") for x in a[:2]))
def test_ported_ops_flags_assert_as_the_reference(argv):
    with pytest.raises(AssertionError) as ref:
        jax_parse_args(None, argv)
    with pytest.raises(AssertionError) as ours:
        parse_args(argv=argv)
    assert str(ours.value) == str(ref.value)


def test_unread_flags_take_the_reference_types_and_defaults():
    ours, ref = parse_args(argv=[]), jax_parse_args(None, [])
    set_ours, set_ref = parse_args(argv=UNREAD), jax_parse_args(None, UNREAD)
    for flag in UNREAD:
        if not flag.startswith("--"):
            continue
        field = _flag_field(flag)
        assert getattr(ours, field) == getattr(ref, field), field
        assert getattr(set_ours, field) == getattr(set_ref, field), field
        assert type(getattr(set_ours, field)) is \
            type(getattr(set_ref, field)), field
        assert getattr(set_ours, field) != getattr(ours, field), field


def _run(argv):
    fed_model._CURRENT_MODEL = None
    rows = cv_train.main(argv)
    weights = fed_model._CURRENT_MODEL.ps_weights.clone()
    return [{k: v for k, v in r.items() if k not in TIMES}
            for r in rows], weights


def test_unread_flags_leave_a_round_bit_for_bit():
    rows, weights = _run(ARGV)
    rows_u, weights_u = _run(ARGV + UNREAD)
    assert rows_u == rows
    assert torch.equal(weights_u, weights)


def _only_reference_keys():
    """The reference's config keys the port lacks: the fields of the
    flags it does not have yet (``NOT_PORTED_FLAGS``; the hash leaves
    out the observability knobs among them)."""
    ref = jax_config_dict(jax_parse_args(None, []))
    return {k for k in ref if f"--{k}" in NOT_PORTED_FLAGS}


@pytest.mark.parametrize("argv", [
    [],
    UNREAD,
    ["--mode", "true_topk", "--approx_topk", "--approx_recall", "0.5",
     "--k", "123", "--dataset_name", "CIFAR10", "--iid"],
    ["--dataset_name", "ImageNet", "--model", "FixupResNet50",
     "--mixup", "--mixup_alpha", "0.2"],
    PORTED_OPS + PORTED_OPS_NEEDS,
], ids=["defaults", "unread", "approx", "imagenet", "ops"])
def test_config_dict_equals_the_reference_key_by_key(argv):
    ref = jax_config_dict(jax_parse_args(None, argv))
    ours = config_dict(parse_args(argv=argv))
    # the keys only the reference has: its flags the port does not
    # have yet (each raises NotImplementedError on the port)
    only_ref = set(ref) - set(ours)
    assert only_ref == _only_reference_keys()
    assert not set(ours) - set(ref)
    for key in sorted(set(ref) & set(ours)):
        if key == "device":
            # the one default the port changes: cuda, not tpu
            assert (ref[key], ours[key]) == ("tpu", "cuda")
            continue
        assert ours[key] == ref[key], key


class _Stop(Exception):
    pass


def _trainer_args(monkeypatch, module, argv):
    seen = []

    def stop(args, *a, **kw):
        seen.append(args)
        raise _Stop

    monkeypatch.setattr(module, "build_model_and_tokenizer", stop)
    with pytest.raises(_Stop):
        module.main(argv)
    return seen[0]


def test_gpt2_recipe_argv_reaches_the_trainer_as_the_reference(monkeypatch):
    argv = recipe_argv(os.path.join(REPO, "scripts", "gpt2_personachat.sh"),
                       {"DATASET_DIR": "data/personachat",
                        "MODEL_CHECKPOINT": "data/gpt2"})
    assert "--approx_topk" in argv
    ref = _trainer_args(monkeypatch, jax_gpt2_train, argv)
    ours = _trainer_args(monkeypatch, gpt2_train, argv + ["--device", "cpu"])
    assert ours.num_results_train == ref.num_results_train == 1
    assert ours.approx_topk and ref.approx_topk
    ref_d, ours_d = jax_config_dict(ref), config_dict(ours)
    assert set(ref_d) - set(ours_d) == _only_reference_keys()
    assert not set(ours_d) - set(ref_d)
    for key in sorted(set(ref_d) & set(ours_d)):
        if key == "device":
            # the run was asked onto the CPU; the reference's default
            assert (ref_d[key], ours_d[key]) == ("tpu", "cpu")
            continue
        assert ours_d[key] == ref_d[key], key


@pytest.mark.parametrize("recall", ["0", "1.5"])
def test_approx_recall_outside_0_1_raises_as_the_reference(recall):
    argv = ["--approx_topk", "--approx_recall", recall]
    with pytest.raises(AssertionError, match="approx_recall") as ref:
        jax_parse_args(None, argv)
    with pytest.raises(AssertionError, match="approx_recall") as ours:
        parse_args(argv=argv)
    assert str(ours.value) == str(ref.value)


def test_approx_topk_fields_reach_the_sketch():
    from commefficient_tpu_torch.core.rounds import args2sketch
    cfg = parse_args(argv=["--approx_topk", "--approx_recall", "0.7"])
    cfg.grad_size = 1000
    sketch = args2sketch(cfg)
    assert sketch.approx_topk and sketch.approx_recall == 0.7
    assert dataclasses.replace(sketch, approx_topk=False) != sketch

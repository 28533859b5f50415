"""The roofline cost model (``analysis/cost.py``) against the
reference's, on the CPU.

On the plain paths, ResNet9 and tiny GPT-2 (``--fused_ce off``, plain
attention), the port's FLOP inventory of the client pass
(``FlopCounterMode`` over the model's forward and backward on the
first profiled round's batch) gives the reference's ``flop_inventory``
of its lowered round: ``total_flops`` and ``conv_flops`` equal. The
cost model's meta record validates under the reference's
``validate_record`` and has its keys; the count leaves the weights and
the random generators as they were; the device-time buckets carry
``roofline_utilization`` as the reference's telemetry derives it; and
the kernels' own counts (which only a card's launches add) join the
inventory as dot FLOPs.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import contextlib
import json

import pytest
import torch

from commefficient_tpu.analysis import cost as jax_cost
from commefficient_tpu.runtime import fed_model as jax_fed_model
from commefficient_tpu.telemetry import profiler as jax_profiler
from commefficient_tpu.telemetry.core import Telemetry as JaxTelemetry
from commefficient_tpu.telemetry.record import \
    validate_record as jax_validate_record
from commefficient_tpu.train import cv_train as jax_cv_train
from commefficient_tpu.train import gpt2_train as jax_gpt2_train
from commefficient_tpu_torch.analysis import cost
from commefficient_tpu_torch.runtime import fed_model
from commefficient_tpu_torch.telemetry.core import Telemetry
from commefficient_tpu_torch.train import cv_train, gpt2_train

CV_ARGV = ["--test", "--dataset_name", "Synthetic", "--mode", "sketch",
           "--error_type", "virtual", "--local_momentum", "0",
           "--virtual_momentum", "0.9", "--num_clients", "10",
           "--num_workers", "2", "--local_batch_size", "4",
           "--num_epochs", "1", "--lr_scale", "0.1", "--pivot_epoch", "1",
           "--seed", "5"]
GPT2_ARGV = ["--test", "--dataset_name", "PERSONA", "--mode", "sketch",
             "--error_type", "virtual", "--local_momentum", "0",
             "--virtual_momentum", "0.9", "--num_workers", "2",
             "--local_batch_size", "2", "--valid_batch_size", "2",
             "--num_epochs", "1", "--seed", "5"]


class _Stop(Exception):
    pass


def _jax_cost_model(monkeypatch, main, argv):
    """The reference's cost model of its first --profile'd round (its
    lowered round's ``flop_inventory``), the run stopped there and its
    trace window stubbed: nothing is traced."""
    got = {}
    emit = jax_fed_model.FedModel._emit_cost_model

    def capture(self, fn, args):
        emit(self, fn, args)
        got.update(self._cost_model)
        raise _Stop

    monkeypatch.setattr(jax_fed_model.FedModel, "_emit_cost_model", capture)
    monkeypatch.setattr(jax_profiler, "profile_epoch",
                        lambda *a, **k: contextlib.nullcontext())
    with pytest.raises(_Stop):
        main(argv + ["--profile", "--ledger", "jax.jsonl"])
    return got


def _port_run(main, argv):
    main(["--device", "cpu"] + argv + ["--profile", "--ledger",
                                       "port.jsonl"])
    with open("port.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("model", ["resnet9", "gpt2"])
def test_flops_equal_the_reference_inventory(model, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if model == "resnet9":
        ours_main, jax_main, argv = cv_train.main, jax_cv_train.main, CV_ARGV
    else:
        ours_main, jax_main = gpt2_train.main, jax_gpt2_train.main
        argv = GPT2_ARGV + ["--dataset_dir", str(tmp_path / "ds")]
        ours_main = (lambda a, main=ours_main: main(a + ["--fused_ce",
                                                         "off"]))
    recs = _port_run(ours_main, argv)
    (ours,) = [r["cost_model"] for r in recs
               if r["kind"] == "meta" and "cost_model" in r]
    theirs = _jax_cost_model(monkeypatch, jax_main, argv)
    assert ours["total_flops"] > 0
    # the ops: a convolution on both sides is a conv, any other counted
    # product a dot; neither side counts an elementwise op
    for key in ("total_flops", "conv_flops", "dot_flops", "flops_by_dtype"):
        assert ours[key] == theirs[key], key
    assert ours["kernel_flops"] == {}   # the plain versions on the CPU
    assert set(theirs) <= set(ours)
    assert set(ours) - set(theirs) == {"kernel_flops"}
    for key in ("chip", "backend", "wire_dtype", "allreduce_payload_bytes"):
        assert ours[key] == theirs[key], key
    # the reference's CPU run spans its 8-device test mesh, the port
    # one device: the same FLOPs over 1 device's peak
    assert ours["n_devices"] == 1 and ours["label"].endswith("/1dev")
    assert ours["compute_floor_s"] == pytest.approx(
        theirs["compute_floor_s"] * theirs["n_devices"], rel=1e-12)
    for rec in recs:
        assert jax_validate_record(rec) == [], rec


def test_cost_model_keys_and_bounds_equal_the_reference():
    flops = {"dot_flops": 3 * 10 ** 12, "conv_flops": 10 ** 12,
             "total_flops": 4 * 10 ** 12, "dot_count": 7, "conv_count": 2,
             "by_dtype": {"bf16": 4 * 10 ** 12}}
    kw = dict(backend="gpu", device_kind="NVIDIA H100 80GB HBM3",
              n_devices=4, allreduce_payload_bytes=5 * 524_288 * 4.0,
              wire_dtype="f32", label="sketch/device/4dev")
    ours = cost.build_cost_model(flops, **kw)
    assert ours["chip"] == "h100" and cost.CHIP_SPECS["h100"].peak_flops \
        == 989e12 and cost.CHIP_SPECS["h100"].hbm_gbps == 3350.0
    spec = cost.chip_spec("gpu", "NVIDIA H100 80GB HBM3")
    jspec = jax_cost.ChipSpec(*(getattr(spec, f) for f in (
        "name", "peak_flops", "hbm_gbps", "ici_gbps")))
    assert ours["expected_round_s"] == jax_cost.expected_round_seconds(
        flops["total_flops"], kw["allreduce_payload_bytes"], jspec,
        4)["expected_round_s"]
    theirs = jax_cost.build_cost_model("", **kw)
    assert set(ours) == set(theirs)
    assert cost.chip_spec("gpu", "NVIDIA A100") == \
        cost.CHIP_SPECS["gpu"] and jax_cost.chip_spec("gpu").name == "gpu"
    for backend, kind in (("tpu", "TPU v5 lite"), ("tpu", "TPU v4"),
                          ("cpu", "")):
        assert cost.chip_spec(backend, kind).name == \
            jax_cost.chip_spec(backend, kind).name
    assert cost.ring_allreduce_wire_bytes(100.0, 4) == \
        jax_cost.ring_allreduce_wire_bytes(100.0, 4)
    assert cost.utilization(2.0, 4.0) == jax_cost.utilization(2.0, 4.0)
    assert cost.utilization(None, 4.0) is None


def test_kernel_counts_join_the_inventory_only_inside_a_count():
    cost.add_kernel_flops("flce_fwd", 10, torch.bfloat16)   # no count open
    x = torch.randn(4, 8)
    w = torch.randn(8, 3)

    def fn():
        torch.mm(x, w)
        cost.add_kernel_flops("flce_fwd", cost.flce_fwd_flops(5, 7, 3),
                              torch.bfloat16)
        for name, f in cost.attn_flops(1, 2, 4, 8).items():
            cost.add_kernel_flops(name, f, torch.bfloat16)

    inv = cost.flop_inventory(fn)
    attn = cost.attn_flops(1, 2, 4, 8)
    assert attn == {"attn_fwd": 4 * 8 * 20, "attn_bwd_dkv": 8 * 8 * 20,
                    "attn_bwd_dq": 6 * 8 * 20}
    assert inv["kernel_flops"] == {"flce_fwd": 2 * 5 * 7 * 3, **attn}
    assert cost.flce_bwd_flops(5, 7, 3) == 6 * 5 * 7 * 3
    mm = 2 * 4 * 8 * 3
    assert inv["dot_flops"] == mm + sum(inv["kernel_flops"].values())
    assert inv["total_flops"] == inv["dot_flops"]
    assert inv["by_dtype"] == {"f32": mm,
                               "bf16": sum(inv["kernel_flops"].values())}
    assert (inv["dot_count"], inv["conv_count"]) == (5, 0)
    assert inv["ops"]["aten.mm"] == mm


def test_count_leaves_weights_and_generators(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    seen = {}
    emit = fed_model.FedModel._emit_cost_model

    def watch(self, batch):
        w0, g0 = self.ps_weights.clone(), torch.get_rng_state()
        emit(self, batch)
        seen["same"] = (torch.equal(self.ps_weights, w0)
                        and torch.equal(torch.get_rng_state(), g0)
                        and self.ps_weights.grad is None)
        seen["expected"] = self.telemetry.expected_round_s

    monkeypatch.setattr(fed_model.FedModel, "_emit_cost_model", watch)
    cv_train.main(["--device", "cpu"] + CV_ARGV + ["--profile", "--ledger",
                                                   "x.jsonl"])
    assert seen["same"] and seen["expected"] > 0


@pytest.mark.parametrize("tel_cls", [Telemetry, JaxTelemetry])
def test_device_time_buckets_carry_utilization(tel_cls):
    class Sink:
        def __init__(self):
            self.recs = []

        def write(self, rec):
            self.recs.append(rec)

        def close(self):
            pass

    sink = Sink()
    tel = tel_cls([sink])
    tel.expected_round_s = 0.0012
    tel.hold_emission(True)
    tel.begin_round(0)
    tel.set_round_bytes(0, 1.0, 1.0)
    tel.begin_round(1)
    tel.set_round_bytes(1, 1.0, 1.0)
    tel.merge_round_device_time(0, {"busy_s": 0.004, "window_s": 0.01})
    tel.merge_round_device_time(1, {"busy_s": 0.0, "window_s": 0.01})
    tel.close()
    rounds = [r for r in sink.recs if r["kind"] == "round"]
    assert rounds[0]["device_time"]["roofline_utilization"] == 0.3
    assert "roofline_utilization" not in rounds[1]["device_time"]

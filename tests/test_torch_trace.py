"""Device-time attribution on Kineto traces (telemetry/trace.py), on the
CPU.

``attribute_rounds`` on a Chrome trace in the format
``torch.profiler``'s ``export_chrome_trace`` writes, built here by hand:
the round windows are the host's ``fed_round::<r>`` ranges; the card's
work is the ``kernel``/``gpu_memcpy``/``gpu_memset`` events on the
device's lanes, two streams overlapping; the ``gpu_user_annotation``
copies of the host ranges and every host event are not work. The
buckets sum to each window exactly, overlapping and nested events are
counted once, and each bucket equals its value worked out by hand. A
real ``torch.profiler`` window over FedModel-style round markers (the
CPU's trace has no device lane) attributes every round's window to the
host gap and merges the buckets onto the held ledger records.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import json
import math

import torch

from commefficient_tpu_torch.telemetry import core, trace
from commefficient_tpu_torch.telemetry.profiler import trace_window


def X(name, cat, ts, dur, pid, tid, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def kineto_trace():
    """Round 0 over [1000, 2000) us, round 1 over [2000, 2600) us (host
    lanes pid 4242). On the card (pid 0): stream 7 runs kernels
    [1100, 1300) and a nested-looking [1200, 1250) copy of one, a
    memcpy [1400, 1500), a memset [1500, 1510); stream 13 a kernel
    [1250, 1450) overlapping both and an NCCL kernel [1600, 1700);
    kernel [1990, 2100) straddles the rounds. A gpu_user_annotation
    covers [1000, 2000) on the device and must not count."""
    host, dev = 4242, 0
    return [
        {"ph": "M", "name": "process_name", "pid": dev,
         "args": {"name": "GPU 0"}},
        X("fed_round::0", "user_annotation", 1000.0, 1000.0, host, 1),
        X("fed_round::1", "user_annotation", 2000.0, 600.0, host, 1),
        X("fed_phase::server", "user_annotation", 1050.0, 100.0, host, 1),
        X("aten::mm", "cpu_op", 1050.0, 20.0, host, 1),
        X("cudaLaunchKernel", "cuda_runtime", 1060.0, 5.0, host, 1),
        X("fed_round::0", "gpu_user_annotation", 1000.0, 1000.0, dev, 7),
        X("gemm", "kernel", 1100.0, 200.0, dev, 7, device=0, stream=7),
        X("gemm_part", "kernel", 1200.0, 50.0, dev, 7, device=0, stream=7),
        X("Memcpy HtoD", "gpu_memcpy", 1400.0, 100.0, dev, 7, device=0),
        X("Memset", "gpu_memset", 1500.0, 10.0, dev, 7, device=0),
        X("cet_sketch", "kernel", 1250.0, 200.0, dev, 13, device=0),
        X("ncclDevKernel_AllReduce", "kernel", 1600.0, 100.0, dev, 13,
          device=0),
        X("cet_flce_bwd", "kernel", 1990.0, 110.0, dev, 7, device=0),
    ]


def test_buckets_sum_to_each_window_and_count_overlaps_once():
    out = trace.attribute_rounds(kineto_trace())
    assert sorted(out) == [0, 1]
    r0, r1 = out[0], out[1]
    # round 0: busy is the union [1100, 1510) + [1600, 1700) + [1990,
    # 2000) = 410 + 100 + 10 us; the memcpy's 100 us are transfer, also
    # where stream 13 computes beside it, and compute the rest
    assert r0["window_s"] == 1e-3
    assert math.isclose(r0["busy_s"], 520e-6, abs_tol=1e-12)
    assert math.isclose(r0["collective_s"], 100e-6, abs_tol=1e-12)
    assert math.isclose(r0["transfer_s"], 100e-6, abs_tol=1e-12)
    assert math.isclose(r0["compute_s"], 320e-6, abs_tol=1e-12)
    assert math.isclose(r0["host_gap_s"], 480e-6, abs_tol=1e-12)
    # round 1 holds the straddling kernel's [2000, 2100) only
    assert math.isclose(r1["busy_s"], 100e-6, abs_tol=1e-12)
    assert math.isclose(r1["host_gap_s"], 500e-6, abs_tol=1e-12)
    for b in (r0, r1):
        parts = (b["compute_s"] + b["collective_s"] + b["transfer_s"]
                 + b["host_gap_s"])
        assert math.isclose(parts, b["window_s"], rel_tol=0,
                            abs_tol=1e-15)
        assert b["per_device"]["cuda:0"]["busy_s"] == b["busy_s"]
        assert b["skew"]["n_collectives"] == 0
    assert r0["per_device"]["cuda:0"]["wire_s"] == r0["collective_s"]


def test_host_events_and_annotations_are_not_device_work():
    events = [e for e in kineto_trace() if e.get("cat") in
              ("user_annotation", "cpu_op", "cuda_runtime",
               "gpu_user_annotation")]
    out = trace.attribute_rounds(events)
    assert out[0]["busy_s"] == 0 and out[0]["host_gap_s"] == 1e-3
    assert trace.lane_devices(kineto_trace()) == {(0, 7): "cuda:0",
                                                 (0, 13): "cuda:0"}


def test_trace_file_round_trip(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": kineto_trace()}))
    assert trace.find_trace_file(str(tmp_path)) == str(path)
    assert trace.attribute_logdir(str(tmp_path)) == \
        trace.attribute_rounds(kineto_trace())


def test_profiler_window_attributes_the_held_records(tmp_path):
    class Sink:
        records = []

        def write(self, rec):
            self.records.append(rec)

        def close(self):
            pass

    tel = core.Telemetry([Sink()])
    with trace_window(str(tmp_path), telemetry=tel) as win:
        for r in range(3):
            tel.begin_round(r)
            trace.begin_round_marker(r)
            with trace.phase("round_dispatch"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            tel.set_round_bytes(r, 1.0, 1.0)
        assert Sink.records == []   # held while the window is open
    assert not trace.tracing()
    assert sorted(win.round_buckets) == [0, 1, 2]
    tel.close()
    rounds = [r for r in Sink.records if r["kind"] == "round"]
    assert [r["round"] for r in rounds] == [0, 1, 2]
    for rec in rounds:
        b = rec["device_time"]
        assert b["window_s"] > 0 and b["busy_s"] == 0
        assert b["host_gap_s"] == b["window_s"]
    meta = [r for r in Sink.records if r["kind"] == "meta"]
    assert meta and meta[0]["trace_rounds"] == 3

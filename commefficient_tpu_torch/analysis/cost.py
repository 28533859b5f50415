"""Roofline cost model: the round time the card cannot beat.

Port of ``commefficient_tpu/analysis/cost.py``. For a round on
``n_devices`` cards

    expected_round_s = max(compute_time, collective_time)

with ``compute_time = FLOPs / (peak_flops x n_devices)`` and
``collective_time = ring all-reduce wire bytes / interconnect rate``.
Under ``--profile`` the ledger's device-time buckets then carry
``roofline_utilization = expected / measured busy`` (telemetry/core.py):
near 1 the round runs at the bound, 0.1 leaves 10x on the table.

The reference counts the FLOPs of its lowered StableHLO text
(``analysis/hlo.py flop_inventory``). The port has no such text, so
``flop_inventory`` runs the client pass once under
``torch.utils.flop_counter.FlopCounterMode`` and returns the same keys.
The port's hand-written kernels are opaque to that counter: each
wrapper adds its operations with ``add_kernel_flops`` where it
launches its kernel (at 2 FLOPs a multiply-add, the reference's
convention). On the CPU the wrappers run their plain versions, whose
matmuls the counter sees, so nothing is counted twice.

The peaks are coarse datasheet values: the model is a lower bound and
a trend instrument, not a simulator.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float        # bf16/f32 matmul peak per chip, FLOP/s
    hbm_gbps: float          # memory bandwidth, GB/s
    ici_gbps: float          # per-chip interconnect bandwidth, GB/s


# the reference's catalogue, plus the H100 SXM's datasheet values (989
# TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s NVLink each way); "cpu"
# is a small stand-in so CPU runs give finite utilizations
CHIP_SPECS = {
    "tpu-v4": ChipSpec("tpu-v4", 275e12, 1228.0, 50.0),
    "tpu-v5e": ChipSpec("tpu-v5e", 197e12, 819.0, 50.0),
    "tpu-v5p": ChipSpec("tpu-v5p", 459e12, 2765.0, 100.0),
    "tpu-v6e": ChipSpec("tpu-v6e", 918e12, 1640.0, 100.0),
    "h100": ChipSpec("h100", 989e12, 3350.0, 450.0),
    "gpu": ChipSpec("gpu", 312e12, 2039.0, 50.0),
    "cpu": ChipSpec("cpu", 2e11, 50.0, 10.0),
}


def chip_spec(backend: str, device_kind: str = "") -> ChipSpec:
    """Spec lookup from the backend (``gpu``/``cpu``, or the
    reference's ``tpu``) and the device's name (e.g.
    ``torch.cuda.get_device_name``: "NVIDIA H100 80GB HBM3")."""
    kind = (device_kind or "").lower()
    if backend == "tpu":
        if "v5 lite" in kind or "v5e" in kind or "v5litepod" in kind:
            return CHIP_SPECS["tpu-v5e"]
        if "v5p" in kind or "v5" in kind:
            return CHIP_SPECS["tpu-v5p"]
        if "v6" in kind:
            return CHIP_SPECS["tpu-v6e"]
        return CHIP_SPECS["tpu-v4"]
    if backend in ("gpu", "cuda"):
        if "h100" in kind:
            return CHIP_SPECS["h100"]
        return CHIP_SPECS["gpu"]
    return CHIP_SPECS["cpu"]


def ring_allreduce_wire_bytes(payload_bytes: float,
                              n_devices: int) -> float:
    """Per-chip wire traffic of a ring all-reduce: each chip sends
    (and receives) ``2 (n-1)/n`` of the payload."""
    n = max(int(n_devices), 1)
    if n == 1:
        return 0.0
    return 2.0 * payload_bytes * (n - 1) / n


def expected_round_seconds(total_flops: float,
                           allreduce_payload_bytes: float,
                           spec: ChipSpec,
                           n_devices: int) -> Dict:
    """Roofline lower bound for one round on ``n_devices`` chips.
    ``total_flops`` is the whole round's (every client's pass), so the
    compute leg divides by the device count."""
    n = max(int(n_devices), 1)
    compute_s = float(total_flops) / (spec.peak_flops * n)
    wire = ring_allreduce_wire_bytes(allreduce_payload_bytes, n)
    collective_s = wire / (spec.ici_gbps * 1e9)
    return {"compute_s": compute_s,
            "collective_s": collective_s,
            "expected_round_s": max(compute_s, collective_s),
            "wire_bytes_per_chip": wire}


# --- the FLOP inventory ---------------------------------------------------

# the element-type names of the reference's inventory (StableHLO's)
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16", torch.float64: "f64"}

# the kernels' additions while a count is open, else None
_KERNEL_COUNTS: Optional[list] = None


def dtype_name(dtype) -> str:
    return _DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def add_kernel_flops(name: str, flops: int, dtype) -> None:
    """Called by a kernel's wrapper where it launches: its operations
    join the open count (``flop_inventory``) as dot FLOPs; a no-op
    when no count is open."""
    if _KERNEL_COUNTS is not None:
        _KERNEL_COUNTS.append((name, int(flops), dtype_name(dtype)))


def flce_fwd_flops(m: int, v: int, c: int) -> int:
    """Kernel 5: the (M, C) x (C, V) logits product, 2·M·V·C."""
    return 2 * m * v * c


def flce_bwd_flops(m: int, v: int, c: int) -> int:
    """Kernel 6: the logits again, dX and dW, 6·M·V·C."""
    return 6 * m * v * c


def attn_flops(b: int, h: int, t: int, hd: int) -> Dict[str, int]:
    """F1-F3 on causal (B, H, T, hd) operands: T(T+1)/2 scores a head
    and 2·hd FLOPs a score a product; 2 products in the forward, 4 for
    dK/dV (the scores again, dP, dV, dK), 3 for dQ."""
    pairs = b * h * t * (t + 1) // 2
    return {"attn_fwd": 4 * hd * pairs, "attn_bwd_dkv": 8 * hd * pairs,
            "attn_bwd_dq": 6 * hd * pairs}


def _is_conv(op: str) -> bool:
    return "conv" in op


class _CallTally(TorchDispatchMode):
    """Inside a ``FlopCounterMode``: each op call's FLOPs (the counter's
    total before and after it) with its name and its first operand's
    type, for the inventory's counts and per-type split."""

    def __init__(self, counter):
        super().__init__()
        self.counter = counter
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.counter.get_total_flops()
        out = func(*args, **(kwargs or {}))
        flops = self.counter.get_total_flops() - before
        if flops:
            dtype = next((a.dtype for a in args
                          if isinstance(a, torch.Tensor)), None)
            self.calls.append((str(func.overloadpacket), int(flops),
                               dtype_name(dtype)))
        return out


@contextlib.contextmanager
def _kernel_counting():
    global _KERNEL_COUNTS
    prev, _KERNEL_COUNTS = _KERNEL_COUNTS, []
    try:
        yield _KERNEL_COUNTS
    finally:
        _KERNEL_COUNTS = prev


def flop_inventory(fn: Callable[[], object]) -> Dict:
    """Run ``fn`` (a client pass: the model's forward and backward) once
    under ``FlopCounterMode`` and return the reference's inventory keys:
    ``{"dot_flops", "conv_flops", "total_flops", "dot_count",
    "conv_count", "by_dtype"}``, plus ``kernel_flops`` (the hand-written
    kernels' additions by name, included in ``dot_flops``) and ``ops``
    (FLOPs by op name, the kernels' under their own names). Products
    count 2 FLOPs a multiply-add; a convolution is a conv, any other
    counted op a dot."""
    from torch.utils.flop_counter import FlopCounterMode
    with _kernel_counting() as kernels:
        with FlopCounterMode(display=False) as counter:
            with _CallTally(counter) as tally:
                fn()
    dot_flops = conv_flops = dot_count = conv_count = 0
    by_dtype: Dict[str, int] = {}
    ops: Dict[str, int] = {}
    kernel_flops: Dict[str, int] = {}
    for op, flops, dt in tally.calls:
        if _is_conv(op):
            conv_flops += flops
            conv_count += 1
        else:
            dot_flops += flops
            dot_count += 1
        by_dtype[dt] = by_dtype.get(dt, 0) + flops
        ops[op] = ops.get(op, 0) + flops
    for name, flops, dt in kernels:
        dot_flops += flops
        dot_count += 1
        by_dtype[dt] = by_dtype.get(dt, 0) + flops
        ops[name] = ops.get(name, 0) + flops
        kernel_flops[name] = kernel_flops.get(name, 0) + flops
    return {"dot_flops": dot_flops, "conv_flops": conv_flops,
            "total_flops": dot_flops + conv_flops,
            "dot_count": dot_count, "conv_count": conv_count,
            "by_dtype": by_dtype, "kernel_flops": kernel_flops,
            "ops": ops}


def build_cost_model(flops: Dict, *, backend: str,
                     device_kind: str = "", n_devices: int = 1,
                     allreduce_payload_bytes: float = 0.0,
                     wire_dtype: str = "f32",
                     label: str = "") -> Dict:
    """One round's roofline expectation from its FLOP inventory
    (``flop_inventory``'s dict, in place of the reference's lowered
    module text); the record has the reference's keys.

    ``allreduce_payload_bytes`` is the round's aggregation payload at
    its wire dtype (``Config.upload_wire_bytes_per_client``), and
    ``wire_dtype`` tags the record with ``--sketch_dtype``. Returns a
    JSON-able dict the ledger's meta record carries."""
    spec = chip_spec(backend, device_kind)
    exp = expected_round_seconds(flops["total_flops"],
                                 allreduce_payload_bytes, spec,
                                 n_devices)
    return {
        "label": label,
        "chip": spec.name,
        "backend": backend,
        "n_devices": int(n_devices),
        "total_flops": flops["total_flops"],
        "dot_flops": flops["dot_flops"],
        "conv_flops": flops["conv_flops"],
        "flops_by_dtype": flops["by_dtype"],
        "allreduce_payload_bytes": float(allreduce_payload_bytes),
        "wire_dtype": wire_dtype,
        "wire_bytes_per_chip": exp["wire_bytes_per_chip"],
        "compute_floor_s": exp["compute_s"],
        "collective_floor_s": exp["collective_s"],
        "expected_round_s": exp["expected_round_s"],
    }


def utilization(expected_round_s: Optional[float],
                measured_busy_s: Optional[float]) -> Optional[float]:
    """Roofline utilization fraction (1.0 = running at the bound);
    None when either side is missing or zero."""
    if not expected_round_s or not measured_busy_s:
        return None
    return expected_round_s / measured_busy_s

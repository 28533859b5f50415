"""Sketch-table wire quantization (``--sketch_dtype``).

Port of the single-device part of ``commefficient_tpu/ops/quant.py``
(``QMAX`` :41, ``qeff`` :49, ``local_rowmax`` :60, ``_scale`` :67,
``_to_fp8`` :73, ``quantize_local`` :84, ``harmonize`` :98,
``quantize_table`` :119, ``dequantize`` :130), byte for byte:

1. ``quantize_local(table)``: quantize each row against its own maxabs
   at full wire range (int8: +-127, fp8 e4m3fn: +-448). The fused
   kernel ``cet_sketch_quant`` (csrc/sketch.cu) computes the same bytes.
2. ``harmonize(q, rowmax, global_rowmax, n_addends)``: rescale onto the
   shared per-row scale ``global_rowmax / qeff`` (summation headroom
   for a wire-dtype sum of ``n_addends`` shards). With one addend and
   global == local it is the identity: IEEE x/x == 1, and re-rounding
   an integer (or a value fp8 holds) gives it back.
3. ``dequantize(q, scale)`` back to f32, so server state stays f32.

Every function takes one (r, c) table or a (C, r, c) stack of them
(the per-client wire, ``core/rounds.py``): scales are per row along
the last axis, so a stack gives each table's own bytes.

``bf16`` is scale-free: a cast. The reference's collectives
(``wire_psum``, ``global_rowmax_over``) belong to the multi-GPU path.

Rounding: ``torch.round`` (half to even, as ``jnp.round``) and true
division by a *tensor*. PyTorch's CUDA division by a Python scalar
multiplies by its reciprocal, which can differ by one ulp; the plain
version runs on the card too (``chip_smoke.py`` holds the kernel to
it), so every divisor here is a tensor on the operand's device.
"""

from __future__ import annotations

import torch

from commefficient_tpu_torch.accounting import wire_torch_dtype

# full-range maxima of the scaled wire dtypes (fp8 e4m3fn's max is 448)
QMAX = {"int8": 127.0, "fp8": 448.0}


def qeff(wire: str, n_addends: int) -> float:
    """Usable per-addend range under summation headroom: int8 floors
    to an integer step (>= 1); fp8 divides exactly."""
    q = QMAX[wire]
    if wire == "int8":
        return float(max(1, int(q // max(1, n_addends))))
    return q / float(max(1, n_addends))


def local_rowmax(table: torch.Tensor) -> torch.Tensor:
    """Per-row maxabs over the last axis, keepdim (NaN propagates, as
    ``jnp.max``)."""
    return torch.amax(torch.abs(table.to(torch.float32)), dim=-1,
                      keepdim=True)


def _scale(rowmax: torch.Tensor, q: float) -> torch.Tensor:
    """rowmax/q, and exactly 1.0 for an all-zero row (the guard keeps
    0/0 out; a zero row dequantizes to zero either way)."""
    # made on the device (a copy up would stop the host)
    qt = torch.full((), q, dtype=torch.float32, device=rowmax.device)
    one = torch.ones((), dtype=torch.float32, device=rowmax.device)
    return torch.where(rowmax > 0.0, rowmax / qt, one)


def _to_fp8(x: torch.Tensor) -> torch.Tensor:
    """f32 -> fp8 e4m3fn through an explicit f16 step, as the
    reference: a direct convert differs from it in near-tie cases."""
    return x.to(torch.float16).to(wire_torch_dtype("fp8"))


def _round_clip_int8(x: torch.Tensor) -> torch.Tensor:
    qm = QMAX["int8"]
    return torch.clamp(torch.round(x), -qm, qm).to(torch.int8)


def quantize_local(table: torch.Tensor, wire: str):
    """f32 table -> (wire-dtype table, f32 rowmax (..., rows, 1)), full-range
    local quantization. bf16 is a cast with rowmax None."""
    if wire == "bf16":
        return table.to(torch.bfloat16), None
    t = table.to(torch.float32)
    rowmax = local_rowmax(t)
    s = _scale(rowmax, QMAX[wire])
    if wire == "int8":
        return _round_clip_int8(t / s), rowmax
    return _to_fp8(t / s), rowmax


def harmonize(q: torch.Tensor, rowmax, global_rowmax, wire: str,
              n_addends: int):
    """Rescale a locally quantized table onto the shared wire scale:
    ``(q', scale)``, where ``scale`` (f32, per row) dequantizes the sum
    of ``n_addends`` harmonized shards."""
    if wire == "bf16":
        return q, None
    s_local = _scale(rowmax, QMAX[wire])
    s_global = _scale(global_rowmax, qeff(wire, n_addends))
    ratio = s_local / s_global
    x = q.to(torch.float32) * ratio
    if wire == "int8":
        return _round_clip_int8(x), s_global
    return _to_fp8(x), s_global


def quantize_table(table: torch.Tensor, wire: str, n_addends: int = 1,
                   global_rowmax=None):
    """Local quantize + harmonize; without ``global_rowmax`` the local
    rowmax is the global one (one shard)."""
    q, rowmax = quantize_local(table, wire)
    if global_rowmax is None:
        global_rowmax = rowmax
    return harmonize(q, rowmax, global_rowmax, wire, n_addends)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    """Wire-dtype table -> f32; ``scale`` None for bf16/f32."""
    t = q.to(torch.float32)
    if scale is None:
        return t
    return t * scale

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

``bf16`` is scale-free: a cast. On a mesh (parallel/mesh.py), the
collectives ``wire_psum`` (:139) and ``global_rowmax_over`` (:149) sum
a harmonized table over a mesh axis at wire width and agree the shared
scale's row maxima. Their summation is the reference's: XLA's psum of
int8 sums in int8 (exact in any order; ``qeff``'s headroom keeps it
from wrapping), and of bf16 and fp8 sums in f32 and rounds once. A
process group's bf16 sum rounds at every hop and refuses fp8, so those
cross as bytes (``_rounded_once``): a reduce-scatter by
``all_to_all_single`` of the wire-width blocks, the f32 sum in rank
order and one rounding, then an all-gather -- the bytes a ring
all-reduce moves. fp8 sums of up to 8 addends are exact in f32, so they
are bit-equal to XLA's; a bf16 f32 sum may round, in another order, one
ulp apart.

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


def _rounded_once(q: torch.Tensor, axis, scatter: bool = False):
    """The sum over ``axis`` of a bf16 or fp8 tensor, computed in f32 in
    rank order and rounded once to the wire dtype. ``scatter``: ``q`` is
    (axis.size, ...) and this rank keeps the sum of block
    ``axis.index`` (a reduce-scatter); otherwise every rank gets the
    whole sum (an all-reduce). Moves the wire dtype's bytes."""
    n = axis.size
    if axis.group is None:
        return q[0] if scatter else q
    flat = q.contiguous().reshape(-1)
    per = -(-flat.numel() // n)
    if scatter:
        assert q.shape[0] == n and flat.numel() == per * n, q.shape
    pad = per * n - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    got = axis.all_to_all(flat.view(torch.uint8).reshape(n, -1))
    blocks = got.view(q.dtype).reshape(n, per)
    acc = blocks[0].to(torch.float32)
    for j in range(1, n):
        acc = acc + blocks[j].to(torch.float32)
    mine = acc.to(q.dtype)
    if scatter:
        return mine.reshape(q.shape[1:])
    full = axis.all_gather(mine.view(torch.uint8)).view(q.dtype)
    return full.reshape(-1)[:q.numel()].reshape(q.shape)


def wire_sum(q: torch.Tensor, axis, scatter: bool = False) -> torch.Tensor:
    """The sum of a wire-dtype (or f32) tensor over ``axis`` with the
    reference's semantics (module docstring): int8 and f32 through the
    group's own sum, bf16 and fp8 rounded once. ``scatter``: a
    reduce-scatter of the (axis.size, ...) blocks."""
    if q.dtype in (torch.int8, torch.float32):
        if scatter:
            return axis.reduce_scatter(q)
        return axis.psum(q.clone())
    return _rounded_once(q, axis, scatter)


def wire_psum(q: torch.Tensor, scale, axis):
    """The quantized wire crossing (reference ``wire_psum``,
    ops/quant.py:139): the harmonized table summed over ``axis`` at wire
    width; the scale is already the shared one, so only the table
    moves. Returns ``(summed, scale)``."""
    return wire_sum(q, axis), scale


def global_rowmax_over(rowmax: torch.Tensor, axis) -> torch.Tensor:
    """The elementwise max of the local (rows, 1) f32 row maxima over
    ``axis`` (reference ``global_rowmax_over``, :149): the side-channel
    collective that fixes the shared scale, r x 4 bytes. The local
    rowmax is left as it was."""
    return axis.pmax(rowmax.clone())

"""Dtype-aware wire-byte accounting (port of
``commefficient_tpu/accounting.py``).

Uplink: one (r, c) sketch table per participating client at the wire
dtype (``--sketch_dtype``), plus one f32 scale per row for the scaled
dtypes (int8, fp8). Downlink: each changed coordinate ships as one f32
under ``--downlink_encoding dense``; under ``delta`` as its value at
wire width, with an int32 index only where it does not repeat the
previous round's support (runtime/fed_model.py counts both).

Wire dtypes are named by the flag (``f32``/``bf16``/``int8``/``fp8``);
``fp8`` is e4m3fn. Each name maps to the torch dtype of the same name
(``wire_torch_dtype``).
"""

from __future__ import annotations

from typing import Iterable, Union

import numpy as np
import torch

# wire name -> (torch dtype name, bytes per element, carries per-row
# scales)
WIRE_DTYPES = {
    "f32": ("float32", 4, False),
    "bf16": ("bfloat16", 2, False),
    "int8": ("int8", 1, True),
    "fp8": ("float8_e4m3fn", 1, True),
}

# the per-row dequantization scales ride the wire as f32
SCALE_WIRE_BYTES = 4

# numpy has no bfloat16/float8; resolve those by name before asking
# np.dtype for the rest
_NAMED_WIDTHS = {
    "bfloat16": 2,
    "bf16": 2,
    "float8_e4m3fn": 1,
    "float8_e5m2": 1,
    "float8_e4m3": 1,
    "fp8": 1,
    "f32": 4,
    "int8": 1,
}


def dtype_bytes(dtype: Union[str, np.dtype, type]) -> int:
    """Bytes per element of ``dtype``: a wire name, a dtype name, a
    numpy dtype or scalar type."""
    name = getattr(dtype, "name", None) or (
        dtype if isinstance(dtype, str) else None)
    if name is not None and name in _NAMED_WIDTHS:
        return _NAMED_WIDTHS[name]
    if name is not None and name in WIRE_DTYPES:
        return WIRE_DTYPES[name][1]
    return int(np.dtype(dtype).itemsize)


def bytes_of(shape: Union[int, Iterable[int]], dtype) -> float:
    """Wire bytes of an array of ``shape`` and ``dtype`` (float: the
    byte counters are f64 accumulators)."""
    n = int(np.prod([int(s) for s in shape])) \
        if not isinstance(shape, (int, np.integer)) else int(shape)
    return float(n) * float(dtype_bytes(dtype))


def wire_dtype_name(wire: str) -> str:
    """Dtype name of a wire name (validates the wire name)."""
    return WIRE_DTYPES[wire][0]


def wire_torch_dtype(wire: str) -> torch.dtype:
    """torch dtype of a wire name."""
    return getattr(torch, wire_dtype_name(wire))


def wire_has_scales(wire: str) -> bool:
    """True when the wire format carries per-row f32 scales
    (int8/fp8); bf16 and f32 ride scale-free."""
    return WIRE_DTYPES[wire][2]


def sketch_wire_bytes(num_rows: int, num_cols: int,
                      wire: str = "f32") -> float:
    """Uplink bytes of one sketch table: the table at wire width plus,
    for the scaled dtypes, one f32 scale per row."""
    body = bytes_of((num_rows, num_cols), wire_dtype_name(wire))
    if wire_has_scales(wire):
        body += float(num_rows * SCALE_WIRE_BYTES)
    return body


def delta_downlink_bytes(changed: float, repeated: float,
                         prev_support: float, wire: str,
                         have_prev: bool = True) -> float:
    """Downlink bytes for one client under ``--downlink_encoding
    delta``: every changed coordinate ships its value at wire width;
    indices ship as int32 only for coordinates NOT repeated from the
    round the client last saw; repeats are named by a bitmap over the
    previous round's support (1 bit per previous index, byte-padded).
    ``have_prev`` is False when the client missed the previous
    broadcast: then nothing is delta-coded and every changed
    coordinate ships (idx, val)."""
    if not have_prev:
        repeated = 0.0
        prev_support = 0.0
    vals = float(changed) * dtype_bytes(wire)
    idxs = (float(changed) - float(repeated)) * dtype_bytes(np.int32)
    bitmap = float(np.ceil(prev_support / 8.0)) if prev_support else 0.0
    return vals + idxs + bitmap

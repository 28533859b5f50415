"""Wire-byte accounting (port of the parts of
``commefficient_tpu/accounting.py`` that sketch mode uses).

Uplink: one f32 (r, c) table per participating client, ``4·r·c``
bytes. Downlink: each changed coordinate ships as one f32
(runtime/fed_model.py counts the changed coordinates from the
update's support).
"""

from __future__ import annotations

from typing import Iterable, Union

import numpy as np

# bytes per element of the wire dtypes the port ships
_WIDTHS = {"f32": 4}


def dtype_bytes(dtype: str) -> int:
    return _WIDTHS[dtype]


def bytes_of(shape: Union[int, Iterable[int]], dtype: str) -> float:
    """Wire bytes of an array of ``shape`` and ``dtype`` (float: the
    byte counters are f64 accumulators)."""
    n = int(np.prod([int(s) for s in shape])) \
        if not isinstance(shape, (int, np.integer)) else int(shape)
    return float(n) * float(dtype_bytes(dtype))


def sketch_wire_bytes(num_rows: int, num_cols: int) -> float:
    """Uplink bytes of one f32 sketch table."""
    return bytes_of((num_rows, num_cols), "f32")

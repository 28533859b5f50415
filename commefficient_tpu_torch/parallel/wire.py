"""Row chunking of the sketch table's wire crossing
(``--overlap_depth``).

Port of ``row_chunks`` (``commefficient_tpu/parallel/wire.py:53``), the
part of that module one device needs. Its collectives
(``quantize_for_collective``, ``wire_allreduce``, ``wire_reduce_scatter``,
``chunked_quantize_allreduce``) belong to the multi-GPU path.
"""

from __future__ import annotations


def row_chunks(r: int, depth: int):
    """Ceil-split ``r`` table rows into ``min(depth, r)`` contiguous
    chunks, ``[(offset, count), ...]`` in row order. Depth is clamped,
    never an error. Per-row quantization scales make each chunk's
    crossing the row slice of the whole table's, so the folded table is
    the same at any depth."""
    assert r >= 1 and depth >= 1, (r, depth)
    n = min(depth, r)
    size = -(-r // n)
    out = []
    off = 0
    while off < r:
        cnt = min(size, r - off)
        out.append((off, cnt))
        off += cnt
    return out

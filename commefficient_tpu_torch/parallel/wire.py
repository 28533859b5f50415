"""The sketch table's wire crossings over the mesh (``--sketch_dtype``,
``--overlap_depth``).

Port of ``commefficient_tpu/parallel/wire.py``: ``quantize_for_collective``
(:22), ``wire_allreduce`` (:36), ``wire_reduce_scatter`` (:43),
``row_chunks`` (:53) and ``chunked_quantize_allreduce`` (:75), which
here serves both meshes' emission (1-D and, with ``scatter``, 2-D).
``ops/quant.py`` owns the algebra (scales, headroom, rounding, the
summation of each wire dtype); this module owns where it meets the
mesh's axes (parallel/mesh.py ``Axis``). A one-device round uses
``row_chunks`` alone.
"""

from __future__ import annotations

import torch

from commefficient_tpu_torch.ops import quant


def harmonize_over(q: torch.Tensor, rowmax, wire: str, axis,
                   n_addends: int):
    """A locally quantized table (and its rowmax) -> ``(wire-dtype
    table, shared scale)``: the row maxima max-combined over ``axis``,
    then harmonized with ``n_addends`` summation headroom. bf16 is
    scale-free (rowmax and scale None)."""
    grm = (quant.global_rowmax_over(rowmax, axis)
           if rowmax is not None else None)
    return quant.harmonize(q, rowmax, grm, wire, n_addends)


def quantize_for_collective(table: torch.Tensor, wire: str, axis,
                            n_addends: int):
    """Local f32 table -> ``(wire-dtype table, shared scale)`` ready for
    a wire-dtype sum over the mesh: quantize at full range per row,
    then ``harmonize_over`` ``axis`` (the participating ranks). The
    reference's API, which the tests hold; the round crosses through
    ``chunked_quantize_allreduce``."""
    q, rowmax = quant.quantize_local(table, wire)
    return harmonize_over(q, rowmax, wire, axis, n_addends)


def wire_allreduce(q: torch.Tensor, scale, axis) -> torch.Tensor:
    """The table's aggregation all-reduce at wire width, dequantized on
    the far side: the server only ever sees f32."""
    return quant.dequantize(*quant.wire_psum(q, scale, axis))


def _column_blocks(table: torch.Tensor, n: int) -> torch.Tensor:
    """(r, c) -> (n, r, c/n): block j the column shard j, so a
    collective along dim 0 moves column shards."""
    r, c = table.shape
    return table.reshape(r, n, c // n).permute(1, 0, 2).contiguous()


def wire_reduce_scatter(q: torch.Tensor, axis) -> torch.Tensor:
    """The 2-D emission's model-axis crossing: the peers' partial
    (r, c) tables summed, each peer keeping its (r, c/M) column shard,
    at wire width where ``q`` is quantized (r·c·wb/M a link instead of
    4·r·c/M)."""
    return quant.wire_sum(_column_blocks(q, axis.size), axis, scatter=True)


def gather_columns(shard: torch.Tensor, axis) -> torch.Tensor:
    """The (r, c) table from the model peers' (r, c/M) column shards:
    one all-gather (along dim 0, so the (M, r, c/M) blocks are laid
    back side by side)."""
    blocks = axis.all_gather(shard)
    m, r, cl = blocks.shape
    return blocks.permute(1, 0, 2).reshape(r, m * cl)


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


def local_rows(table: torch.Tensor, wire: str):
    """``chunked_quantize_allreduce``'s producer for an f32 table in
    hand: each row chunk as it is at f32, else quantized at full range
    per row (``quant.quantize_local``)."""
    def produce(rows):
        off, cnt = rows
        chunk = table[off:off + cnt]
        if wire == "f32":
            return chunk.clone()
        return quant.quantize_local(chunk, wire)
    return produce


def chunked_quantize_allreduce(produce, r: int, wire: str, axis,
                               n_addends: int, depth: int, scatter=None,
                               over=None) -> torch.Tensor:
    """The round's row-chunked crossing of an (r, c) table:
    ``produce((offset, count))`` emits each disjoint row chunk (f32 rows,
    or at a wire dtype the locally quantized ``(q, rowmax)``: kernel 4's
    sketch-and-quantize, or ``local_rows``), which is summed on its own
    over ``axis``, in emission order, so chunk i's collective can run
    under chunk i+1's production. With ``scatter`` (the 2-D emission's
    ``model`` axis) the chunk is reduce-scattered over it first, each
    peer keeping its column shard. The row maxima are max-combined over
    ``over`` (default ``axis``: every rank that sums the chunk) with
    ``n_addends`` headroom. Per-row scales make the folded table the
    whole-table crossing's, bit for bit."""
    from commefficient_tpu_torch.core.server import fold_row_chunks
    parts = []
    for rows in row_chunks(r, depth):
        if wire == "f32":
            part = produce(rows)
            if scatter is not None:
                part = wire_reduce_scatter(part, scatter)
            parts.append(axis.psum(part))
            continue
        q, rowmax = produce(rows)
        q, scale = harmonize_over(q, rowmax, wire,
                                  axis if over is None else over, n_addends)
        if scatter is not None:
            q = wire_reduce_scatter(q, scatter)
        parts.append(wire_allreduce(q, scale, axis))
    return fold_row_chunks(parts)

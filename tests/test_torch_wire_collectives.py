"""The wire's collectives over the port's mesh, against the JAX package's
on its 8-device CPU mesh.

The port's ranks are gloo processes (``parallel/mesh.py launch``), the
JAX side ``shard_map`` over ``jax.devices()[:n]``, both fed the same
numpy tables (one a rank, rows of different scales).

- **The sum of each wire dtype** (``quant.wire_psum``), on the tables
  the port harmonized: int8 and fp8 bit-equal to XLA's ``psum`` of the
  same bytes (int8 sums exactly; fp8 sums of up to 8 addends are exact
  in f32 and rounded once, as XLA does), bf16 within one bf16 ulp of it
  (the f32 sum of bf16 values may round, and the two sum in other
  orders), f32 within what another summation order can move it:
  n·eps(f32) of the sum of the addends' magnitudes an element.
- **The whole crossing** (quantize, the rowmax max, harmonize, sum,
  dequantize: ``chunked_quantize_allreduce``) against JAX
  ``parallel.wire.chunked_quantize_allreduce``: within one step of the
  shared scale a value (XLA may compute the scale's ``rowmax / qmax``
  as a product with the reciprocal, one ulp apart, which can move a
  value near a rounding boundary one step), bf16 one ulp.
- **--overlap_depth**: the quantized crossings in 2 and 3 row chunks
  bit-equal to the whole table's (f32 within the order bound: the
  group's sum orders a buffer by its size).
- **The 2-D emission's reduce-scatter** over ``model`` (``1x2`` and
  ``2x2``), on the tables the port harmonized over the world: bit-equal to XLA's
  ``psum_scatter`` (tiled along the columns) for int8 and fp8, bf16
  within one ulp, f32 within the summation-order bound; and the (r, 1)
  rowmax max.
- **The 2-D emission's whole crossing** (``chunked_quantize_allreduce``
  with ``scatter``: quantize with C·M headroom over the world, the
  reduce-scatter over ``model``, the all-reduce over ``clients``)
  against the JAX package's ``quantize_for_collective`` +
  ``wire_reduce_scatter`` + ``wire_allreduce`` under ``shard_map``, with
  the whole crossing's tolerances; in 2 row chunks bit-equal to the
  whole (f32 within the order bound).
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_workers as workers
from commefficient_tpu.parallel import wire as jwire
from commefficient_tpu.parallel.mesh import (CLIENT_AXIS, MODEL_AXIS,
                                             make_mesh, make_mesh2d,
                                             replicated_spec, shard_map,
                                             spec)
from commefficient_tpu_torch.parallel.mesh import launch

R, COLS = 5, 96
WIRES = ["f32", "bf16", "int8", "fp8"]


def _tables(n, seed=0):
    rng = np.random.RandomState(seed)
    scale = np.array([1.0, 1e-3, 50.0, 0.2, 7.0], np.float32)[:, None]
    return [(rng.randn(R, COLS) * scale).astype(np.float32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def crossings():
    """Every crossing at C = 2 and 4 (1-D) and on the 1x2 and 2x2
    meshes: one launch each."""
    out = {}
    for key, world, shape in (((2, 1), 2, None), ((4, 1), 4, None),
                              ((1, 2), 2, "1x2"), ((2, 2), 4, "2x2")):
        tables = _tables(world, seed=world)
        out[key] = (tables, launch(world, workers.wire_crossings, tables,
                                   shape, device_type="cpu"))
    return out


def _wire_view(arr, wire):
    """The port's raw wire bytes as the JAX wire dtype."""
    if wire == "bf16":
        return jnp.asarray(arr.view(jnp.bfloat16))
    if wire == "fp8":
        return jnp.asarray(arr.view(jnp.float8_e4m3fn))
    return jnp.asarray(arr)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_ulp(x):
    """One bf16 ulp at each value (its 8-bit significand)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _jax_psum(stack, c):
    mesh = make_mesh(jax.devices()[:c])
    return shard_map(lambda t: jax.lax.psum(t[0], CLIENT_AXIS), mesh=mesh,
                     in_specs=(spec(CLIENT_AXIS),),
                     out_specs=replicated_spec())(stack)


def _order_bound(addends):
    """What summing ``addends`` in another order can move an f32 sum:
    n·eps(f32) times the sum of their magnitudes, elementwise."""
    a = np.abs(np.stack(addends)).astype(np.float64)
    return len(addends) * np.finfo(np.float32).eps * a.sum(0)


def _same_sum(got, want, wire, addends=None):
    if wire in ("int8", "fp8"):
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    elif wire == "bf16":
        g, w = _f32(got), _f32(want)
        assert np.all(np.abs(g - w) <= _bf16_ulp(w))
    else:
        assert np.all(np.abs(np.asarray(got) - np.asarray(want))
                      <= _order_bound(addends))


@pytest.mark.parametrize("wire", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("c", [2, 4])
def test_wire_sum_is_xla_psum(crossings, c, wire):
    """The port's ``wire_psum`` of the harmonized tables against XLA's
    ``psum`` of the same wire bytes."""
    _, outs = crossings[(c, 1)]
    stack = jnp.stack([_wire_view(o[("harmonized", wire)], wire)
                       for o in outs])
    want = _jax_psum(stack, c)
    for o in outs:
        _same_sum(_wire_view(o[("wire_sum", wire)], wire), want, wire)


@pytest.mark.parametrize("c", [2, 4])
def test_f32_allreduce_is_xla_psum(crossings, c):
    tables, outs = crossings[(c, 1)]
    want = np.asarray(_jax_psum(jnp.asarray(np.stack(tables)), c))
    for o in outs:
        _same_sum(o[("allreduce", "f32", 1)], want, "f32", tables)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("c", [2, 4])
def test_crossing_matches_jax(crossings, c, wire):
    """The whole crossing against JAX's quantize_for_collective +
    wire_allreduce under shard_map, from the f32 tables."""
    tables, outs = crossings[(c, 1)]
    mesh = make_mesh(jax.devices()[:c])

    def block(t):
        return jwire.chunked_quantize_allreduce(t[0], wire, (CLIENT_AXIS,),
                                                c, CLIENT_AXIS, 1)

    want = np.asarray(shard_map(block, mesh=mesh,
                                in_specs=(spec(CLIENT_AXIS),),
                                out_specs=replicated_spec())(
        jnp.asarray(np.stack(tables))))
    for o in outs:
        got = o[("allreduce", wire, 1)]
        if wire == "f32":
            _same_sum(got, want, "f32", tables)
            continue
        if wire == "bf16":
            assert np.all(np.abs(got - want) <= _bf16_ulp(want))
            continue
        # the shared scale, per row: one wire step
        rowmax = np.max(np.abs(np.stack(tables)), axis=(0, 2))[:, None]
        qeff = (max(1, 127 // c) if wire == "int8" else 448.0 / c)
        step = rowmax / qeff
        assert np.all(np.abs(got - want) <= step * (1 + 1e-6)), wire
        assert np.mean(got == want) > 0.99


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("c", [2, 4])
def test_overlap_chunks_equal_the_whole(crossings, c, wire):
    """Row chunks of --overlap_depth 2 and 3: the quantized crossings bit
    for bit the whole table's (per-row scales; int8 sums exactly, bf16
    and fp8 in rank order); f32 within the summation-order bound, as the
    group's own sum orders a chunk by its size."""
    tables, outs = crossings[(c, 1)]
    for o in outs:
        whole = o[("allreduce", wire, 1)]
        for depth in (2, 3):
            got = o[("allreduce", wire, depth)]
            if wire == "f32":
                _same_sum(got, whole, "f32", tables)
            else:
                assert got.tobytes() == whole.tobytes()


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_reduce_scatter_matches_xla_psum_scatter(crossings, shape, wire):
    """The 2-D emission's model-axis crossing against XLA's tiled
    ``psum_scatter`` of the same (world-harmonized) tables; rank
    c·M + m keeps column shard m of its client row's sum."""
    c, m = shape
    tables, outs = crossings[shape]
    mesh = make_mesh2d(c, m, jax.devices()[:c * m])
    axes = (CLIENT_AXIS, MODEL_AXIS)
    if wire == "f32":
        stack = jnp.asarray(np.stack(tables))
    else:
        # the tables as the port harmonized them over the world (C·M
        # headroom), summed by both
        stack = jnp.stack([_wire_view(o[("harmonized_world", wire)], wire)
                           for o in outs])

    def scatter(q):
        return jwire.wire_reduce_scatter(q[0], MODEL_AXIS)[None]

    want = np.asarray(shard_map(scatter, mesh=mesh, in_specs=(spec(axes),),
                                out_specs=spec(axes))(stack))
    cl = COLS // m
    for r, o in enumerate(outs):
        got = _wire_view(o[("scatter", wire)], wire)
        assert got.shape == (R, cl)
        row = r // m
        shard = [t[:, (r % m) * cl:(r % m + 1) * cl]
                 for t in tables[row * m:(row + 1) * m]]
        _same_sum(got, want[r], wire, shard)
    # the (r, 1) rowmax max over every rank
    rowmax = np.max(np.abs(np.stack(tables)), axis=(0, 2))[:, None]
    for o in outs:
        np.testing.assert_array_equal(o[("rowmax",)], rowmax)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_2d_emission_crossing_matches_jax(crossings, shape, wire):
    """The 2-D emission's crossing of the round (rank c·M + m ends with
    column shard m of the whole world's sum) against the reference's
    quantize, model-axis reduce-scatter and client-axis all-reduce."""
    c, m = shape
    tables, outs = crossings[shape]
    mesh = make_mesh2d(c, m, jax.devices()[:c * m])
    axes = (CLIENT_AXIS, MODEL_AXIS)

    def emit(t):
        if wire == "f32":
            shard = jax.lax.psum_scatter(t[0], MODEL_AXIS,
                                         scatter_dimension=1, tiled=True)
            return jax.lax.psum(shard, CLIENT_AXIS)[None]
        q, scale = jwire.quantize_for_collective(t[0], wire, axes, c * m)
        shard = jwire.wire_reduce_scatter(q, MODEL_AXIS)
        return jwire.wire_allreduce(shard, scale, CLIENT_AXIS)[None]

    want = np.asarray(shard_map(emit, mesh=mesh, in_specs=(spec(axes),),
                                out_specs=spec(axes))(
        jnp.asarray(np.stack(tables))))
    cl = COLS // m
    rowmax = np.max(np.abs(np.stack(tables)), axis=(0, 2))[:, None]
    for r, o in enumerate(outs):
        got = o[("emit2d", wire, 1)]
        assert got.shape == (R, cl)
        shard = [t[:, (r % m) * cl:(r % m + 1) * cl] for t in tables]
        if wire == "f32":
            _same_sum(got, want[r], "f32", shard)
            _same_sum(o[("emit2d", wire, 2)], got, "f32", shard)
            continue
        assert o[("emit2d", wire, 2)].tobytes() == got.tobytes()
        if wire == "bf16":
            assert np.all(np.abs(got - want[r]) <= _bf16_ulp(want[r]))
            continue
        qeff = (max(1, 127 // (c * m)) if wire == "int8"
                else 448.0 / (c * m))
        assert np.all(np.abs(got - want[r]) <= rowmax / qeff * (1 + 1e-6))
        assert np.mean(got == want[r]) > 0.99

"""The quantized sketch wire (``--sketch_dtype``), op by op, against the
JAX package on the CPU, byte for byte:

- the port's ``ops/quant.py`` against ``commefficient_tpu.ops.quant``
  (int8, fp8, bf16; one, two and eight addends with a shared rowmax
  above the local one; the zero row, the ``qeff`` schedule, NaN in the
  row max);
- the fused emit + quantize (``sketch_quant_plain``, the plain version
  of the ``cet_sketch_quant`` kernel, and ``CountSketch.
  sketch_quantized``) against the reference's ``sketch_quantized`` on
  its Pallas kernel in interpret mode, whole and per row chunk;
- the checks' strength: a quantizer that rounds half away from zero,
  or converts f32 to fp8 without the f16 step, fails them.

Tolerance: none. Both sides add the chunks in the same order, so the
f32 tables are bit-equal, and the quantizers round the same way.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from commefficient_tpu import accounting as jax_accounting
from commefficient_tpu.ops import quant as jq
from commefficient_tpu.ops.sketch import CountSketch as JaxCountSketch
from commefficient_tpu.parallel.wire import row_chunks as jax_row_chunks
from commefficient_tpu_torch import accounting
from commefficient_tpu_torch.ops import quant
from commefficient_tpu_torch.ops import sketch_kernels as sk
from commefficient_tpu_torch.ops.sketch import CountSketch
from commefficient_tpu_torch.parallel.wire import row_chunks

SCALED = ["int8", "fp8"]
WIRES = ["bf16", "int8", "fp8"]


def rand_table(r=4, c=64, seed=0):
    """Rows at very different magnitudes and one all-zero row (the 0/0
    guard), as the reference's tests/test_quant.py."""
    rng = np.random.RandomState(seed)
    t = rng.randn(r, c).astype(np.float32)
    t *= np.power(10.0, rng.randint(-3, 4, (r, 1))).astype(np.float32)
    t[1] = 0.0
    return t


def tie_table():
    """Rows whose scale is exactly 1 (rowmax = qmax), holding int8
    rounding ties and fp8 values whose f32 -> f16 -> e4m3 rounding
    differs from a direct f32 -> e4m3 convert."""
    t = np.zeros((2, 16), np.float32)
    t[0, :8] = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, 126.5]
    # 1 + 1/16 is an e4m3 tie; 2^-13 above it rounds down to the tie in
    # f16, then to 1.0 (even) in e4m3, where a direct convert gives 1.125
    t[1, :4] = [448.0, 1.0625 + 2.0**-13, -(1.0625 + 2.0**-13),
                2.125 + 2.0**-12]
    return t


def raw(x) -> bytes:
    """Raw bytes of a torch tensor, a jax array or a numpy array."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            x = x.view(torch.uint8 if x.element_size() == 1 else torch.int16)
        return x.contiguous().numpy().tobytes()
    return np.asarray(x).tobytes()


def same_as_jax(quantize_table, t, wire, n_addends=1, global_rowmax=None):
    """True when ``quantize_table`` (the port's signature) gives the JAX
    package's bytes for q and the scale on table ``t``."""
    g = None if global_rowmax is None else jnp.asarray(global_rowmax)
    qj, sj = jq.quantize_table(jnp.asarray(t), wire, n_addends=n_addends,
                               global_rowmax=g)
    gt = None if global_rowmax is None else torch.from_numpy(global_rowmax)
    qt, st = quantize_table(torch.from_numpy(t), wire, n_addends=n_addends,
                            global_rowmax=gt)
    if raw(qt) != raw(qj):
        return False
    if sj is None or st is None:
        return sj is None and st is None
    return raw(st) == raw(sj)


@pytest.mark.parametrize("table", ["random", "ties"])
@pytest.mark.parametrize("n_addends", [1, 2, 8])
@pytest.mark.parametrize("wire", WIRES)
def test_quantize_table_matches_jax_bytes(wire, n_addends, table):
    t = rand_table(seed=6) if table == "random" else tie_table()
    # a shared rowmax above the local one: the ratio < 1 harmonize of
    # a multi-shard wire
    g = (None if n_addends == 1 else
         np.max(np.abs(t), axis=-1, keepdims=True) * np.float32(2.0))
    assert same_as_jax(quant.quantize_table, t, wire, n_addends, g)
    q, s = quant.quantize_table(torch.from_numpy(t), wire,
                                n_addends=n_addends,
                                global_rowmax=None if g is None
                                else torch.from_numpy(g))
    qj, sj = jq.quantize_table(jnp.asarray(t), wire, n_addends=n_addends,
                               global_rowmax=None if g is None
                               else jnp.asarray(g))
    assert raw(quant.dequantize(q, s)) == raw(jq.dequantize(qj, sj))


@pytest.mark.parametrize("wire", SCALED)
def test_quantize_local_and_harmonize_identity(wire):
    """quantize_local's bytes and rowmax as the reference's; harmonize at
    one addend with global == local gives q back, byte for byte."""
    t = rand_table(seed=3)
    q, rm = quant.quantize_local(torch.from_numpy(t), wire)
    qj, rmj = jq.quantize_local(jnp.asarray(t), wire)
    assert raw(q) == raw(qj) and raw(rm) == raw(rmj)
    qq, s = quant.harmonize(q, rm, rm, wire, 1)
    assert raw(qq) == raw(q)
    assert raw(s) == raw(jq._scale(rmj, jq.qeff(wire, 1)))


@pytest.mark.parametrize("wire", SCALED)
def test_zero_row_guard(wire):
    """An all-zero row quantizes to zeros under a scale of exactly 1."""
    q, s = quant.quantize_table(torch.from_numpy(rand_table()), wire)
    assert bool((q[1].to(torch.float32) == 0).all())
    assert float(s[1, 0]) == 1.0
    assert bool((quant.dequantize(q, s)[1] == 0).all())


def test_qeff_schedule_and_tables():
    assert quant.QMAX == jq.QMAX
    assert quant.qeff("int8", 1) == 127.0
    assert quant.qeff("int8", 2) == 63.0
    assert quant.qeff("int8", 8) == 15.0
    assert quant.qeff("int8", 500) == 1.0
    assert quant.qeff("fp8", 7) == 448.0 / 7.0
    for wire in SCALED:
        for n in (1, 2, 7, 8, 127, 500):
            assert quant.qeff(wire, n) == jq.qeff(wire, n)
    for wire, (name, width, scales) in jax_accounting.WIRE_DTYPES.items():
        assert accounting.WIRE_DTYPES[wire] == (name, width, scales)
        assert accounting.wire_torch_dtype(wire).itemsize == width
        for r, c in ((5, 524_288), (3, 100)):
            assert accounting.sketch_wire_bytes(r, c, wire) == \
                jax_accounting.sketch_wire_bytes(r, c, wire)
    f = accounting.delta_downlink_bytes
    jf = jax_accounting.delta_downlink_bytes
    for args in ((10, 4, 9, "int8"), (10, 4, 9, "f32"), (0, 0, 0, "fp8"),
                 (7, 3, 20, "bf16")):
        assert f(*args) == jf(*args)
        assert f(*args, have_prev=False) == jf(*args, have_prev=False)


def test_rowmax_propagates_nan():
    t = rand_table(seed=2)
    t[2, 5] = np.nan
    rm = quant.local_rowmax(torch.from_numpy(t))
    rmj = np.asarray(jq.local_rowmax(jnp.asarray(t)))
    assert np.isnan(rm[2, 0].item()) and np.isnan(rmj[2, 0])
    np.testing.assert_array_equal(np.delete(rm.numpy(), 2, 0),
                                  np.delete(rmj, 2, 0))


def test_fp8_through_explicit_f16():
    """Inside the wire range, which x/s never leaves. (Beyond 448 the
    converters part: torch takes values below 480 to 448, ml_dtypes
    gives NaN, the kernel saturates.)"""
    rng = np.random.RandomState(5)
    x = np.concatenate([
        np.clip(rng.randn(512).astype(np.float32) * 448.0, -448.0, 448.0),
        rng.randn(512).astype(np.float32) * 2.0**-9,
        np.float32([448.0, -448.0, 0.0, -0.0, 2.0**-9, 2.0**-10]),
    ])
    want = x.astype(np.float16).astype(ml_dtypes.float8_e4m3fn)
    got = quant._to_fp8(torch.from_numpy(x))
    assert raw(got) == want.tobytes()
    assert raw(got) == raw(jq._to_fp8(jnp.asarray(x), "fp8"))


# --- the fused emit + quantize against the reference's Pallas kernel ---

def _fused_cases():
    for d, c, r in ((5000, 1024, 3), (300, 128, 5), (3000, 256, 5)):
        for wire in WIRES:
            yield d, c, r, wire


@pytest.mark.parametrize("d,c,r,wire", list(_fused_cases()))
def test_sketch_quantized_matches_jax_pallas(d, c, r, wire):
    """Whole table, then every row chunk of depths 2 and 4: the port's
    f32 table is bit-equal to the reference's Pallas table, and the
    quantized bytes and rowmax are equal, through both
    ``CountSketch.sketch_quantized`` and the plain version of the
    kernel (``sketch_quant_plain``, row slice of the rotations and
    ``row_offset``)."""
    v = np.random.RandomState(d).randn(d).astype(np.float32)
    js = JaxCountSketch(d=d, c=c, r=r, seed=7, backend="pallas_interpret")
    ts = CountSketch(d=d, c=c, r=r, seed=7)
    vt = torch.from_numpy(v)
    vp = torch.nn.functional.pad(vt, (0, ts._padded_d - d))
    rot = ts.rotations_on("cpu")
    args = (ts.c, ts.sign_seed, ts._one_mix_signs)
    assert raw(ts.sketch(vt)) == raw(js.sketch(jnp.asarray(v)))
    assert row_chunks(r, 2) == jax_row_chunks(r, 2)
    assert row_chunks(r, 4) == jax_row_chunks(r, 4)
    cases = [None] + row_chunks(r, 2) + row_chunks(r, 4)
    for rows in cases:
        off, cnt = rows if rows is not None else (0, r)
        qj, rmj = js.sketch_quantized(jnp.asarray(v), wire, rows=rows)
        qt, rmt = ts.sketch_quantized(vt, wire, rows=rows)
        assert raw(qt) == raw(qj), (wire, rows)
        if wire == "bf16":
            assert rmt is None and rmj is None
            continue
        assert raw(rmt) == raw(rmj), (wire, rows)
        qp, rmp = sk.sketch_quant_plain(vp, rot[off:off + cnt], args[0],
                                        cnt, args[1], args[2], wire,
                                        row_offset=off)
        assert raw(qp) == raw(qj) and raw(rmp) == raw(rmj), (wire, rows)
        # the CPU wrapper takes the plain version and launches nothing
        before = sk.sketch_quant_kernel.launches
        qw, _ = sk.sketch_quant_kernel(vp, rot[off:off + cnt], args[0], cnt,
                                       args[1], args[2], wire, off)
        assert raw(qw) == raw(qj)
        assert sk.sketch_quant_kernel.launches == before


def test_sketch_quant_refuses_bad_rows_and_wire():
    s = CountSketch(d=500, c=64, r=5, seed=1)
    vp = torch.zeros(s._padded_d)
    rot = s.rotations_on("cpu")
    with pytest.raises(ValueError, match="out of range"):
        sk.sketch_quant_kernel(vp, rot, 64, 5, s.sign_seed, True, "int8",
                               row_offset=12)
    with pytest.raises(ValueError, match="int8 or fp8"):
        sk.sketch_quant_kernel(vp, rot, 64, 5, s.sign_seed, True, "bf16")


# --- the checks reject wrong rounding ---------------------------------

def _half_away_int8(table, wire, n_addends=1, global_rowmax=None):
    """int8 quantize_table whose rounding is half away from zero."""
    t = table.to(torch.float32)
    rm = quant.local_rowmax(t)
    s = quant._scale(rm, quant.QMAX["int8"])
    x = t / s
    q = torch.clamp(torch.sign(x) * torch.floor(torch.abs(x) + 0.5),
                    -127, 127).to(torch.int8)
    return q, s


def _direct_fp8(table, wire, n_addends=1, global_rowmax=None):
    """fp8 quantize_table that converts f32 -> e4m3fn without the f16
    step."""
    t = table.to(torch.float32)
    rm = quant.local_rowmax(t)
    s = quant._scale(rm, quant.QMAX["fp8"])
    return (t / s).to(torch.float8_e4m3fn), s


@pytest.mark.parametrize("wire,mutant", [("int8", _half_away_int8),
                                         ("fp8", _direct_fp8)])
def test_byte_checks_reject_mutant_quantizers(wire, mutant):
    t = tie_table()
    assert same_as_jax(quant.quantize_table, t, wire)
    assert not same_as_jax(mutant, t, wire)


# --- chip_smoke.py's byte checks of the fused kernel reject slips ---------


@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("slip", [
    "none", "a q byte off by one in the last partial column tile",
    "a row's sign dropped in a row_offset chunk"])
def test_card_smoke_sketch_quant_checks_reject_slips(monkeypatch, slip,
                                                      wire):
    # chip_smoke.py holds the fused sketch-and-quantize byte-equal to its
    # plain version, to quantizing the sketch kernel's table and per row
    # chunk, hashed and through the sign stream. Here the kernel's output
    # is the plain one with one slip, and the check must raise. c = 1500
    # leaves the last 1024-column tile of the all-rows core partial
    import chip_smoke as cs
    d, c, r = 5_000, 1_500, 5
    s = CountSketch(d=d, c=c, r=r, seed=7)
    v = torch.from_numpy(np.random.RandomState(2).randn(d).astype(np.float32))
    vp = torch.nn.functional.pad(v, (0, s._padded_d - d))
    rot = s.rotations_on("cpu")
    plain = sk.sketch_quant_plain

    def slipped(vp, rot, c, r, seed, one_mix, wire, row_offset=0,
                signs=None):
        if slip == "a row's sign dropped in a row_offset chunk" \
                and row_offset > 0:
            tab = sk.sketch_plain(vp, rot, c, r, seed, one_mix, row_offset,
                                  signs)
            cols = torch.arange(c)
            tab[0] = sum(vp[t * c + (cols - int(rot[0, t])) % c]
                         for t in range(rot.shape[1]))
            return quant.quantize_local(tab, wire)
        q, rm = plain(vp, rot, c, r, seed, one_mix, wire, row_offset, signs)
        if slip == "a q byte off by one in the last partial column tile":
            q = q.clone()
            q.view(torch.uint8)[0, 1024 + 5] += 1
        return q, rm

    monkeypatch.setattr(sk, "sketch_quant_kernel", slipped)
    args = (vp, rot, c, r, s.sign_seed, s._one_mix_signs, wire, slip,
            s.packed_signs_on("cpu"))
    if slip == "none":
        err, route = cs.sketch_quant_checks(*args)
        assert (err, route) == (0.0, "plain")
    else:
        with pytest.raises(AssertionError):
            cs.sketch_quant_checks(*args)


def test_sketch_quantized_reads_the_sign_stream(monkeypatch):
    # the fused path gets the packed-sign stream, as the bf16 path and
    # the f32 sketch do
    s = CountSketch(d=3000, c=256, r=5, seed=3)
    seen = []

    def spy(*args, **kw):
        seen.append(kw.get("signs"))
        return real(*args, **kw)

    real = sk.sketch_quant_kernel
    monkeypatch.setattr(sk, "sketch_quant_kernel", spy)
    v = torch.from_numpy(np.random.RandomState(0).randn(3000)
                         .astype(np.float32))
    for rows in (None, (0, 3), (3, 2)):
        s.sketch_quantized(v, "int8", rows=rows)
    assert len(seen) == 3
    assert all(x is s.packed_signs_on("cpu") for x in seen)

"""The port's count sketch against the JAX package's, on the CPU.

Inputs come from seeded numpy and go through both packages. The JAX
side runs as its own tests run it: ``backend="xla"`` and
``backend="pallas_interpret"``; the port runs its plain versions
(CPU tensors).

Tolerances:
- hashes (mix, rotations, buckets, signs): bit-exact -- integer math;
- sketch tables: |diff| <= 1e-5 * max|table| + 1e-6 * max|v| -- the
  same sums taken in another order (the port adds chunks in index
  order; XLA stacks and reduces);
- estimates from one given table: bit-exact -- the sign flip is exact
  and the median is an order statistic (or the mean of two).
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops.sketch import CountSketch as JaxSketch
from commefficient_tpu.ops.sketch import _mix as jax_mix
from commefficient_tpu.ops.sketch import _np_mix as jax_np_mix
from commefficient_tpu_torch.ops.sketch import CountSketch, _mix, _np_mix


def _table_tol(table, v):
    return 1e-5 * np.abs(table).max() + 1e-6 * np.abs(v).max()


def test_mix_bit_exact_including_high_values():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 2**32, size=20000, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 2**31, 2**32 - 1, 2**31 - 1]
    assert (x >= 2**31).sum() > 1000
    want = np.asarray(jax_mix(jnp.asarray(x)))
    np.testing.assert_array_equal(jax_np_mix(x), want)
    np.testing.assert_array_equal(_np_mix(x), want)
    got = _mix(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("rot_lanes", [0, 128])
def test_rotations_bit_exact(rot_lanes):
    kw = dict(d=300_000, c=4096, r=5, seed=11, rot_lanes=rot_lanes)
    want = JaxSketch(backend="xla", **kw)._rotations()
    got = CountSketch(**kw)._rotations()
    np.testing.assert_array_equal(got, want)
    if rot_lanes:
        assert (got % rot_lanes == 0).all()


@pytest.mark.parametrize("r", [5, 17])
def test_hashes_and_sign_rows_bit_exact(r):
    kw = dict(d=20_000, c=1000, r=r, seed=3)
    js, ts = JaxSketch(backend="xla", **kw), CountSketch(**kw)
    idx = np.random.RandomState(r).randint(0, 20_000, 500).astype(np.int32)
    jb, jsg = js.hashes(jnp.asarray(idx))
    tb, tsg = ts.hashes(torch.from_numpy(idx))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tsg.numpy(), np.asarray(jsg))
    for row in (0, r - 1):
        np.testing.assert_array_equal(ts._signs_row(row).numpy(),
                                      np.asarray(js._signs_row(row)))


@pytest.mark.parametrize("d,c,r", [(6_345, 1000, 5), (2000, 512, 17),
                                   (4000, 500, 3), (700, 64, 1),
                                   (20_000, 8192, 4)])
def test_sketch_table_within_tolerance(d, c, r):
    v = np.random.RandomState(d).randn(d).astype(np.float32)
    want = np.asarray(JaxSketch(d=d, c=c, r=r, seed=7,
                                backend="xla").sketch(jnp.asarray(v)))
    got = CountSketch(d=d, c=c, r=r, seed=7).sketch(
        torch.from_numpy(v)).numpy()
    assert np.abs(got - want).max() <= _table_tol(want, v)


def test_sketch_linear():
    s = CountSketch(d=9000, c=700, r=5, seed=1)
    rng = np.random.RandomState(5)
    a, b = (torch.from_numpy(rng.randn(9000).astype(np.float32))
            for _ in range(2))
    lhs = s.sketch(2.0 * a + b).numpy()
    rhs = (2.0 * s.sketch(a) + s.sketch(b)).numpy()
    assert np.abs(lhs - rhs).max() <= 1e-5 * np.abs(lhs).max()


def test_sketch_matches_pallas_interpret_lane_aligned():
    kw = dict(d=5000, c=1024, r=5, seed=9)
    v = np.random.RandomState(2).randn(5000).astype(np.float32)
    want = np.asarray(JaxSketch(backend="pallas_interpret", **kw)
                      .sketch(jnp.asarray(v)))
    got = CountSketch(**kw).sketch(torch.from_numpy(v)).numpy()
    assert np.abs(got - want).max() <= _table_tol(want, v)
    # recovery from the same table agrees with the Pallas kernel too
    est_want = np.asarray(JaxSketch(backend="pallas_interpret", **kw)
                          .estimates(jnp.asarray(want)))
    est_got = CountSketch(**kw).estimates(
        torch.from_numpy(want.copy())).numpy()
    np.testing.assert_array_equal(est_got, est_want)


@pytest.mark.parametrize("r", [1, 3, 4, 5, 17])
@pytest.mark.parametrize("padded", [False, True])
def test_estimates_bit_exact_from_same_table(r, padded):
    d, c = 10_007, 4096
    table = np.random.RandomState(r).randn(r, c).astype(np.float32)
    want = np.asarray(JaxSketch(d=d, c=c, r=r, seed=4, backend="xla")
                      .estimates(jnp.asarray(table), padded=padded))
    got = CountSketch(d=d, c=c, r=r, seed=4).estimates(
        torch.from_numpy(table), padded=padded).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r", [4, 5])
def test_l2estimate(r):
    table = np.random.RandomState(r).randn(r, 300).astype(np.float32)
    want = float(JaxSketch.l2estimate(jnp.asarray(table)))
    got = float(CountSketch.l2estimate(torch.from_numpy(table)))
    assert got == pytest.approx(want, rel=1e-6)


def test_gates_match_reference():
    for d, k in ((6_584_000, 50_000), (124_000_000, 50_000),
                 (1_651_552, 5000), (100, 10), (2_000_000, 2_000_000)):
        js = JaxSketch(d=d, c=524_288, r=5, backend="xla")
        ts = CountSketch(d=d, c=524_288, r=5)
        assert ts.prefer_sparse_resketch(k) == js.prefer_sparse_resketch(k)
        assert ts.prefer_threshold_unsketch(k) == \
            js.prefer_threshold_unsketch(k)


@pytest.mark.parametrize("r", [1, 3, 5, 8])
def test_packed_signs_bit_exact_with_reference(r):
    # the port's packed-sign stream against the JAX package's
    # _packed_signs_traced, byte for byte, and the plain sketch through
    # it equal to the plain sketch through the hash
    from commefficient_tpu_torch.ops import sketch_kernels as sk
    rng = np.random.RandomState(r)
    d, c = 9_001, 1_000
    seed = int(rng.randint(0, 2**31))
    js = JaxSketch(d=d, c=c, r=r, seed=seed, backend="xla")
    ts = CountSketch(d=d, c=c, r=r, seed=seed)
    got = ts.packed_signs_on("cpu")
    assert got.dtype == torch.uint8 and got.shape == (ts._padded_d,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(js._packed_signs_traced()))
    assert ts.packed_signs_on("cpu") is got  # cached
    vp = torch.nn.functional.pad(
        torch.from_numpy(rng.randn(d).astype(np.float32)),
        (0, ts._padded_d - d))
    rot = ts.rotations_on("cpu")
    args = (vp, rot, c, r, ts.sign_seed, True)
    hashed = sk.sketch_plain(*args)
    assert torch.equal(sk.sketch_plain(*args, signs=got), hashed)
    # a row chunk, as the bf16 wire sketches it
    if r > 1:
        assert torch.equal(sk.sketch_plain(vp, rot[1:], c, r - 1,
                                           ts.sign_seed, True, 1, got),
                           hashed[1:])


def test_packed_signs_only_where_eligible():
    # one-mix signs of at most 8 rows: the stream; otherwise none, and
    # the wrappers refuse a stream that does not hold the rows
    from commefficient_tpu_torch.ops import sketch_kernels as sk
    assert CountSketch(d=100, c=10, r=9).packed_signs_on("cpu") is None
    assert CountSketch(d=100, c=10, r=17).packed_signs_on("cpu") is None
    s = CountSketch(d=100, c=10, r=8)
    signs = s.packed_signs_on("cpu")
    vp = torch.zeros(100)
    with pytest.raises(ValueError, match="rows 0..7"):
        sk.sketch_plain(vp, s.rotations_on("cpu")[6:], 10, 2, s.sign_seed,
                        True, 7, signs)
    with pytest.raises(ValueError, match="uint8 stream"):
        sk.sketch_plain(vp, s.rotations_on("cpu"), 10, 8, s.sign_seed, True,
                        0, signs[:50])


@pytest.mark.parametrize("slip", [
    "none", "a chunk left out", "one row's sign dropped",
    "a rotation off by one", "sketch: last partial column tile not written",
    "estimates: last partial column tile not written",
    "the valid tail not zeroed"])
def test_card_smoke_sketch_checks_reject_slips(monkeypatch, slip):
    # chip_smoke.py holds the sketch and estimates kernels exactly against
    # their plain versions on the card. Here the kernels' results are the
    # plain ones with one slip each, and its check must raise. c = 1500
    # leaves the last 1024-column tile of both kernels partial; d = 5000
    # leaves a tail of 1000 padded coordinates
    import chip_smoke as cs
    from commefficient_tpu_torch.ops import sketch_kernels as sk
    d, c, r = 5_000, 1_500, 5
    s = CountSketch(d=d, c=c, r=r, seed=7)
    v = torch.from_numpy(np.random.RandomState(1).randn(d).astype(np.float32))
    vp = torch.nn.functional.pad(v, (0, s._padded_d - d))
    rot = s.rotations_on("cpu")
    sketch, estimates = sk.sketch_plain, sk.estimates_plain

    def slipped_sketch(vp, rot, c, r, seed, one_mix, row_offset=0,
                       signs=None):
        if slip == "a chunk left out":
            vp = vp.clone()
            vp[c:2 * c] = 0.0
        if slip == "a rotation off by one":
            rot = rot.clone()
            rot[1, 2] = (rot[1, 2] + 1) % c
        tab = sketch(vp, rot, c, r, seed, one_mix, row_offset, signs)
        if slip == "one row's sign dropped":
            cols = torch.arange(c)
            tab[2] = sum(vp[t * c + (cols - int(rot[2, t])) % c]
                         for t in range(rot.shape[1]))
        if slip == "sketch: last partial column tile not written":
            tab[:, 1024:] = 0.0
        return tab

    def slipped_estimates(table, rot, c, r, seed, one_mix, valid):
        if slip == "the valid tail not zeroed":
            valid = table.shape[1] * rot.shape[1]
        est = estimates(table, rot, c, r, seed, one_mix, valid)
        if slip == "estimates: last partial column tile not written":
            est.view(-1, c)[:, 1024:] = 0.0
        return est

    monkeypatch.setattr(sk, "sketch_kernel", slipped_sketch)
    monkeypatch.setattr(sk, "estimates_kernel", slipped_estimates)
    args = (vp, rot, c, r, s.sign_seed, s._one_mix_signs, d, slip,
            s.packed_signs_on("cpu"))
    if slip == "none":
        tab, est = cs.sketch_estimates_checks(*args)
        assert tab.shape == (r, c) and est.shape == (s._padded_d,)
    else:
        with pytest.raises(AssertionError):
            cs.sketch_estimates_checks(*args)


def test_sketch_ablation_variants_replace_their_pieces():
    # sketch_ablation patches the sketch and estimates kernels; every
    # variant must differ from the source, and an edit of the kernels
    # that removes a patched piece must fail loudly
    from commefficient_tpu_torch import _build, sketch_ablation
    src = (_build.SRC_DIR / "sketch.cu").read_text()
    out = sketch_ablation.variants(src)
    assert set(out) == {"base", "no_hash", "loads_only", "packed_signs"}
    assert out["base"] == src
    assert len(set(out.values())) == 4
    assert "cet_ablation_signs + g" in out["packed_signs"]
    assert sketch_ablation._SK_HASH not in out["no_hash"]
    assert "cet_median<R>(vals, r)" not in out["loads_only"]
    with pytest.raises(RuntimeError, match="update sketch_ablation"):
        sketch_ablation.variants(src.replace("acc[row][k] +=",
                                             "acc[row][k] ="))


@pytest.mark.parametrize("mangled,name", [
    ("_Z17cet_sketch_kernelILi5ELi4ELb0ELi2EEvPKfPKiPKhPfiiiji",
     "sketch_RG5_C4_stream"),
    ("_Z17cet_sketch_kernelILi8ELi2ELb1ELi0EEvPKfPKiPKhPfiiiji",
     "sketch_RG8_C2_ragged_row_mix"),
    ("_Z20cet_estimates_kernelILi5ELb1EEvPKfPKiPfiiijx",
     "estimates_R5_one_mix"),
    ("_Z20cet_estimates_kernelILi0ELb0EEvPKfPKiPfiiijx",
     "estimates_R0_row_mix"),
    ("_Z23cet_sketch_quant_kernelILi8ELb0EEvPKfPKiPvPfiiiijii",
     "sketch_quant_K8_int8"),
    ("_Z28cet_sketch_quant_rows_kernelILi5ELi4ELb0ELi2ELb0EEvPKfPKiPKhPvPf"
     "iiiji", "sketch_quant_RG5_C4_stream_int8"),
    ("_Z28cet_sketch_quant_rows_kernelILi8ELi2ELb1ELi0ELb1EEvPKfPKiPKhPvPf"
     "iiiji", "sketch_quant_RG8_C2_ragged_row_mix_fp8")])
def test_card_smoke_names_sketch_instantiations(mangled, name):
    # chip_smoke.py's ptxas_sketch line names csrc/sketch.cu's template
    # instantiations, and its check looks the main path's up by name
    import chip_smoke as cs
    assert cs.sketch_kernel_name(mangled) == name
    log = (f"ptxas info    : Function properties for {mangled}\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 64 registers, used 1 barriers\n")
    assert cs.ptxas_report(log) == {name: {"spill_stores": 0,
                                           "spill_loads": 0,
                                           "registers": 64}}

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


def test_approx_topk_not_ported():
    with pytest.raises(NotImplementedError, match="approx_topk"):
        CountSketch(d=100, c=10, r=1, approx_topk=True)

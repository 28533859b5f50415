"""The 2-D mesh's model-sharded FetchSGD server in the port, against the
JAX package.

- **The distributed selection** (``distributed_threshold_mask_1d``):
  on 4 launched gloo ranks and on 2, 4 and 8 shards in one process
  (``sharded_threshold_masks``, the same kernels and steps), the union
  of the shards' masks is the reference's under ``shard_map`` (as
  tests/test_mesh2d.py runs it: a forced three-way tie, a ragged last
  shard) and the one-card port's ``threshold_topk_mask_1d``, bit for
  bit, with ties straddling the shard boundaries and k = 1.
- **estimates_at** bit-equal to the JAX ``estimates_at`` and to the
  port's whole-range and windowed estimates.
- **The 2-D round** (``--mesh 2x2``, ``1x4``, ``4x1`` on 4 gloo ranks,
  three chained rounds of the reference tests' linear model) within
  1e-6 of the reference's 1-D oracle (``tests/test_mesh2d.py``
  ``_run_rounds`` with no mesh, its stated tolerance) in the weights,
  the gathered momentum and error and the last aggregate; and of the
  port's own one-device round.
- **The state's shards** are (r, c/M) on every rank.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from commefficient_tpu.core.rounds import args2sketch as jax_args2sketch
from commefficient_tpu.ops.topk import \
    distributed_threshold_mask_1d as jax_distributed_mask
from commefficient_tpu.parallel.mesh import (MODEL_AXIS, make_mesh2d,
                                             shard_map, spec)
from commefficient_tpu_torch.core.rounds import args2sketch
from commefficient_tpu_torch.ops.topk import (sharded_threshold_masks,
                                              threshold_topk_mask_1d)
from commefficient_tpu_torch.parallel.mesh import launch

from test_mesh2d import _run_rounds
from test_sharding import _batch, _setup


def _keys(case):
    d, k, ties = case
    rng = np.random.RandomState(d + k)
    sq = np.abs(rng.randn(d)).astype(np.float32)
    for group in ties:
        sq[list(group)] = 1.7
    return sq


def _shards(sq, m):
    n_loc = -(-len(sq) // m)
    padded = np.pad(sq, (0, n_loc * m - len(sq)))
    return ([padded[p * n_loc:(p + 1) * n_loc] for p in range(m)],
            [max(0, min(n_loc, len(sq) - p * n_loc)) for p in range(m)])


_JAX_MASKS = {}


def _jax_mask(sq, k, m):
    """The reference's mask under shard_map over m devices (cached: each
    call compiles)."""
    key = (sq.tobytes(), k, m)
    if key not in _JAX_MASKS:
        _JAX_MASKS[key] = _jax_mask_uncached(sq, k, m)
    return _JAX_MASKS[key]


def _jax_mask_uncached(sq, k, m):
    shards, nv = _shards(sq, m)
    n_loc = len(shards[0])
    valid = np.arange(n_loc * m) < len(sq)
    mesh = make_mesh2d(1, m, jax.devices()[:m])
    mask = shard_map(
        lambda s, v: jax_distributed_mask(s, k, MODEL_AXIS, valid=v),
        mesh=mesh, in_specs=(spec(MODEL_AXIS), spec(MODEL_AXIS)),
        out_specs=spec(MODEL_AXIS))(jnp.asarray(np.concatenate(shards)),
                                    jnp.asarray(valid))
    return np.asarray(mask)[:len(sq)]


# (d, k, tie groups): the reference's forced three-way tie; ties across
# each boundary of 4 shards of 40 (10 each), cut inside the first group
# and inside the second; k = 1; a tail shard of one key
CASES = [(37, 7, [(5, 21, 30)]),
         (160, 7, [range(35, 45), range(75, 85), range(115, 125)]),
         (160, 15, [range(35, 45), range(75, 85), range(115, 125)]),
         (160, 1, [range(35, 45)]),
         (121, 30, [range(25, 35), range(58, 64)])]


@pytest.fixture(scope="module")
def launched_masks():
    cases = [_shards(_keys(c), 4) for c in CASES]
    got = launch(4, workers.select_shards,
                 [(sh, c[1], nv) for (sh, nv), c in zip(cases, CASES)],
                 device_type="cpu")
    return {c[:2]: np.concatenate([g[i] for g in got])[:c[0]]
            for i, c in enumerate(CASES)}


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"d{c[0]}k{c[1]}")
def test_launched_selection_is_the_reference_and_the_one_card(
        launched_masks, case):
    sq = _keys(case)
    got = launched_masks[case[:2]]
    want = _jax_mask(sq, case[1], 4)
    np.testing.assert_array_equal(got, want)
    one = threshold_topk_mask_1d(torch.from_numpy(sq), case[1]).numpy()
    np.testing.assert_array_equal(got, one)
    assert got.sum() == case[1]


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"d{c[0]}k{c[1]}")
def test_sharded_selection_in_one_process(case, m):
    """Against the one-card port at every (case, M); against the
    reference's shard_map at M = 4 (cached from the launched test) and,
    for the three-way tie and the boundary-straddling cut, at M = 2 and
    8 (each of the reference's calls compiles for seconds)."""
    sq = _keys(case)
    shards, nv = _shards(sq, m)
    got = torch.cat(sharded_threshold_masks(
        [torch.from_numpy(s) for s in shards], case[1], nv)).numpy()
    assert not got[len(sq):].any()
    np.testing.assert_array_equal(
        got[:len(sq)],
        threshold_topk_mask_1d(torch.from_numpy(sq), case[1]).numpy())
    if m == 4 or case in (CASES[0], CASES[2]):
        np.testing.assert_array_equal(got[:len(sq)],
                                      _jax_mask(sq, case[1], m))


@pytest.mark.parametrize("geom", [(16, 32, 3), (3001, 256, 5)])
def test_estimates_at_bit_identical(geom):
    d, c, r = geom
    cfg = _setup("sketch", grad_size=d, num_cols=c, num_rows=r)
    jsk = jax_args2sketch(cfg)
    from commefficient_tpu_torch.config import Config
    sk = args2sketch(Config(mode="sketch", error_type="virtual",
                            local_momentum=0.0, grad_size=d, num_cols=c,
                            num_rows=r, seed=cfg.seed, device="cpu"))
    table = np.random.RandomState(11).randn(r, c).astype(np.float32)
    idx = np.arange(d, dtype=np.int32)
    want = np.asarray(jsk.estimates_at(jnp.asarray(table),
                                       jnp.asarray(idx)))
    tt = torch.from_numpy(table)
    got = sk.estimates_at(tt, torch.from_numpy(idx).long()).numpy()
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == sk.estimates(tt).numpy().tobytes()
    for m in (2, 3, 4):
        n_loc = -(-d // m)
        for p in range(m):
            lo, hi = p * n_loc, min((p + 1) * n_loc, d)
            win = sk.estimates_window(tt, lo, hi).numpy()
            assert win.tobytes() == got[lo:hi].tobytes()


SHAPES = ["2x2", "1x4", "4x1"]


def _np_batches():
    return [{k: np.asarray(v) for k, v in _batch(seed=5 + r)[0].items()}
            for r in range(3)]


@pytest.fixture(scope="module")
def rounds_2d():
    kw = dict(mode="sketch", local_momentum=0.0, virtual_momentum=0.9,
              weight_decay=5e-4, error_type="virtual", num_workers=8, k=4,
              num_rows=3, num_cols=32, num_blocks=1, grad_size=16, seed=21)
    ps0 = np.zeros(16, np.float32)
    ps0[0] = 0.5
    batches = _np_batches()
    out = {"one": workers.linear_rounds(kw, batches, ps0)}
    for shape in SHAPES:
        out[shape] = launch(4, workers.linear_rounds, dict(kw, mesh=shape),
                            batches, ps0, device_type="cpu")
    return out


def _gathered(outs, key):
    """Client row 0's column shards of ``key``, side by side."""
    row = sorted((o for o in outs if o["rank"] < outs[0]["model"][1]),
                 key=lambda o: o["model"][0])
    val = [o[key] for o in row]
    return np.concatenate(val, axis=-1)


@pytest.mark.parametrize("shape", SHAPES)
def test_2d_round_matches_the_1d_oracle(rounds_2d, shape):
    cfg = _setup("sketch", weight_decay=5e-4)
    ps, vel, err, agg, _ = _run_rounds(cfg, None)
    outs = rounds_2d[shape]
    for o in outs:
        np.testing.assert_allclose(o["weights"][-1], ps, rtol=0, atol=1e-6)
        # every rank's weights the same bits
        assert o["weights"][-1].tobytes() == outs[0]["weights"][-1].tobytes()
    got = (_gathered(outs, "Vvelocity"), _gathered(outs, "Verror"),
           np.concatenate([o["aggs"][-1] for o in sorted(
               (o for o in outs if o["rank"] < outs[0]["model"][1]),
               key=lambda o: o["model"][0])], axis=-1))
    for g, w in zip(got, (vel, err, agg)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    one = rounds_2d["one"]
    np.testing.assert_allclose(outs[0]["weights"][-1], one["weights"][-1],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1], one["Verror"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_server_state_shards_one_over_m(rounds_2d, shape):
    m = int(shape.split("x")[1])
    for o in rounds_2d[shape]:
        assert o["Verror"].shape == (3, 32 // m)
        assert o["Vvelocity"].shape == (3, 32 // m)
        assert o["aggs"][-1].shape == (3, 32 // m)

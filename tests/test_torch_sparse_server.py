"""The port's sparse re-sketch server branch against the JAX package's,
on the CPU: the exact index selection, the scatter re-sketch and one
whole server step at d > 90*r*k.

- ``threshold_topk_indices``: the same ascending index set exactly,
  ties and all-equal keys included (both take the lowest indices).
- ``sketch_sparse``: within summation order of the port's dense
  ``sketch`` of the scattered vector and of the JAX ``sketch_sparse``
  (1e-6 of the table's largest bucket: scatter-adds of at most a few
  values per bucket, summed in another order), with the same zero
  buckets.
- One server step: the selected indices, the lr-scaled values, ``keep``,
  the new state and the new ``ps`` exactly (estimates and selection are
  exact, everything else is elementwise).
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.core.rounds import \
    build_server_round as jax_server_round
from commefficient_tpu.core.server import ServerState as JaxState
from commefficient_tpu.core.server import server_update as jax_update
from commefficient_tpu.ops.sketch import CountSketch as JaxSketch
from commefficient_tpu.ops.topk import \
    threshold_topk_indices as jax_indices
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.core.rounds import build_server_round
from commefficient_tpu_torch.core.server import ServerState, server_update
from commefficient_tpu_torch.ops.sketch import CountSketch
from commefficient_tpu_torch.ops.topk import threshold_topk_indices


def _keys(name, d, rng):
    if name == "random":
        return rng.rand(d).astype(np.float32) ** 2
    if name == "ties":
        # few distinct values: the k-th value is shared by many indices
        return rng.randint(0, 6, d).astype(np.float32)
    if name == "all-equal":
        return np.ones(d, np.float32)
    # mostly zero: the threshold is 0 and most of k comes from ties
    sq = np.zeros(d, np.float32)
    sq[rng.choice(d, 40, replace=False)] = 1.0 + rng.rand(40)
    return sq


@pytest.mark.parametrize("name", ["random", "ties", "all-equal",
                                  "zero-threshold"])
@pytest.mark.parametrize("d,k", [(70_001, 2000), (3000, 1)])
def test_threshold_indices_match_jax(name, d, k):
    sq = _keys(name, d, np.random.RandomState(d + k))
    ours = threshold_topk_indices(torch.from_numpy(sq), k).numpy()
    theirs = np.asarray(jax_indices(jnp.asarray(sq), k))
    assert ours.shape == (k,)
    np.testing.assert_array_equal(ours, theirs)
    assert np.all(np.diff(ours) > 0)


@pytest.mark.parametrize("d,c,r,n", [(1_200_000, 65_536, 5, 2000),
                                     (50_000, 1000, 17, 300)])
def test_sketch_sparse_matches_dense_and_jax(d, c, r, n):
    rng = np.random.RandomState(n)
    idx = np.sort(rng.choice(d, n, replace=False)).astype(np.int64)
    vals = rng.randn(n).astype(np.float32)
    sketch = CountSketch(d=d, c=c, r=r, seed=9)
    ours = sketch.sketch_sparse(torch.from_numpy(idx),
                                torch.from_numpy(vals)).numpy()
    dense = np.zeros(d, np.float32)
    dense[idx] = vals
    via_dense = sketch.sketch(torch.from_numpy(dense)).numpy()
    theirs = np.asarray(JaxSketch(d=d, c=c, r=r, seed=9, backend="xla")
                        .sketch_sparse(jnp.asarray(idx, jnp.int32),
                                       jnp.asarray(vals)))
    tol = 1e-6 * np.abs(via_dense).max()
    for other in (via_dense, theirs):
        np.testing.assert_allclose(ours, other, rtol=0, atol=tol)
        np.testing.assert_array_equal(ours == 0, other == 0)
    assert (ours == 0).any() and (ours != 0).any()


# big d (threshold select over padded estimates) and a d < 2^20 case,
# where the JAX package selects by lax.top_k instead
GEOMS = [(1_173_121, 65_536, 5, 2000), (200_000, 1000, 5, 10)]


@pytest.mark.parametrize("d,c,r,k", GEOMS)
@pytest.mark.parametrize("error_type", ["virtual", "none"])
def test_sparse_server_step_matches_jax(d, c, r, k, error_type):
    rng = np.random.RandomState(k)
    agg = (rng.randn(r, c) * 1e-3).astype(np.float32)
    vel, err = ((rng.randn(r, c) * 1e-3).astype(np.float32)
                for _ in range(2))
    ps = rng.randn(d).astype(np.float32)
    kw = dict(mode="sketch", error_type=error_type, local_momentum=0.0,
              virtual_momentum=0.9, k=k, num_rows=r, num_cols=c, seed=3,
              grad_size=d)
    sketch = CountSketch(d=d, c=c, r=r, seed=3)
    assert sketch.prefer_sparse_resketch(k)
    assert not sketch.prefer_threshold_unsketch(k)
    jcfg, tcfg = JaxConfig(**kw), Config(device="cpu", **kw)
    jsk = JaxSketch(d=d, c=c, r=r, seed=3, backend="xla")
    jstate = JaxState(jnp.asarray(vel), jnp.asarray(err))
    tstate = ServerState(torch.from_numpy(vel.copy()),
                         torch.from_numpy(err.copy()))
    jres = jax_update(jcfg, jnp.asarray(agg), jstate, jnp.float32(0.1), jsk)
    tres = server_update(tcfg, torch.from_numpy(agg), tstate,
                         torch.tensor(0.1, dtype=torch.float32), sketch)
    assert jres.weight_update is None and tres.weight_update is None

    jidx, jvals = (np.asarray(a) for a in jres.support)
    order = np.argsort(jidx)
    tidx, tvals = (t.numpy() for t in tres.support)
    np.testing.assert_array_equal(tidx, jidx[order])
    np.testing.assert_array_equal(tvals, jvals[order])
    for name in ("Vvelocity", "Verror"):
        np.testing.assert_array_equal(getattr(tres.state, name).numpy(),
                                      np.asarray(getattr(jres.state, name)))
    # keep: the buckets zeroed by the step are the same
    assert (tres.state.Vvelocity.numpy() == 0).sum() > 0

    # the server round applies the support as a k-sized scatter
    jround = jax_server_round(jcfg)
    jps = jround(jnp.asarray(ps), jstate, jnp.asarray(agg),
                 jnp.float32(0.1))[0]
    tps, _, _, upd, support = build_server_round(tcfg)(
        torch.from_numpy(ps), tstate, torch.from_numpy(agg), 0.1)
    assert upd is None and support[0].shape == (k,)
    np.testing.assert_array_equal(tps.numpy(), np.asarray(jps))
    changed = np.nonzero(tps.numpy() != ps)[0]
    np.testing.assert_array_equal(changed, tidx[tvals != 0])

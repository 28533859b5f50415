"""Asynchronous rounds and the autopilot on the port's mesh
(``--async_buffer_size`` and ``--autopilot on`` with ``--num_devices N``
or ``--mesh CxM``) against the JAX package, on launched gloo ranks.

- **The weighted fold on 2x2** (reference ``tests/test_asyncfed.py:403``):
  four ranks each run their clients' slice and their slice of the
  staleness; the fused sketch round's partial-sketch reduce-scatter
  leaves each rank its columns, which equal the JAX 2x2 fold's and its
  one-device fold's at rtol 1e-5 / atol 1e-5.
- **The backlog across a resize** (reference ``tests/test_elastic.py:172``,
  staleness weight 0.5): three asynchronous rounds on ``2x1`` give the
  JAX ``2x1`` run's weights (rtol 1e-4, atol 1e-6, the 1-D mesh
  tolerance of tests/test_torch_mesh_round.py), and the save holds a
  backlog. Restored onto ``1x2`` the weights are bit-exact and a re-save
  is bit-equal, array by array; three more rounds there are within atol
  1e-4 of the port's own ``2x1`` continuation and of the JAX ``2x1``
  continuation from the same archive. (The reference's own ``1x2`` half
  does not build under jax 0.9.0: its 2-D sketch server's ``shard_map``.)
- **The per-client round weighted on the 1-D mesh**: the clipped and
  the median fold (uncompressed, so no selection near a threshold can
  flip) on two ranks give the JAX one-device asynchronous run's weights
  (rtol 1e-4, atol 1e-6); ``--dp sketch`` over the static W·B gives the
  port's one-device run's weights at the same tolerance and the same ε,
  charged once a round.
- **The autopilot on two ranks** (the dtype and the geometry walk on
  ``--num_devices 2``, the geometry walk on ``--mesh 1x2``): every rank
  dispatches the JAX one-device run's variant key every round and ends
  at its final key. The 1-D runs' weights agree with the JAX run on a
  2-device mesh at rtol 1e-4 / atol 1e-6 (a quantized wire crossing a
  mesh rounds each rank's partial table, so they are not one device's
  once the walk leaves f32; the JAX warm-ahead compile on its CPU mesh
  moves only its ledger stamps, not the weights).

One launch of two ranks serves every two-rank check, one of four the
2x2 fold.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_workers as workers
from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.core.rounds import ClientStates as JaxClientStates
from commefficient_tpu.core.rounds import \
    build_client_round as jax_client_round
from commefficient_tpu.parallel.mesh import make_mesh, make_mesh2d
from commefficient_tpu.runtime.checkpoint import \
    load_checkpoint as jax_load
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.runtime.fed_model import FedOptimizer as JaxFedOpt
from commefficient_tpu_torch.autopilot import key_str
from commefficient_tpu_torch.parallel.mesh import launch

from test_asyncfed import _staleness_from

RTOL, ATOL = 1e-4, 1e-6
FOLD_TOL = 1e-5
CONT_ATOL = 1e-4

# the reference elastic test's cell
W, B, D, NC = 4, 2, 256, 8
SKETCH = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9, k=16, num_rows=3, num_cols=128)
ASYNC = dict(num_workers=W, local_batch_size=B, seed=5, num_clients=NC,
             async_buffer_size=2, async_staleness_weight=0.5)
UNCOMP = dict(mode="uncompressed", error_type="none", local_momentum=0.0,
              virtual_momentum=0.9)
PER_CLIENT = {
    "clip": dict(UNCOMP, max_grad_norm=0.5),
    "median": dict(UNCOMP, robust_agg="median"),
}
DP = dict(SKETCH, dp="sketch", dp_noise_mult=1.1, dp_epsilon=50.0,
          dp_clip=1.0)

# the autopilot cell of tests/test_torch_autopilot.py
AP_D, AP_NC = 512, 16
AP_BASE = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
               virtual_momentum=0.9, num_workers=W, local_batch_size=B,
               seed=5, num_clients=AP_NC, k=64, num_rows=5, num_cols=2048,
               autopilot="on", probe_every=1, autopilot_cooldown=1)
AP_GEOMETRY = dict(autopilot_band="0.15:0.8", autopilot_geometry=True)
AP_WALKS = {
    "dtype_1d": (dict(num_devices=2), dict(autopilot_band="0.1:0.6"), 8),
    "geometry_1d": (dict(num_devices=2), AP_GEOMETRY, 12),
    "geometry_1x2": (dict(num_devices=2, mesh="1x2"), AP_GEOMETRY, 12),
}


def _batch(r):
    rng = np.random.RandomState(1000 + r)
    return {"client_ids": rng.choice(NC, W, replace=False).astype(np.int32),
            "x": rng.randn(W, B, D).astype(np.float32),
            "y": rng.randn(W, B).astype(np.float32),
            "mask": np.ones((W, B), np.float32)}


def _heavy_rounds(n, seed=5):
    rs = np.random.RandomState(seed)
    scale = (np.arange(1, AP_D + 1) ** -1.5).astype(np.float32)
    return [{"client_ids": rs.choice(AP_NC, W, replace=False)
             .astype(np.int32),
             "x": rs.randn(W, B, AP_D).astype(np.float32) * scale,
             "y": rs.randn(W, B).astype(np.float32),
             "mask": np.ones((W, B), np.float32)} for _ in range(n)]


def _rounds(r0, r1):
    return [("round", _batch(r)) for r in range(r0, r1)]


def _jax_loss(params, batch, cfg):
    pred = batch["x"] @ params["w"]
    n = jnp.maximum(jnp.sum(batch["mask"]), 1.0)
    loss = jnp.sum((pred - batch["y"]) ** 2 * batch["mask"]) / n
    return loss, (loss * 0.0 + 1.0,)


def _jax_model(kw, d, lr, mesh=None):
    cfg = JaxConfig(**kw)
    model = JaxFedModel(None, {"w": jnp.zeros((d,), jnp.float32)},
                        _jax_loss, cfg, padded_batch_size=B,
                        **({} if mesh is None else {"mesh": mesh}))
    if cfg.async_buffer_size:
        model.attach_arrival_process(workers.lag)
    return model, JaxFedOpt([{"lr": lr}], cfg, model=model)


def _jax_rounds(model, opt, batches):
    out, keys = [], []
    for b in batches:
        keys.append(getattr(model, "_variant_key", None))
        model({k: v if k == "client_ids" else jnp.asarray(v)
               for k, v in b.items()})
        opt.step()
        out.append(np.asarray(jax.device_get(model.ps_weights)))
    return out, keys


def _arrays(path):
    with np.load(path, allow_pickle=False) as z:
        return ({k: np.asarray(z[k]) for k in z.files if k != "meta"},
                json.loads(str(z["meta"])))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Every two-rank run in one launch, by name: each rank's result."""
    tmp = tmp_path_factory.mktemp("mesh_async")
    ck_a, ck_b = str(tmp / "a.npz"), str(tmp / "b.npz")
    m2x1 = dict(ASYNC, num_devices=2, mesh="2x1", **SKETCH)
    m1x2 = dict(ASYNC, num_devices=2, mesh="1x2", **SKETCH)
    runs = {
        "backlog": (m2x1, D, 0.25, _rounds(0, 3) + [("save", ck_a),
                                                   ("snap",)]),
        "resized": (m1x2, D, 0.25, [("load", ck_a), ("snap",),
                                    ("save", ck_b)] + _rounds(3, 6)),
        "unresized": (m2x1, D, 0.25, [("load", ck_a)] + _rounds(3, 6)),
        "dp": (dict(ASYNC, num_devices=2, **DP), D, 0.25, _rounds(0, 3)),
    }
    for name, kw in PER_CLIENT.items():
        runs[name] = (dict(ASYNC, num_devices=2, **kw), D, 0.25,
                      _rounds(0, 3))
    for name, (mesh_kw, kw, n) in AP_WALKS.items():
        runs[name] = (dict(AP_BASE, **mesh_kw, **kw), AP_D, 0.25,
                      [("round", b) for b in _heavy_rounds(n)])
    names = list(runs)
    outs = launch(2, workers.fed_runs, [runs[n] for n in names],
                  device_type="cpu")
    return {"ck_a": ck_a, "ck_b": ck_b,
            **{n: [o[i] for o in outs] for i, n in enumerate(names)}}


def _same_on_every_rank(outs):
    for o in outs[1:]:
        for a, b in zip(o["weights"], outs[0]["weights"]):
            assert np.array_equal(a, b)


def test_weighted_fold_on_2x2_matches_jax():
    cfg_kw = dict(mode="sketch", error_type="virtual",
                  virtual_momentum=0.9, num_workers=W, grad_size=512,
                  num_rows=3, num_cols=64, async_buffer_size=W,
                  async_staleness_weight=0.5, local_momentum=0.0,
                  weight_decay=0.0, k=3, num_blocks=1, local_batch_size=B,
                  microbatch_size=-1, seed=21)
    rng = np.random.default_rng(8)
    c = rng.normal(size=(W, 1, 512)).astype(np.float32)
    batch = {"c": np.ascontiguousarray(np.broadcast_to(c, (W, B, 512))),
             "mask": np.ones((W, B), np.float32)}
    stale = _staleness_from("churny", W, seed=17)
    outs = launch(4, workers.weighted_folds,
                  [(dict(cfg_kw, mesh="2x2", num_devices=4), batch, stale)],
                  device_type="cpu")

    def lin_loss(p, b):
        n = jnp.maximum(jnp.sum(b["mask"]), 1.0)
        loss = jnp.sum((b["c"] @ p) * b["mask"]) / n
        return loss, (loss * 0.0,)

    def run(mesh):
        cfg = JaxConfig(**dict(cfg_kw, mesh="2x2"))
        flat = jnp.zeros((512,), jnp.float32)
        cr = jax.jit(jax_client_round(cfg, lin_loss, B, mesh=mesh,
                                      client_weights=True))
        res = cr(flat, JaxClientStates.init(cfg, W, flat),
                 {k: jnp.asarray(v) for k, v in batch.items()},
                 jnp.arange(W, dtype=jnp.int32), jax.random.PRNGKey(0),
                 jnp.float32(1.0), jnp.asarray(stale))
        return np.asarray(jax.device_get(res.aggregated)).reshape(3, -1)

    agg2d, agg1d = run(make_mesh2d(2, 2)), run(None)
    for r, o in enumerate(outs):
        m = r % 2
        cols = slice(m * 32, (m + 1) * 32)
        got = o[0].reshape(3, 32)
        np.testing.assert_allclose(got, agg2d[:, cols], rtol=FOLD_TOL,
                                   atol=FOLD_TOL)
        np.testing.assert_allclose(got, agg1d[:, cols], rtol=FOLD_TOL,
                                   atol=FOLD_TOL)


def test_backlog_rounds_on_2x1_match_jax(two):
    outs = two["backlog"]
    _same_on_every_rank(outs)
    jm, jo = _jax_model(dict(ASYNC, mesh="2x1", **SKETCH), D, 0.25)
    want, _ = _jax_rounds(jm, jo, [_batch(r) for r in range(3)])
    jm.finalize()
    for got, exp in zip(outs[0]["weights"], want):
        np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    _, meta = _arrays(two["ck_a"])
    assert int(meta["asyncfed"]["pending"]) > 0, \
        "the drill needs arrivals in flight at the save"
    # every rank's AsyncRoundDriver folded the same late clients
    stale = [[s["async_staleness_max"] for s in o["async_stats"]]
             for o in outs]
    assert stale[0] == stale[1] and max(stale[0]) > 0


def test_backlog_resize_restores_bit_exact_and_continues(two):
    saved, _ = two["backlog"][0]["snaps"][0]
    for o in two["resized"]:
        ps, ridx = o["snaps"][0]
        assert np.array_equal(ps, saved) and ridx == 3
    a, _ = _arrays(two["ck_a"])
    b, _ = _arrays(two["ck_b"])
    assert set(a) == set(b)
    for k in sorted(a):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    _same_on_every_rank(two["resized"])
    ours = two["resized"][0]["weights"][-1]
    mine = two["unresized"][0]["weights"][-1]
    jm, jo = _jax_model(dict(ASYNC, mesh="2x1", **SKETCH), D, 0.25)
    jax_load(two["ck_a"], jm, jo)
    want, _ = _jax_rounds(jm, jo, [_batch(r) for r in range(3, 6)])
    jm.finalize()
    np.testing.assert_allclose(ours, mine, rtol=0, atol=CONT_ATOL)
    np.testing.assert_allclose(ours, want[-1], rtol=0, atol=CONT_ATOL)


@pytest.mark.parametrize("name", sorted(PER_CLIENT))
def test_weighted_per_client_round_matches_jax(two, name):
    outs = two[name]
    _same_on_every_rank(outs)
    jm, jo = _jax_model(dict(ASYNC, **PER_CLIENT[name]), D, 0.25,
                        mesh=make_mesh([jax.devices()[0]]))
    want, _ = _jax_rounds(jm, jo, [_batch(r) for r in range(3)])
    jm.finalize()
    for got, exp in zip(outs[0]["weights"], want):
        np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)


def test_dp_sketch_weighted_fold_and_charge_match_one_card(two):
    outs = two["dp"]
    _same_on_every_rank(outs)
    one = workers.fed_runs([(dict(ASYNC, num_devices=1, **DP), D, 0.25,
                             _rounds(0, 3))])[0]
    for got, exp in zip(outs[0]["weights"], one["weights"]):
        np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    assert all(o["eps"] == one["eps"] > 0 for o in outs)


@pytest.mark.parametrize("name", sorted(AP_WALKS))
def test_mesh_autopilot_takes_the_jax_walk(two, name):
    mesh_kw, kw, n = AP_WALKS[name]
    outs = two[name]
    _same_on_every_rank(outs)
    jm, jo = _jax_model(dict(AP_BASE, **kw), AP_D, 0.25,
                        mesh=make_mesh([jax.devices()[0]]))
    _jax_rounds(jm, jo, _heavy_rounds(n))
    jrec = jm.autopilot_record()
    jm.finalize()
    jkeys = [t["key"] for t in jrec["trajectory"]]
    for o in outs:
        rec = o["ap"]
        assert [t["key"] for t in rec["trajectory"]] == jkeys
        assert rec["final"] == jrec["final"]
        # the dispatched key of every round after the first is where the
        # previous round's observation moved the controller
        assert [key_str(k) for k in o["keys"][1:]] == jkeys[:-1]
    assert len(set(jkeys)) > 1, "the walk never moved"
    if "mesh" in mesh_kw:
        # the reference's 2-D sketch server does not build under jax
        # 0.9.0: the 1x2 walk is held by its keys and its finite weights
        assert all(np.isfinite(w).all() for w in outs[0]["weights"])
        return
    # the weights against the JAX run on a mesh of as many devices: a
    # quantized wire crossing a mesh rounds each rank's partial table
    # (C addends of headroom), so one device's bf16 and int8 rounds are
    # not the mesh's
    jm, jo = _jax_model(dict(AP_BASE, **kw), AP_D, 0.25,
                        mesh=make_mesh(jax.devices()[:2]))
    want, _ = _jax_rounds(jm, jo, _heavy_rounds(n))
    jm.finalize()
    for got, exp in zip(outs[0]["weights"], want):
        np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)

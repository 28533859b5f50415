"""The 2-D mesh's dense server in the port (``--mesh CxM`` in
uncompressed mode; core/server.py ``uncompressed_update_2d``, reference
``_build_server_round_2d_dense``, core/rounds.py:1477-1505), on launched
gloo ranks, against the JAX package.

- **The round.** Three chained rounds of the reference tests' linear
  model (``tests/test_mesh2d.py`` ``_run_rounds``: W = 8, d = 16,
  virtual momentum 0.9, weight decay 5e-4) at ``--mesh 2x2``, ``1x2``
  and ``1x3`` (a short last window: 6, 6 and 4 coordinates): the
  weights and the gathered momentum within 1e-6 of the reference's own
  2-D dense server (``build_server_round(cfg, mesh=make_mesh2d(...))``,
  at 2x2 and 1x2) and of its 1-D oracle (``_run_rounds`` with no mesh),
  the stated tolerance of tests/test_mesh2d.py:71; every rank's weights
  the same bits.
- **The windows.** Rank m holds coordinates [m·ceil(d/M), ...) of
  ``Vvelocity``, ceil(d/M) of them (the last window short); on
  ``1xM`` (one client shard, so the aggregate is the one-device
  round's) each window is the port's one-device momentum's slice, bit
  for bit, and so are the weights.
- **The probes** (``update_norm``, ``momentum_norm``,
  ``residual_norm``, their squares summed over ``model``) within rtol
  1e-6 of the one-device server's.
- **Server DP** (``--do_dp --dp_mode server``): the noise is the
  one-device draw's window: at ``1x2`` the weights and windows are the
  one-device round's with the same stream, bit for bit; so are they
  with a per-coordinate LR (index param groups' (d,) LR), each rank
  applying its window of it.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import numpy as np
import pytest

import torch_mesh_workers as workers
from commefficient_tpu.parallel.mesh import make_mesh2d
from commefficient_tpu_torch.core.server import dense_window
from commefficient_tpu_torch.parallel.mesh import launch

from test_mesh2d import _run_rounds
from test_sharding import _batch, _setup

D = 16
BASE = dict(mode="uncompressed", error_type="none", local_momentum=0.0,
            virtual_momentum=0.9, weight_decay=5e-4, num_workers=8, k=4,
            num_rows=3, num_cols=32, num_blocks=1, grad_size=D, seed=21)
DP = dict(BASE, do_dp=True, dp_mode="server", noise_multiplier=0.5)
# (shape, config name); the world is C·M
CASES = [("2x2", "plain"), ("1x2", "plain"), ("1x3", "plain"),
         ("1x2", "dp")]
CONFIGS = {"plain": BASE, "dp": DP}


def _np_batches():
    return [{k: np.asarray(v) for k, v in _batch(seed=5 + r)[0].items()}
            for r in range(3)]


def _ps0():
    ps0 = np.zeros(D, np.float32)
    ps0[0] = 0.5
    return ps0


# a per-coordinate LR: 0.01 and 0.02 on alternate coordinates, one 0
VECTOR_LR = np.where(np.arange(D) % 2, 0.02, 0.01).astype(np.float32)
VECTOR_LR[5] = 0.0


@pytest.fixture(scope="module")
def runs():
    batches = _np_batches()
    out = {name: workers.dense2d_rounds(kw, batches, _ps0())
           for name, kw in CONFIGS.items()}
    out["vector_lr"] = workers.dense2d_rounds(BASE, batches, _ps0(),
                                              VECTOR_LR)
    for shape, name in CASES:
        c, m = (int(p) for p in shape.split("x"))
        out[(shape, name)] = launch(
            c * m, workers.dense2d_rounds, dict(CONFIGS[name], mesh=shape),
            batches, _ps0(), device_type="cpu")
    out[("1x3", "vector_lr")] = launch(
        3, workers.dense2d_rounds, dict(BASE, mesh="1x3"), batches, _ps0(),
        VECTOR_LR, device_type="cpu")
    return out


def _whole(outs, rnd):
    """The momentum windows of client row 0's ranks laid end to end."""
    row = sorted((o for o in outs if o["rank"] < outs[0]["model"][1]),
                 key=lambda o: o["model"][0])
    return np.concatenate([o["Vvelocity"][rnd] for o in row])


_JAX = {}


def _jax_rounds(mesh_shape):
    """The reference's rounds, 1-D oracle (None) or its 2-D dense server
    on ``make_mesh2d(C, M)`` of its CPU devices (cached)."""
    if mesh_shape not in _JAX:
        cfg = _setup("uncompressed", error_type="none",
                     virtual_momentum=0.9, weight_decay=5e-4)
        mesh = None
        if mesh_shape is not None:
            c, m = mesh_shape
            mesh = make_mesh2d(c, m, jax.devices()[:c * m])
        _JAX[mesh_shape] = _run_rounds(cfg, mesh)
    return _JAX[mesh_shape]


@pytest.mark.parametrize("shape", ["2x2", "1x2", "1x3"])
def test_dense_2d_round_matches_the_reference(runs, shape):
    outs = runs[(shape, "plain")]
    c, m = (int(p) for p in shape.split("x"))
    wants = [_jax_rounds(None)]
    if m < 3:
        wants.append(_jax_rounds((c, m)))
    for want in wants:
        ps, vel = want[0], want[1]
        for o in outs:
            np.testing.assert_allclose(o["weights"][-1], ps, rtol=0,
                                       atol=1e-6)
            assert o["weights"][-1].tobytes() == \
                outs[0]["weights"][-1].tobytes()
        np.testing.assert_allclose(_whole(outs, -1), vel, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", ["2x2", "1x2", "1x3"])
def test_each_rank_holds_its_window(runs, shape):
    one = runs["plain"]
    m = int(shape.split("x")[1])
    for o in runs[(shape, "plain")]:
        lo, hi = dense_window(D, m, o["model"][0])
        assert hi - lo == min(-(-D // m), D - lo)
        for rnd in range(3):
            assert o["Vvelocity"][rnd].shape == (hi - lo,)
            if shape.startswith("1x"):
                assert o["Vvelocity"][rnd].tobytes() == \
                    one["Vvelocity"][rnd][lo:hi].tobytes()
                assert o["weights"][rnd].tobytes() == \
                    one["weights"][rnd].tobytes()


@pytest.mark.parametrize("shape", ["2x2", "1x2", "1x3"])
def test_probes_are_the_one_device_probes(runs, shape):
    one = runs["plain"]
    for o in runs[(shape, "plain")]:
        for got, want in zip(o["probes"], one["probes"]):
            assert set(got) == set(want) == {"update_norm",
                                             "momentum_norm",
                                             "residual_norm"}
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           atol=1e-12)


def test_server_noise_is_the_one_device_draw_window(runs):
    one = runs["dp"]
    plain = runs["plain"]
    # the noise moved the weights
    assert one["weights"][-1].tobytes() != plain["weights"][-1].tobytes()
    for o in runs[("1x2", "dp")]:
        lo, hi = dense_window(D, 2, o["model"][0])
        for rnd in range(3):
            assert o["weights"][rnd].tobytes() == \
                one["weights"][rnd].tobytes()
            assert o["Vvelocity"][rnd].tobytes() == \
                one["Vvelocity"][rnd][lo:hi].tobytes()


def test_per_coordinate_lr_is_sliced_to_the_window(runs):
    one = runs["vector_lr"]
    assert one["weights"][-1].tobytes() != runs["plain"]["weights"][-1].tobytes()
    for o in runs[("1x3", "vector_lr")]:
        lo, hi = dense_window(D, 3, o["model"][0])
        for rnd in range(3):
            assert o["weights"][rnd].tobytes() == \
                one["weights"][rnd].tobytes()
            assert o["Vvelocity"][rnd].tobytes() == \
                one["Vvelocity"][rnd][lo:hi].tobytes()

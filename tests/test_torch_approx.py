"""``--approx_topk`` on the port, against the JAX package on the CPU.

The reference selects with ``lax.approx_max_k`` at ``--approx_recall``;
on the CPU that returns the exact top-k set, and the port selects the
exact set (the threshold search and take-mask, then ``compact_mask``):
an answer that meets any recall target. So from a given table the
port's recovery names the reference's indices with bit-equal values, at
a flat d just above 2^20 (the padded estimates, the reference's tail
guard and its scatter-ADD) and at a small d. The port returns the
indices in ascending order, the reference by magnitude: sets are
compared. The sketch server step under the flag (the index route:
``prefer_threshold_unsketch`` is false) matches the reference's, and so
do small ``--approx_topk`` sketch and local_topk trainer runs from the
reference's initial weights: bytes and supports equal, losses within
rtol 1e-5. Data are Gaussian, so no two estimates tie at the k-th.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.config import parse_args as jax_parse_args
from commefficient_tpu.core.server import ServerState as JaxState
from commefficient_tpu.core.server import server_update as jax_update
from commefficient_tpu.ops.sketch import CountSketch as JaxSketch
from commefficient_tpu.runtime import fed_model as jax_fed_model
from commefficient_tpu.train import cv_train as jax_cv_train
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.core.server import ServerState, server_update
from commefficient_tpu_torch.ops.sketch import CountSketch
from commefficient_tpu_torch.runtime import fed_model
from commefficient_tpu_torch.train import cv_train

# (d, c, r, k): past the 2^20 gate with a padded tail, and a small d
GEOMS = [(2 ** 20 + 4099, 65_536, 5, 5000), (5000, 500, 5, 50)]


def _table(r, c, seed):
    return (np.random.RandomState(seed).randn(r, c) * 1e-3).astype(
        np.float32)


@pytest.mark.parametrize("d,c,r,k", GEOMS)
def test_unsketch_selects_the_reference_set_bit_exact(d, c, r, k):
    table = _table(r, c, d % 977)
    js = JaxSketch(d=d, c=c, r=r, seed=5, backend="xla", approx_topk=True,
                   approx_recall=0.5)
    ts = CountSketch(d=d, c=c, r=r, seed=5, approx_topk=True,
                     approx_recall=0.5)
    jdense, jidx, jvals = (np.asarray(x) for x in
                           js.unsketch(jnp.asarray(table), k, True))
    tdense, tidx, tvals = ts.unsketch(torch.from_numpy(table), k,
                                      with_support=True)
    tidx, tvals = tidx.numpy(), tvals.numpy()
    assert len(np.unique(jidx)) == k and (jidx < d).all()
    np.testing.assert_array_equal(np.sort(tidx), np.sort(jidx))
    np.testing.assert_array_equal(tvals[np.argsort(tidx)],
                                  jvals[np.argsort(jidx)])
    np.testing.assert_array_equal(tdense.numpy(), jdense)
    # the exact route gives the same set and values (the approx route
    # scatters them into zeros)
    exact = CountSketch(d=d, c=c, r=r, seed=5).unsketch(
        torch.from_numpy(table), k)
    np.testing.assert_array_equal(exact.numpy(), tdense.numpy())
    # the support-only form: the same indices, no dense vector
    none, sidx, svals = ts.unsketch(torch.from_numpy(table), k,
                                    with_support=True, with_dense=False)
    assert none is None
    np.testing.assert_array_equal(sidx.numpy(), tidx)
    np.testing.assert_array_equal(svals.numpy(), tvals)


@pytest.mark.parametrize("d,c,r,k", GEOMS)
def test_approx_recovery_takes_the_index_route(d, c, r, k):
    js = JaxSketch(d=d, c=c, r=r, backend="xla", approx_topk=True)
    ts = CountSketch(d=d, c=c, r=r, approx_topk=True)
    assert ts.prefer_threshold_unsketch(k) == js.prefer_threshold_unsketch(k)
    assert not ts.prefer_threshold_unsketch(k)


def _server(d, c, r, k, mode, seed):
    rng = np.random.RandomState(seed)
    shape = (r, c) if mode == "sketch" else (d,)
    agg, vel, err = ((rng.randn(*shape) * 1e-3).astype(np.float32)
                     for _ in range(3))
    kw = dict(mode=mode, error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9, k=k, num_rows=r, num_cols=c, seed=5,
              grad_size=d, approx_topk=True, approx_recall=0.9)
    sketch = mode == "sketch"
    jres = jax_update(JaxConfig(**kw), jnp.asarray(agg),
                      JaxState(jnp.asarray(vel), jnp.asarray(err)),
                      jnp.float32(0.1),
                      JaxSketch(d=d, c=c, r=r, seed=5, backend="xla",
                                approx_topk=True, approx_recall=0.9)
                      if sketch else None)
    tres = server_update(Config(device="cpu", **kw), torch.from_numpy(agg),
                         ServerState(torch.from_numpy(vel.copy()),
                                     torch.from_numpy(err.copy())),
                         torch.tensor(0.1, dtype=torch.float32),
                         CountSketch(d=d, c=c, r=r, seed=5, approx_topk=True,
                                     approx_recall=0.9)
                         if sketch else None)
    return jres, tres


@pytest.mark.parametrize("d,c,r,k", GEOMS)
@pytest.mark.parametrize("mode", ["sketch", "true_topk"])
def test_server_step_matches_the_reference(d, c, r, k, mode):
    jres, tres = _server(d, c, r, k, mode, d % 991)
    jupd = np.asarray(jres.weight_update)
    tupd = tres.weight_update.numpy()
    np.testing.assert_allclose(tupd, jupd, rtol=1e-5, atol=1e-6)
    assert (tupd != 0).sum() == (jupd != 0).sum() == k
    # the index route's support: the same (index, lr-scaled value) pairs
    jidx, jv = (np.asarray(x) for x in jres.support)
    tidx, tv = (t.numpy() for t in tres.support)
    np.testing.assert_array_equal(np.sort(tidx), np.sort(jidx))
    np.testing.assert_allclose(tv[np.argsort(tidx)], jv[np.argsort(jidx)],
                               rtol=1e-5, atol=1e-6)
    for name in ("Vvelocity", "Verror"):
        jv_ = np.asarray(getattr(jres.state, name))
        tv_ = getattr(tres.state, name).numpy()
        np.testing.assert_array_equal(tv_ == 0, jv_ == 0)
        np.testing.assert_allclose(tv_, jv_, rtol=1e-5, atol=1e-6)


ARGV = ["--test", "--dataset_name", "Synthetic", "--num_clients", "10",
        "--num_workers", "2", "--local_batch_size", "4", "--num_epochs",
        "3", "--lr_scale", "0.1", "--pivot_epoch", "1", "--approx_topk",
        "--approx_recall", "0.5"]

MODES = {
    "sketch": ["--mode", "sketch", "--error_type", "virtual",
               "--local_momentum", "0", "--virtual_momentum", "0.9"],
    "local_topk": ["--mode", "local_topk", "--error_type", "local",
                   "--local_momentum", "0.9"],
}


def _recording(monkeypatch, module):
    """Each server update's support, as sorted indices."""
    seen = []
    orig = module.FedModel.note_update

    def note(self, support=None):
        if isinstance(support, dict):
            bits = np.unpackbits(np.asarray(support["bitmap"]))
            seen.append(np.flatnonzero(bits[:self.args.grad_size]))
        elif support is not None:
            idx, vals = (np.asarray(t) for t in support)
            seen.append(np.sort(idx[vals != 0]))
        return orig(self, support)

    monkeypatch.setattr(module.FedModel, "note_update", note)
    return seen


@pytest.mark.parametrize("mode", sorted(MODES))
def test_trainer_round_matches_the_reference(mode, monkeypatch):
    """Three --test rounds of ``--approx_topk`` from the reference
    trainer's initial weights: per-round bytes and supports equal,
    train losses within rtol 1e-5."""
    argv = ARGV + MODES[mode]
    port_build = cv_train.build_model

    def build_model(args, device="cpu"):
        module, _ = port_build(args, device)
        _, params, _ = jax_cv_train.build_model(
            jax_parse_args(default_lr=cv_train.DEFAULT_LR, argv=argv))
        return module, module.from_jax_params(
            jax.tree_util.tree_map(np.asarray, params), device)

    monkeypatch.setattr(cv_train, "build_model", build_model)
    ours_sup = _recording(monkeypatch, fed_model)
    jax_sup = _recording(monkeypatch, jax_fed_model)
    results = cv_train.main(["--device", "cpu"] + argv)
    jax_results = jax_cv_train.main(argv)
    assert len(results) == len(jax_results) == 3
    for row, jrow in zip(results, jax_results):
        assert row["up (MiB)"] == jrow["up (MiB)"] > 0
        assert row["down (MiB)"] == jrow["down (MiB)"]
        np.testing.assert_allclose(row["train_loss"], jrow["train_loss"],
                                   rtol=1e-5)
    assert len(ours_sup) == len(jax_sup) == 3
    for a, b in zip(ours_sup, jax_sup):
        np.testing.assert_array_equal(a, b)
    assert sum(len(s) for s in ours_sup) > 0

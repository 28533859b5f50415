"""The host client store's round (``--clientstore host``) on the CPU.

The points of ``tests/test_torch_modes.py``'s mode lattice (every mode,
local momentum and error, ``--topk_down``, microbatches, clips, fedavg,
dead slots and ragged batches), three rounds each of the linear loss
through ``FedModel``/``FedOptimizer``:

- the port's host store against the port's device placement: every
  round's weights, metrics and bytes, and at the end every client's
  state rows, bit for bit. The store's budget holds two rows, so rows
  spill, and the prefetch follows a lookahead of the rounds;
- the port's host store against the JAX package's host-store round
  (its ``FedModel`` under ``clientstore="host"``): weights and rows
  within the lattice's rtol 1e-5 / atol 1e-6, the bytes and each
  round's selected set (the coordinates the update changed) equal.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.runtime.fed_model import FedOptimizer as JaxFedOpt
from commefficient_tpu_torch.clientstore import state_row_bytes
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.runtime.fed_model import FedModel, FedOptimizer

from test_modes import linear_loss, make_cfg
from test_torch_modes import (ATOL, B, CASES, LR, RTOL, make_rounds,
                              torch_linear_loss)


def _port_cfg(kw, **extra):
    base = vars(make_cfg(**kw))
    base.update(extra)
    fields = {f.name for f in dataclasses.fields(Config)}
    return Config(device="cpu", **{k: v for k, v in base.items()
                                   if k in fields and k != "device"})


def _feed(model, ids_of_rounds):
    """The lookahead, read while round ``model.round_index`` is being
    dispatched: the next round's ids."""
    def peek():
        nxt = model.round_index + 1
        return ids_of_rounds[nxt] if nxt < len(ids_of_rounds) else None
    model.attach_participant_feed(peek)


def run_port(kw, d, w0, rounds, num_clients, store):
    cfg = _port_cfg(kw, num_clients=num_clients, clientstore=store)
    if store == "host":
        cfg.grad_size = d
        cfg.clientstore_bytes = 2 * state_row_bytes(cfg)
    model = FedModel(None, torch.from_numpy(w0.copy()),
                     lambda p, b, a: torch_linear_loss(p, b), cfg,
                     padded_batch_size=B)
    opt = FedOptimizer([{"lr": LR}], cfg, model=model)
    _feed(model, [ids for ids, _ in rounds])
    out = []
    for ids, batch in rounds:
        met = model({"client_ids": ids, **batch})
        opt.step()
        out.append((model.ps_weights.numpy().copy(),
                    [np.asarray(m) for m in met],
                    model.last_updated.copy()))
    return out, model


def run_jax_host(kw, d, w0, rounds, num_clients):
    cfg = dataclasses.replace(make_cfg(**kw), num_clients=num_clients,
                              clientstore="host")
    cfg.grad_size = d
    from commefficient_tpu.clientstore import \
        state_row_bytes as jax_row_bytes
    cfg.clientstore_bytes = 2 * jax_row_bytes(cfg)
    model = JaxFedModel(None, {"p": jnp.asarray(w0)},
                        lambda p, b, a: linear_loss(p["p"], b), cfg,
                        padded_batch_size=B,
                        mesh=make_mesh([jax.devices()[0]]))
    opt = JaxFedOpt([{"lr": LR}], cfg, model=model)
    _feed(model, [ids for ids, _ in rounds])
    out = []
    for ids, batch in rounds:
        met = model({"client_ids": ids,
                     **{k: jnp.asarray(v) for k, v in batch.items()}})
        opt.step()
        out.append((np.asarray(model.ps_weights),
                    [np.asarray(m) for m in met],
                    np.asarray(model.last_updated).copy()))
    return out, model


def _device_rows(model):
    cs = model.client_states
    return {name: getattr(cs, name)[:model.num_clients].numpy()
            for name in ("velocities", "errors", "weights")
            if getattr(cs, name) is not None}


def _store_rows(model):
    rows, _ = model.client_store.gather(
        np.arange(model.num_clients, dtype=np.int64))
    return {k: np.array(v) for k, v in rows.items()}


def _case(name, kw, W):
    seed = sum(map(ord, name))
    return seed, dict(kw, num_workers=W, seed=seed % 1000)


@pytest.mark.parametrize("name,kw,d,W,num_clients,dead", CASES,
                         ids=[c[0] for c in CASES])
def test_host_store_round_equals_device_round(name, kw, d, W, num_clients,
                                              dead):
    seed, kw = _case(name, kw, W)
    rounds = make_rounds(seed, d, W, num_clients, dead)
    w0 = (np.random.RandomState(seed + 1).randn(d) * 0.5).astype(np.float32)
    dev, md = run_port(kw, d, w0, rounds, num_clients, "device")
    host, mh = run_port(kw, d, w0, rounds, num_clients, "host")
    assert md.client_store is None and mh.clientstore == "host"
    for r, ((dps, dmet, dlu), (hps, hmet, hlu)) in enumerate(
            zip(dev, host)):
        np.testing.assert_array_equal(hps, dps, err_msg=f"round {r}")
        for a, b in zip(hmet, dmet):
            np.testing.assert_array_equal(a, b, err_msg=f"round {r}")
        np.testing.assert_array_equal(hlu, dlu, err_msg=f"round {r}")
    rows = _device_rows(md)
    assert set(rows) == set(mh.client_store.field_names)
    if rows:
        store_rows = _store_rows(mh)
        for field, want in rows.items():
            np.testing.assert_array_equal(store_rows[field], want,
                                          err_msg=field)
        # rows went through the spill tier, and the lookahead hit
        assert mh.client_store.stats["evictions"] > 0
        assert mh._prefetcher.hits == len(rounds) - 1
        assert len(mh.store_timings) == len(rounds)
    mh.finalize()
    assert mh.client_store is None and mh._prefetcher is None


@pytest.mark.parametrize("name,kw,d,W,num_clients,dead", CASES,
                         ids=[c[0] for c in CASES])
def test_host_store_round_matches_jax_host_store(name, kw, d, W,
                                                 num_clients, dead):
    seed, kw = _case(name, kw, W)
    rounds = make_rounds(seed, d, W, num_clients, dead)
    w0 = (np.random.RandomState(seed + 1).randn(d) * 0.5).astype(np.float32)
    want, jm = run_jax_host(kw, d, w0, rounds, num_clients)
    got, mh = run_port(kw, d, w0, rounds, num_clients, "host")
    for r, ((tps, tmet, tlu), (jps, jmet, jlu)) in enumerate(
            zip(got, want)):
        msg = f"{name}, round {r}"
        np.testing.assert_allclose(tps, jps, rtol=RTOL, atol=ATOL,
                                   err_msg=msg)
        np.testing.assert_allclose(tmet[0], jmet[0], rtol=RTOL, atol=ATOL,
                                   err_msg=msg)
        # the bytes, and the coordinates each update changed
        np.testing.assert_array_equal(tmet[-1], jmet[-1], err_msg=msg)
        np.testing.assert_array_equal(tmet[-2], jmet[-2], err_msg=msg)
        np.testing.assert_array_equal(tlu, jlu, err_msg=msg)
    assert mh.client_store.field_names == jm.client_store.field_names
    if mh.client_store.field_names:
        ours, theirs = _store_rows(mh), _store_rows(jm)
        for field in ours:
            np.testing.assert_allclose(ours[field], theirs[field],
                                       rtol=RTOL, atol=ATOL, err_msg=field)
        # the gather count depends on whether the prefetch thread read a
        # row before or after its write-back (then take patches it)
        ours, theirs = (dict(m.client_store.stats) for m in (mh, jm))
        del ours["gathers"], theirs["gathers"]
        assert ours == theirs
    mh.finalize()
    jm.finalize()


def test_host_store_refuses_pipelined_rounds():
    kw = dict(mode="local_topk", error_type="local", local_momentum=0.9,
              k=2, num_workers=2)
    cfg = _port_cfg(kw, num_clients=4, clientstore="host",
                    pipeline_depth=2)
    with pytest.raises(ValueError, match="pipeline_depth"):
        FedModel(None, torch.zeros(5), lambda p, b, a: None, cfg)

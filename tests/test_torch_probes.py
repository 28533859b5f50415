"""The schema-v2 probes of the port's round against the JAX round's, on
the CPU.

Every mode's points of ``tests/test_torch_modes.py`` (fused, per-client
and the sketch's late and clipped paths), plus the fused sketch round,
``--client_chunk``'s chunked late sketch, and the three robust folds:
each runs 3 rounds of ``test_modes.linear_loss`` through the JAX
``build_client_round(probes=True, probe_recovery=True)`` and
``build_server_round(probes=True)`` (jitted) and through the port's.
The merged client and server probe dicts have the same keys, and their
values (``recovery_error`` and ``fold_rejection_rate`` included) agree
at rtol 1e-5 / atol 1e-6; each round's selected set is equal. A round
built with the cheap probes only computes the plain round's numbers bit
for bit and adds nothing else; a round built without them carries no
probes.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.core.rounds import ClientStates as JaxStates
from commefficient_tpu.core.rounds import _state_ids as jax_state_ids
from commefficient_tpu.core.rounds import build_client_round as jax_client
from commefficient_tpu.core.rounds import build_server_round as jax_server
from commefficient_tpu.core.server import ServerState as JaxServerState
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.core.rounds import (ClientStates, _dead_row,
                                                 _state_ids,
                                                 build_client_round,
                                                 build_server_round)
from commefficient_tpu_torch.core.server import ServerState

from test_modes import linear_loss, make_cfg
from test_torch_modes import (B, CASES, LR, make_rounds,
                              support_set, torch_linear_loss)

RTOL, ATOL = 1e-5, 1e-6

EXTRA = [
    ("sketch-fused",
     dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
          weight_decay=0.01, k=4, num_rows=5, num_cols=32), 16, 3, 6, 1),
    ("sketch-late-chunked",
     dict(mode="sketch", error_type="virtual", k=4, num_rows=3,
          num_cols=32, microbatch_size=2, client_chunk=2), 16, 3, 6, 0),
    ("true-topk-fused",
     dict(mode="true_topk", error_type="virtual", virtual_momentum=0.9,
          k=5), 33, 2, 4, -1),
    ("robust-median-sketch",
     dict(mode="sketch", error_type="virtual", k=4, num_rows=3,
          num_cols=16, robust_agg="median"), 16, 3, 6, 2),
    ("robust-trimmed",
     dict(mode="uncompressed", robust_agg="trimmed",
          robust_trim_frac=0.25), 16, 4, 8, -1),
    ("robust-clip",
     dict(mode="uncompressed", virtual_momentum=0.9, robust_agg="clip",
          robust_clip_norm=0.5), 16, 3, 6, 1),
]
ALL = CASES + EXTRA


def run_jax(kw, d, w0, rounds, num_clients):
    cfg = dataclasses.replace(make_cfg(**kw), grad_size=d)
    client_round = jax.jit(jax_client(cfg, linear_loss, B, probes=True,
                                      probe_recovery=True))
    server_round = jax.jit(jax_server(cfg, probes=True))
    ps = jnp.asarray(w0)
    cs = JaxStates.init(cfg, num_clients, ps)
    ss = JaxServerState.init(cfg)
    rng = jax.random.PRNGKey(cfg.seed)
    out = []
    for r, (ids, batch) in enumerate(rounds):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        res = client_round(ps, cs, jb, jnp.asarray(ids),
                           jax.random.fold_in(rng, r), jnp.float32(LR))
        cs = res.client_states
        ps, ss, new_vel, _, support, sprobes = server_round(
            ps, ss, res.aggregated, jnp.float32(LR), cs.velocities,
            jax_state_ids(jnp.asarray(ids), jb))
        if new_vel is not None:
            cs = cs._replace(velocities=new_vel)
        probes = {k: float(v) for k, v in res.probes.items()}
        probes.update({k: float(v) for k, v in sprobes.items()})
        out.append((np.asarray(ps), probes, support))
    return out


def port_cfg(kw, d):
    base = make_cfg(**kw)
    fields = {f.name for f in dataclasses.fields(Config)}
    return Config(device="cpu", grad_size=d,
                  **{k: v for k, v in vars(base).items()
                     if k in fields and k not in ("device", "grad_size")})


def run_port(cfg, w0, rounds, num_clients, probes=True, recovery=True):
    client_round = build_client_round(cfg, torch_linear_loss, B,
                                      probes=probes,
                                      probe_recovery=recovery)
    server_round = build_server_round(cfg, probes=probes)
    ps = torch.from_numpy(w0.copy())
    cs = ClientStates.init(cfg, num_clients, ps, "cpu")
    ss = ServerState.init(cfg, "cpu")
    out = []
    for ids, batch in rounds:
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        tids = torch.from_numpy(ids.astype(np.int64))
        res = client_round(ps, tb, cs, tids, LR)
        cs = res.client_states
        sout = server_round(ps, ss, res.aggregated, LR, cs.velocities,
                            _state_ids(tids, tb, _dead_row(cs)))
        ps, ss, vel, _, support = sout[:5]
        cs = cs._replace(velocities=vel)
        pr = None
        if probes:
            pr = {k: float(v) for k, v in res.probes.items()}
            pr.update({k: float(v) for k, v in sout[5].items()})
        else:
            assert res.probes is None and len(sout) == 5
        out.append((ps.numpy().copy(), res.aggregated.numpy().copy(),
                    pr, support, [None if a is None else a.clone()
                                  for a in cs]))
    return out


def _setup(name, kw, d, W, num_clients, dead):
    seed = sum(map(ord, name))
    kw = dict(kw, num_workers=W, seed=seed % 1000)
    rounds = make_rounds(seed, d, W, num_clients, dead)
    w0 = (np.random.RandomState(seed + 1).randn(d) * 0.5).astype(np.float32)
    return kw, rounds, w0


@pytest.mark.parametrize("name,kw,d,W,num_clients,dead", ALL,
                         ids=[c[0] for c in ALL])
def test_probes_match_jax(name, kw, d, W, num_clients, dead):
    kw, rounds, w0 = _setup(name, kw, d, W, num_clients, dead)
    want = run_jax(kw, d, w0, rounds, num_clients)
    cfg = port_cfg(kw, d)
    got = run_port(cfg, w0, rounds, num_clients)
    for r, ((tps, _, tpr, tsup, _), (jps, jpr, jsup)) in enumerate(
            zip(got, want)):
        msg = f"{name}, round {r}"
        assert sorted(tpr) == sorted(jpr), msg
        for key in jpr:
            np.testing.assert_allclose(tpr[key], jpr[key], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{msg}: {key}")
        np.testing.assert_allclose(tps, jps, rtol=RTOL, atol=ATOL,
                                   err_msg=msg)
        if cfg.mode in ("true_topk", "sketch"):
            assert support_set(tsup) == support_set(jsup), msg
    keys = set(got[0][2])
    assert {"agg_norm", "agg_nan", "agg_inf", "update_norm",
            "momentum_norm", "residual_norm"} <= keys
    if cfg.mode == "sketch" and cfg.max_grad_norm is None \
            and cfg.robust_agg == "none":
        assert "recovery_error" in keys
    if cfg.robust_agg != "none":
        assert "fold_rejection_rate" in keys


@pytest.mark.parametrize("name,kw,d,W,num_clients,dead", ALL,
                         ids=[c[0] for c in ALL])
def test_probes_leave_the_round_as_it_was(name, kw, d, W, num_clients,
                                          dead):
    kw, rounds, w0 = _setup(name, kw, d, W, num_clients, dead)
    cfg = port_cfg(kw, d)
    plain = run_port(cfg, w0, rounds, num_clients, probes=False)
    cheap = run_port(cfg, w0, rounds, num_clients, probes=True,
                     recovery=False)
    for (ps, agg, _, _, states), (ps2, agg2, _, _, states2) in zip(plain,
                                                                  cheap):
        assert np.array_equal(ps, ps2) and np.array_equal(agg, agg2)
        for a, b in zip(states, states2):
            assert (a is None and b is None) or torch.equal(a, b)

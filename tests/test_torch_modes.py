"""The mode lattice of the port against the JAX round engine, on the CPU.

A fixed set of points of the lattice, drawn as ``tests/test_fuzz_modes.py``
draws them: every mode, local momentum and local error, ``--topk_down``,
``--microbatch_size`` 1-3, ``--max_grad_norm`` in a dense mode and in
sketch mode, fedavg's local SGD with ``--fedavg_batch_size`` 2 and -1,
1-2 epochs and decay 0.9, dead slots (an all-zero mask) and ragged
batches. Each case runs 3 rounds of ``test_modes.linear_loss`` on seeded
numpy data through the JAX ``build_client_round``/``build_server_round``
(jitted, as ``test_fuzz_modes.run_engine`` does) and through the port's.

Tolerances: the weights after every round, the aggregated quantity and
the final per-client velocity, error and stale-weight rows within rtol
1e-5, atol 1e-6 (the two packages' gradients differ in summation
order); each round's selected set (the coordinates the aggregate or the
server's update touches) exactly.
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
from commefficient_tpu.core.rounds import \
    fused_grad_eligible as jax_fused_eligible
from commefficient_tpu.core.server import ServerState as JaxServerState
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.core.rounds import (ClientStates, _dead_row,
                                                 _state_ids,
                                                 build_client_round,
                                                 build_server_round,
                                                 fused_grad_eligible)
from commefficient_tpu_torch.core.server import ServerState

from test_modes import linear_loss, make_cfg

RTOL, ATOL = 1e-5, 1e-6
B, ROUNDS, LR = 4, 3, 0.05

# (name, config fields, d, W, num_clients, dead slot or -1)
CASES = [
    ("uncompressed-local-momentum-mb2",
     dict(mode="uncompressed", local_momentum=0.9, virtual_momentum=0.9,
          weight_decay=0.01, microbatch_size=2), 16, 3, 6, 1),
    ("uncompressed-clip-mb3",
     dict(mode="uncompressed", max_grad_norm=0.5, microbatch_size=3),
     33, 2, 4, -1),
    ("uncompressed-topk-down-mb1",
     dict(mode="uncompressed", do_topk_down=True, k=3, microbatch_size=1,
          weight_decay=0.01), 5, 2, 4, 0),
    ("true-topk-local-momentum",
     dict(mode="true_topk", error_type="virtual", local_momentum=0.9,
          k=4), 16, 3, 6, 2),
    ("true-topk-topk-down",
     dict(mode="true_topk", error_type="virtual", virtual_momentum=0.9,
          k=8, do_topk_down=True), 33, 2, 4, -1),
    ("local-topk-error-momentum",
     dict(mode="local_topk", error_type="local", local_momentum=0.9,
          k=5), 33, 3, 6, -1),
    ("local-topk-virtual-momentum",
     dict(mode="local_topk", virtual_momentum=0.9, weight_decay=0.01,
          k=3), 16, 2, 4, 1),
    ("local-topk-error-topk-down-mb2",
     dict(mode="local_topk", error_type="local", do_topk_down=True, k=2,
          microbatch_size=2), 5, 3, 6, 0),
    ("sketch-clip",
     dict(mode="sketch", error_type="virtual", max_grad_norm=1.0, k=6,
          num_rows=3, num_cols=16, num_blocks=2), 33, 3, 6, 1),
    ("sketch-late-mb2",
     dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
          weight_decay=0.01, k=4, num_rows=5, num_cols=32,
          microbatch_size=2), 16, 2, 4, -1),
    ("fedavg-b2-two-epochs-decay",
     dict(mode="fedavg", local_batch_size=-1, fedavg_batch_size=2,
          num_fedavg_epochs=2, fedavg_lr_decay=0.9), 16, 3, 6, 2),
    ("fedavg-whole-batch-clip",
     dict(mode="fedavg", local_batch_size=-1, fedavg_batch_size=-1,
          virtual_momentum=0.9, max_grad_norm=0.5, weight_decay=0.01),
     5, 2, 4, 0),
]


def torch_linear_loss(p, batch):
    """``test_modes.linear_loss`` in torch, masked means over the last
    axis (scalars for one client's batch, (W,) for a round's)."""
    pred = batch["x"] @ p
    sq = (pred - batch["y"]) ** 2
    n = torch.clamp(torch.sum(batch["mask"], dim=-1), min=1.0)
    loss = torch.sum(sq * batch["mask"], dim=-1) / n
    return loss, (loss * 0.0 + 1.0,)


def make_rounds(seed, d, W, num_clients, dead):
    """ROUNDS rounds of W distinct clients with 1..B samples each; slot
    ``dead`` holds none in rounds 1 and 2."""
    rs = np.random.RandomState(seed)
    rounds = []
    for r in range(ROUNDS):
        ids = rs.choice(num_clients, W, replace=False).astype(np.int32)
        x = np.zeros((W, B, d), np.float32)
        y = np.zeros((W, B), np.float32)
        mask = np.zeros((W, B), np.float32)
        for i in range(W):
            n = 0 if (i == dead and r > 0) else rs.randint(1, B + 1)
            x[i, :n] = rs.randn(n, d)
            y[i, :n] = rs.randn(n)
            mask[i, :n] = 1.0
        rounds.append((ids, {"x": x, "y": y, "mask": mask}))
    return rounds


def run_jax(kw, d, w0, rounds, num_clients):
    cfg = dataclasses.replace(make_cfg(**kw), grad_size=d)
    client_round = jax.jit(jax_client(cfg, linear_loss, B))
    server_round = jax.jit(jax_server(cfg))
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
        ps, ss, new_vel, _, support = server_round(
            ps, ss, res.aggregated, jnp.float32(LR), cs.velocities,
            jax_state_ids(jnp.asarray(ids), jb))
        if new_vel is not None:
            cs = cs._replace(velocities=new_vel)
        out.append((np.asarray(ps), np.asarray(res.aggregated), support))
    return out, cs


def run_port(kw, d, w0, rounds, num_clients):
    base = make_cfg(**kw)
    fields = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(device="cpu", grad_size=d,
                 **{k: v for k, v in vars(base).items()
                    if k in fields and k not in ("device", "grad_size")})
    client_round = build_client_round(cfg, torch_linear_loss, B)
    server_round = build_server_round(cfg)
    ps = torch.from_numpy(w0.copy())
    cs = ClientStates.init(cfg, num_clients, ps, "cpu")
    ss = ServerState.init(cfg, "cpu")
    out = []
    for ids, batch in rounds:
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        tids = torch.from_numpy(ids.astype(np.int64))
        res = client_round(ps, tb, cs, tids, LR)
        cs = res.client_states
        ps, ss, vel, _, support = server_round(
            ps, ss, res.aggregated, LR, cs.velocities,
            _state_ids(tids, tb, _dead_row(cs)))
        cs = cs._replace(velocities=vel)
        out.append((ps.numpy().copy(), res.aggregated.numpy().copy(),
                    support))
    return out, cs, cfg


def support_set(support):
    """The coordinates an update's support names as changed."""
    if isinstance(support, tuple):
        idx, vals = (np.asarray(a) for a in support)
        return set(idx[vals != 0].tolist())
    return set(np.asarray(support).tolist())


@pytest.mark.parametrize("name,kw,d,W,num_clients,dead", CASES,
                         ids=[c[0] for c in CASES])
def test_mode_matches_jax_engine(name, kw, d, W, num_clients, dead):
    seed = sum(map(ord, name))
    kw = dict(kw, num_workers=W, seed=seed % 1000)
    rounds = make_rounds(seed, d, W, num_clients, dead)
    w0 = (np.random.RandomState(seed + 1).randn(d) * 0.5).astype(np.float32)
    want, jcs = run_jax(kw, d, w0, rounds, num_clients)
    got, tcs, cfg = run_port(kw, d, w0, rounds, num_clients)
    assert fused_grad_eligible(cfg) == jax_fused_eligible(make_cfg(**kw))

    for r, ((tps, tagg, tsup), (jps, jagg, jsup)) in enumerate(
            zip(got, want)):
        msg = f"{name}, round {r}"
        np.testing.assert_allclose(tps, jps, rtol=RTOL, atol=ATOL,
                                   err_msg=msg)
        np.testing.assert_allclose(tagg, jagg, rtol=RTOL, atol=ATOL,
                                   err_msg=msg)
        # the selected set: what the clients sent (local_topk) or what
        # the server's selection recovered (true_topk, sketch)
        assert set(np.flatnonzero(tagg).tolist()) == \
            set(np.flatnonzero(jagg).tolist()), msg
        if cfg.mode in ("true_topk", "sketch"):
            assert support_set(tsup) == support_set(jsup), msg

    for field in ("velocities", "errors", "weights"):
        jrows, trows = getattr(jcs, field), getattr(tcs, field)
        assert (jrows is None) == (trows is None), field
        if trows is not None:
            np.testing.assert_allclose(
                trows[:num_clients].numpy(), np.asarray(jrows),
                rtol=RTOL, atol=ATOL, err_msg=f"{name}: client {field}")


@pytest.mark.parametrize("kw", [
    dict(mode="true_topk", error_type="local"),
    dict(mode="local_topk", error_type="virtual"),
    dict(mode="uncompressed", error_type="local"),
    dict(mode="sketch", error_type="virtual", local_momentum=0.9),
    dict(mode="fedavg", local_batch_size=-1, local_momentum=0.9),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_invalid_lattice_points_are_refused_as_the_reference_does(kw):
    """The lattice's forbidden points raise in both packages (fedavg's
    at parse time, the rest when the runtime is built)."""
    from commefficient_tpu.config import Config as JaxConfig
    for cls in (JaxConfig, lambda **k: Config(device="cpu", **k)):
        with pytest.raises(AssertionError):
            cls(**kw).validate_runtime()

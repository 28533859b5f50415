"""DP in the port (privacy/, core/grad.py, core/server.py,
core/rounds.py) against the JAX package on the CPU.

- ``dp_clip`` bit for bit on gradients whose sum of squares is exact in
  any summation order (integers times a power of two: the two packages
  sum the norm in different orders, so on other inputs the norm may
  differ in its last bit), and within rtol 1e-6 on Gaussian ones; the
  identity inside the cap; ``table_sensitivity`` and
  ``table_noise_std`` exactly;
- the accountant (a copy of the reference's) over a grid of sample
  rates, noise multipliers and step counts, ε within 1e-12 relative,
  its state's JSON round trip, ``steps_to_budget`` and ``rounds_left``;
- the noise streams: the same (seed, round, tag) gives the same bits,
  other rounds and tags other bits, and the table noise's sample std
  within 1% of ``table_noise_std`` (JAX's threefry and torch's Philox
  never agree, so the noise is held by its distribution);
- the legacy ``--do_dp``: at zero noise the worker clip (sketch mode)
  and server mode (uncompressed) against the JAX engine at the mode
  lattice's tolerance; with noise, the round's difference from the
  noiseless round equal to the draw the port's generator replays
  (worker: Σ n_i z_i sqrt(W) / total; server: lr · z in the weights);
- ``FedModel.privacy_epsilon()`` after 3 rounds equal to the
  accountant stepped 3 times, and None without ``--dp``.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.privacy import accountant as jacc
from commefficient_tpu.privacy import mechanism as jmech
from commefficient_tpu_torch import privacy
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.core.rounds import (build_client_round,
                                                 build_server_round)
from commefficient_tpu_torch.core.server import ServerState
from commefficient_tpu_torch.privacy import accountant, mechanism
from commefficient_tpu_torch.runtime.fed_model import FedModel, FedOptimizer
from commefficient_tpu_torch.train import cv_train

from test_modes import make_cfg
from test_torch_modes import make_rounds, run_jax, run_port, torch_linear_loss

RTOL, ATOL = 1e-5, 1e-6


# --- the mechanism ------------------------------------------------------

@pytest.mark.parametrize("d", [7, 100, 4096])
@pytest.mark.parametrize("cap", [0.5, 3.0, 1e6])
def test_dp_clip_matches_jax(d, cap):
    rs = np.random.RandomState(d)
    # integers in [-8, 8] times 2^-4: every partial sum of squares is
    # exact in f32, so the norm is the same in any order
    exact = (rs.randint(-8, 9, d) * 2.0 ** -4).astype(np.float32)
    want = np.asarray(jmech.dp_clip(jnp.asarray(exact), cap))
    got = mechanism.dp_clip(torch.from_numpy(exact), cap).numpy()
    np.testing.assert_array_equal(got, want)
    if cap == 1e6:
        np.testing.assert_array_equal(got, exact)  # inside the cap
    gauss = rs.randn(d).astype(np.float32)
    want = np.asarray(jmech.dp_clip(jnp.asarray(gauss), cap))
    got = mechanism.dp_clip(torch.from_numpy(gauss), cap).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    zero = np.zeros(d, np.float32)
    assert not mechanism.dp_clip(torch.from_numpy(zero), cap).any()


@pytest.mark.parametrize("rows,clip,workers,mult", [
    (5, 1.0, 8, 1.0), (1, 0.7, 3, 0.0), (7, 2.5, 100, 1.3)])
def test_table_noise_std_matches_jax(rows, clip, workers, mult):
    cfg = dict(num_rows=rows, dp_clip=clip, num_workers=workers,
               dp_noise_mult=mult)
    ns = type("Cfg", (), cfg)
    assert mechanism.table_noise_std(ns) == jmech.table_noise_std(ns)
    assert mechanism.table_sensitivity(rows, clip, workers) == \
        jmech.table_sensitivity(rows, clip, workers)


def test_noise_streams_replay_and_table_noise_std():
    gen = mechanism.noise_generator
    tag = mechanism.NOISE_TAG
    a = mechanism.gaussian_noise(gen(21, 3, tag, "cpu"), (5, 1024))
    b = mechanism.gaussian_noise(gen(21, 3, tag, "cpu"), (5, 1024))
    assert torch.equal(a, b)
    for other in (gen(21, 4, tag, "cpu"), gen(22, 3, tag, "cpu"),
                  gen(21, 3, mechanism.WORKER_NOISE_TAG, "cpu")):
        assert not torch.equal(a, mechanism.gaussian_noise(other,
                                                           (5, 1024)))
    cfg = Config(device="cpu", mode="sketch", error_type="virtual",
                 local_momentum=0.0, dp="sketch", dp_clip=1.0,
                 dp_noise_mult=1.0, num_rows=5, num_workers=8)
    std = mechanism.table_noise_std(cfg)
    noisy = mechanism.add_table_noise(torch.zeros(5, 65536),
                                      gen(21, 0, tag, "cpu"), std)
    assert abs(float(noisy.std()) / std - 1.0) < 0.01
    assert len({mechanism.stream_seed(21, r, t) for r in range(50)
                for t in (mechanism.NOISE_TAG, mechanism.WORKER_NOISE_TAG,
                          mechanism.SERVER_NOISE_TAG)}) == 150


# --- the accountant ----------------------------------------------------

GRID = [(q, sigma, steps) for q in (1.0, 0.5, 0.01)
        for sigma in (0.5, 1.0, 4.0) for steps in (1, 10, 1000)]


@pytest.mark.parametrize("q,sigma,steps", GRID)
def test_accountant_epsilon_matches_jax(q, sigma, steps):
    t = accountant.PrivacyAccountant(sigma, q, 1e-5)
    j = jacc.PrivacyAccountant(sigma, q, 1e-5)
    for _ in range(min(steps, 10)):
        t.step()
        j.step()
    eps_t = t.epsilon_after(steps - min(steps, 10))
    eps_j = j.epsilon_after(steps - min(steps, 10))
    assert math.isfinite(eps_t)
    assert abs(eps_t - eps_j) <= 1e-12 * abs(eps_j)
    for a in (2, 17, 256):
        assert accountant.rdp_subsampled_gaussian(q, sigma, a) == \
            jacc.rdp_subsampled_gaussian(q, sigma, a)


def test_accountant_state_round_trip_and_budget():
    t = accountant.PrivacyAccountant(1.1, 0.3, 1e-6)
    for w in (1.0, 0.5, 0.25):
        t.step(weight_scale=w)
    back = accountant.PrivacyAccountant.load_state(
        json.loads(json.dumps(t.state_dict())))
    assert back.state_dict() == t.state_dict()
    assert back.epsilon() == t.epsilon()
    j = jacc.PrivacyAccountant.load_state(t.state_dict())
    assert j.epsilon() == t.epsilon()
    assert t.rounds_left(5.0) == j.rounds_left(5.0)
    assert accountant.steps_to_budget(1.0, 1.0, 1e-5, 8.0) == \
        jacc.steps_to_budget(1.0, 1.0, 1e-5, 8.0)
    assert accountant.eps_from_rdp((2, 3), (math.inf, math.inf), 1e-5) \
        == math.inf
    cfg = Config(device="cpu", mode="sketch", error_type="virtual",
                 local_momentum=0.0, dp="sketch", dp_noise_mult=0.8,
                 dp_delta=1e-6)
    acc = accountant.build_accountant(cfg)
    assert (acc.noise_multiplier, acc.sample_rate, acc.delta) == \
        (0.8, accountant.sample_rate_of(cfg), 1e-6) == (0.8, 1.0, 1e-6)
    assert accountant.build_accountant(Config(device="cpu")) is None


# --- the legacy --do_dp -------------------------------------------------

LEGACY = [
    ("worker-sketch-clip", dict(mode="sketch", error_type="virtual",
                                virtual_momentum=0.9, k=4, num_rows=3,
                                num_cols=16, do_dp=True, l2_norm_clip=0.3),
     16, 3, 6, 1),
    ("worker-uncompressed-clip-mb2",
     dict(mode="uncompressed", do_dp=True, l2_norm_clip=0.2,
          microbatch_size=2, weight_decay=0.01), 16, 2, 4, -1),
    ("server-uncompressed", dict(mode="uncompressed", do_dp=True,
                                 dp_mode="server", l2_norm_clip=0.5,
                                 virtual_momentum=0.9), 16, 3, 6, 0),
    ("fedavg-worker", dict(mode="fedavg", local_batch_size=-1,
                           fedavg_batch_size=2, do_dp=True,
                           l2_norm_clip=0.4), 16, 2, 4, -1),
]


@pytest.mark.parametrize("name,kw,d,W,num_clients,dead", LEGACY,
                         ids=[c[0] for c in LEGACY])
def test_legacy_dp_at_zero_noise_matches_jax(name, kw, d, W, num_clients,
                                              dead):
    seed = sum(map(ord, name))
    kw = dict(kw, num_workers=W, seed=seed % 1000)
    rounds = make_rounds(seed, d, W, num_clients, dead)
    w0 = (np.random.RandomState(seed + 1).randn(d) * 0.5).astype(np.float32)
    want, _ = run_jax(kw, d, w0, rounds, num_clients)
    got, _, _ = run_port(kw, d, w0, rounds, num_clients)
    for r, ((tps, tagg, _), (jps, jagg, _)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(tagg, jagg, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}, round {r}")
        np.testing.assert_allclose(tps, jps, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}, round {r}")


def _port_cfg(d, **kw):
    base = make_cfg(**kw)
    fields = {f.name for f in dataclasses.fields(Config)}
    return Config(device="cpu", grad_size=d,
                  **{k: v for k, v in vars(base).items()
                     if k in fields and k not in ("device", "grad_size")})


def test_worker_noise_is_the_replayed_draw():
    """--do_dp --dp_mode worker: each client's clipped gradient takes
    noise_multiplier · N(0, 1) · sqrt(W) from the round's worker stream;
    the aggregate moves by exactly Σ n_i z_i / total of that draw (the
    dead slot's transmit stays 0)."""
    d, W, mult, r = 16, 3, 0.01, 4
    (ids, batch), = make_rounds(5, d, W, 6, 1)[1:2]
    w0 = torch.from_numpy(np.random.RandomState(6).randn(d).astype(
        np.float32))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tids = torch.from_numpy(ids.astype(np.int64))
    out = {}
    for m in (0.0, mult):
        cfg = _port_cfg(d, mode="uncompressed", num_workers=W, do_dp=True,
                        l2_norm_clip=0.5, noise_multiplier=m)
        res = build_client_round(cfg, torch_linear_loss, 4)(
            w0, tb, None, tids, round_index=r)
        out[m] = res.aggregated
    z = mechanism.gaussian_noise(
        mechanism.noise_generator(cfg.seed, r, mechanism.WORKER_NOISE_TAG,
                                  "cpu"), (W, d), std=mult) * math.sqrt(W)
    n = tb["mask"].sum(dim=1)
    assert n[1] == 0
    want = (z * n[:, None]).sum(dim=0) / n.sum()
    torch.testing.assert_close(out[mult] - out[0.0], want, rtol=1e-4,
                               atol=1e-7)


def test_server_noise_is_the_replayed_draw():
    """--do_dp --dp_mode server: the server's momentum takes
    noise_multiplier · N(0, 1) from the (seed + 1, step) stream, and it
    stays in the momentum buffer."""
    d, mult, lr = 16, 0.01, 0.5
    cfg = _port_cfg(d, mode="uncompressed", do_dp=True, dp_mode="server",
                    noise_multiplier=mult, virtual_momentum=0.9)
    server_round = build_server_round(cfg)
    ps = torch.zeros(d)
    agg = torch.linspace(-1, 1, d)
    gen = mechanism.noise_generator(cfg.seed + 1, 1,
                                    mechanism.SERVER_NOISE_TAG, "cpu")
    new_ps, state, *_ = server_round(ps, ServerState.init(cfg, "cpu"),
                                     agg, lr, noise_gen=gen)
    z = mechanism.gaussian_noise(mechanism.noise_generator(
        cfg.seed + 1, 1, mechanism.SERVER_NOISE_TAG, "cpu"), (d,), std=mult)
    torch.testing.assert_close(state.Vvelocity, agg + z)
    torch.testing.assert_close(new_ps, -(agg + z) * lr)
    with pytest.raises(AssertionError, match="noise generator"):
        server_round(ps, ServerState.init(cfg, "cpu"), agg, lr)


def test_fed_model_charges_the_accountant_once_a_round():
    argv = ["--device", "cpu", "--test", "--dataset_name", "Synthetic",
            "--mode", "sketch", "--error_type", "virtual",
            "--local_momentum", "0", "--num_clients", "10",
            "--num_workers", "2", "--local_batch_size", "4",
            "--num_epochs", "3", "--dp", "sketch", "--dp_noise_mult", "1.5"]
    results = cv_train.main(argv)
    assert len(results) == 3  # --test: one round an epoch
    from commefficient_tpu_torch.runtime import fed_model
    model = fed_model._CURRENT_MODEL
    acc = jacc.PrivacyAccountant(1.5, 1.0, 1e-5)
    for _ in range(3):
        acc.step()
    assert model.privacy_epsilon() == acc.epsilon() > 0
    cfg = model.args.replace(dp="off")
    plain = FedModel(model.module, model.ps_weights,
                     cv_train.make_compute_loss(model.module), cfg)
    assert plain.privacy_epsilon() is None
    FedOptimizer(args=cfg, model=plain)


def test_privacy_package_exports():
    assert privacy.PrivacyAccountant is accountant.PrivacyAccountant
    assert privacy.dp_clip is mechanism.dp_clip

"""The robust folds (``--robust_agg``, core/robust.py) and the chaos
harness's byzantine hook, the port against the JAX package on the CPU.

- ``robust_fold`` on seeded (W, r, c) stacks with dead slots (an
  all-zero mask row), an all-dead round, grouped medians and the
  ``weights`` argument, with and without ``--dp sketch``'s static W·B
  denominator: the median and the trimmed mean exactly (sorting is
  exact and both sum the kept ranks in the same order), the clip fold
  within rtol 1e-6, atol 1e-7 (its per-client norms sum in another
  order);
- the ResNet9 client and server rounds under ``--robust_agg median``
  (and trimmed, and clip with the auto tau) with a sign-flip injector
  on one client (``data/chaos.py``), and under ``--dp sketch
  --dp_noise_mult 0`` (f32, and int8 in two row chunks, where the one
  qdq runs on the aggregated table), 2 rounds against the jitted JAX
  rounds at the mode lattice's tolerance: weights and aggregates within
  rtol 1e-5, atol 1e-6, the selected sets equal;
- the DP and robust flags' checks, with the reference's messages.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.core import robust as jrobust
from commefficient_tpu.core.rounds import ClientStates as JaxStates
from commefficient_tpu.core.rounds import build_client_round as jax_client
from commefficient_tpu.core.rounds import build_server_round as jax_server
from commefficient_tpu.core.server import ServerState as JaxServerState
from commefficient_tpu.data.chaos import ChaosConfig as JaxChaosConfig
from commefficient_tpu.data.chaos import ChaosInjector as JaxInjector
from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu.ops.vec import flatten_params as jax_flatten
from commefficient_tpu.train import cv_train as jax_cv_train
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.core import robust
from commefficient_tpu_torch.core.rounds import (ClientStates,
                                                 build_client_round,
                                                 build_server_round,
                                                 fused_grad_eligible,
                                                 round_plan, sketch_is_late)
from commefficient_tpu_torch.core.server import ServerState
from commefficient_tpu_torch.data.chaos import ChaosConfig, ChaosInjector
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.train import cv_train

FOLD_RTOL, FOLD_ATOL = 1e-6, 1e-7
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def native_cpu_convolutions():
    """PyTorch's native CPU convolutions rather than oneDNN's, whose
    rounding flips ReLUs near zero against XLA's
    (tests/test_torch_cv_round.py)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield

FOLDS = [
    ("median", {}),
    ("median-g2", {"robust_agg": "median", "robust_median_groups": 2}),
    ("median-g4", {"robust_agg": "median", "robust_median_groups": 4}),
    ("trimmed", {"robust_agg": "trimmed", "robust_trim_frac": 0.25}),
    ("trimmed-0.1", {"robust_agg": "trimmed", "robust_trim_frac": 0.1}),
    ("clip-auto", {"robust_agg": "clip"}),
    ("clip-fixed", {"robust_agg": "clip", "robust_clip_norm": 3.0}),
]
DEAD = {"none": [], "one": [2], "all": list(range(8))}


def _cfg(kw, dp):
    cfg = types.SimpleNamespace(robust_agg="median", robust_median_groups=0,
                                robust_trim_frac=0.1, robust_clip_norm=0.0,
                                dp=dp)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _stack(seed, dead, W=8, B=4, r=3, c=512):
    rs = np.random.RandomState(seed)
    mask = (rs.rand(W, B) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    mask[dead] = 0.0
    t = (rs.randn(W, r, c) * mask.sum(1)[:, None, None]).astype(np.float32)
    return t, mask


def _folds(cfg, t, mask, weights=None):
    want, _ = jrobust.robust_fold(
        cfg, jnp.asarray(t), {"mask": jnp.asarray(mask)},
        weights=None if weights is None else jnp.asarray(weights))
    got = robust.robust_fold(
        cfg, torch.from_numpy(t), {"mask": torch.from_numpy(mask)},
        weights=None if weights is None else torch.from_numpy(weights))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("dp", ["off", "sketch"])
@pytest.mark.parametrize("dead", sorted(DEAD))
@pytest.mark.parametrize("name,kw", FOLDS, ids=[f[0] for f in FOLDS])
def test_robust_fold_matches_jax(name, kw, dead, dp):
    cfg = _cfg(kw, dp)
    t, mask = _stack(sum(map(ord, name + dead + dp)), DEAD[dead])
    want, got = _folds(cfg, t, mask)
    assert got.shape == want.shape == t.shape[1:]
    assert np.isfinite(got).all()
    if dead == "all":
        # no alive client: every fold gives zeros, no NaN from inf * 0
        assert not got.any()
    if cfg.robust_agg == "clip":
        np.testing.assert_allclose(got, want, rtol=FOLD_RTOL,
                                   atol=FOLD_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kw", FOLDS, ids=[f[0] for f in FOLDS])
def test_robust_fold_weights_match_jax(name, kw):
    """Weighted folds scale each client's transmit and datapoint count
    before any statistic."""
    cfg = _cfg(kw, "off")
    t, mask = _stack(7, [5])
    weights = np.random.RandomState(8).uniform(0.2, 1.0, 8).astype(
        np.float32)
    want, got = _folds(cfg, t, mask, weights)
    if cfg.robust_agg == "clip":
        np.testing.assert_allclose(got, want, rtol=FOLD_RTOL,
                                   atol=FOLD_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


def test_median_is_the_mean_of_the_two_middle_ranks():
    """An even alive count takes the mean of ranks k/2 - 1 and k/2, not
    torch.median's lower one; dead rows sort past every alive value."""
    vals = torch.tensor([[1.0], [7.0], [3.0], [100.0], [5.0]])
    alive = torch.tensor([True, True, True, False, True])
    assert robust._masked_median(vals, alive).item() == 4.0
    assert torch.median(vals[alive]).item() == 3.0
    assert robust._masked_median(vals, torch.zeros(5, dtype=torch.bool)
                                 ).item() == 0.0


def test_clip_factors_match_jax():
    norms = np.array([0.0, 1e-13, 0.5, 1.0, 2.0, 1e6], np.float32)
    for tau in (1.0, 0.3):
        want = np.asarray(jrobust.clip_factors(jnp.asarray(norms),
                                               jnp.float32(tau)))
        got = robust.clip_factors(torch.from_numpy(norms), tau).numpy()
        np.testing.assert_array_equal(got, want)


# --- the ResNet9 round under a robust fold, one byzantine client -------

CH = {"prep": 2, "layer1": 4, "layer2": 4, "layer3": 8}
W, B, NUM_CLIENTS, LR, ROUNDS = 4, 3, 6, 0.1, 2
BYZANTINE = (1,)


def make_resnet9():
    """The tiny ResNet9 (d = 2 318) in both packages, the JAX weights
    carried into the port, and 2 rounds of seeded batches (one ragged
    client, one dead slot in round 2)."""
    jm = JaxResNet9(num_classes=10, channels=CH)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 3)))["params"]
    flat, unravel = jax_flatten(params)
    tm = ResNet9(num_classes=10, channels=CH)
    w0 = np.asarray(flat)
    assert tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params)
                              ).numpy().tobytes() == w0.tobytes()
    rs = np.random.RandomState(3)
    rounds = []
    for r in range(ROUNDS):
        ids = rs.choice(NUM_CLIENTS, W, replace=False).astype(np.int32)
        ids[1] = BYZANTINE[0]  # the attacker takes part in every round
        mask = np.ones((W, B), np.float32)
        mask[2, 1:] = 0.0
        if r == 1:
            mask[3] = 0.0
        rounds.append((ids, {
            "x": rs.randn(W, B, 32, 32, 3).astype(np.float32),
            "y": rs.randint(0, 10, (W, B)).astype(np.int32),
            "mask": mask}))
    return jm, tm, w0, unravel, rounds


@pytest.fixture(scope="module")
def resnet9():
    return make_resnet9()


def _cfg_kw(**kw):
    base = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
                virtual_momentum=0.9, weight_decay=5e-4, num_workers=W,
                local_batch_size=B, k=40, num_rows=3, num_cols=256,
                num_blocks=1, seed=5, num_clients=NUM_CLIENTS,
                dataset_name="Synthetic")
    base.update(kw)
    return base


def run_jax_rounds(jm, w0, unravel, rounds, kw, transform=None):
    cfg = JaxConfig(**kw)
    cfg.grad_size = w0.size
    loss = jax_cv_train.make_compute_loss(jm)
    client_round = jax.jit(jax_client(
        cfg, None, B, tree_loss=lambda p, b: loss(p, b, cfg),
        unravel=unravel, transmit_transform=transform))
    server_round = jax.jit(jax_server(cfg))
    ps = jnp.asarray(w0)
    cs = JaxStates.init(cfg, NUM_CLIENTS, ps)
    ss = JaxServerState.init(cfg)
    key = jax.random.PRNGKey(cfg.seed)
    out = []
    for r, (ids, batch) in enumerate(rounds):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        res = client_round(ps, cs, jb, jnp.asarray(ids),
                           jax.random.fold_in(key, r), jnp.float32(LR))
        cs = res.client_states
        ps, ss, _, _, support = server_round(ps, ss, res.aggregated,
                                             jnp.float32(LR))
        out.append((np.asarray(ps), np.asarray(res.aggregated)))
    return out


def run_port_rounds(tm, w0, rounds, kw, transform=None):
    cfg = Config(device="cpu", **kw)
    cfg.grad_size = w0.size
    loss = cv_train.make_compute_loss(tm)
    client_round = build_client_round(
        cfg, lambda p, b: loss(p, b, cfg), B, transmit_transform=transform)
    server_round = build_server_round(cfg)
    ps = torch.from_numpy(w0.copy())
    cs = ClientStates.init(cfg, NUM_CLIENTS, ps, "cpu")
    ss = ServerState.init(cfg, "cpu")
    out = []
    for r, (ids, batch) in enumerate(rounds):
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        res = client_round(ps, tb, cs, torch.from_numpy(
            ids.astype(np.int64)), LR, round_index=r)
        cs = res.client_states
        ps, ss, _, _, _ = server_round(ps, ss, res.aggregated, LR)
        out.append((ps.numpy().copy(), res.aggregated.numpy().copy()))
    return out, cfg


def assert_rounds_close(got, want):
    for r, ((tps, tagg), (jps, jagg)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(tagg, jagg, rtol=RTOL, atol=ATOL,
                                   err_msg=f"round {r} aggregate")
        np.testing.assert_allclose(tps, jps, rtol=RTOL, atol=ATOL,
                                   err_msg=f"round {r} weights")
        # the selected set: the coordinates the server's update moved
        prev = got[r - 1][0] if r else None
        jprev = want[r - 1][0] if r else None
        if r:
            assert set(np.flatnonzero(tps != prev).tolist()) == \
                set(np.flatnonzero(jps != jprev).tolist()), f"round {r}"


ROBUST_ROUNDS = [
    ("median", dict(robust_agg="median")),
    ("trimmed", dict(robust_agg="trimmed", robust_trim_frac=0.25)),
    ("clip-auto", dict(robust_agg="clip")),
]


@pytest.mark.parametrize("name,extra", ROBUST_ROUNDS,
                         ids=[c[0] for c in ROBUST_ROUNDS])
def test_resnet9_robust_rounds_with_sign_flip_match_jax(resnet9, name,
                                                        extra):
    jm, tm, w0, unravel, rounds = resnet9
    kw = _cfg_kw(**extra)
    chaos = dict(seed=9, attack="sign_flip", byzantine_ids=BYZANTINE)
    jt = JaxInjector(JaxChaosConfig(**chaos), NUM_CLIENTS)
    tt = ChaosInjector(ChaosConfig(**chaos), NUM_CLIENTS)
    want = run_jax_rounds(jm, w0, unravel, rounds, kw,
                          jt.transmit_transform())
    got, cfg = run_port_rounds(tm, w0, rounds, kw,
                               tt.transmit_transform())
    assert not sketch_is_late(cfg) and not fused_grad_eligible(cfg)
    assert round_plan(cfg)["robust_agg"] == extra["robust_agg"]
    assert_rounds_close(got, want)


DP_ROUNDS = [
    ("f32", dict(dp="sketch", dp_clip=1.0, dp_noise_mult=0.0)),
    ("int8-chunked", dict(dp="sketch", dp_clip=0.05, dp_noise_mult=0.0,
                          sketch_dtype="int8", overlap_depth=2)),
]


@pytest.mark.parametrize("name,extra", DP_ROUNDS,
                         ids=[c[0] for c in DP_ROUNDS])
def test_resnet9_dp_sketch_rounds_at_zero_noise_match_jax(resnet9, name,
                                                          extra):
    """--dp sketch at zero noise: the clip, the fold over the static W·B
    (round 2 has a dead slot), the f32 emit and, at int8, the one qdq
    of the aggregated table."""
    jm, tm, w0, unravel, rounds = resnet9
    kw = _cfg_kw(**extra)
    want = run_jax_rounds(jm, w0, unravel, rounds, kw)
    got, cfg = run_port_rounds(tm, w0, rounds, kw)
    assert sketch_is_late(cfg)
    assert round_plan(cfg)["dp"]["clip"] == extra["dp_clip"]
    assert_rounds_close(got, want)


# --- the flags' checks, word for word ----------------------------------

SKETCH = dict(mode="sketch", error_type="virtual", local_momentum=0.0)
BAD_FLAGS = [
    ("dp-clip", dict(dp_clip=0.0)),
    ("dp-noise", dict(dp_noise_mult=-1.0)),
    ("dp-delta", dict(dp_delta=1.0)),
    ("dp-epsilon", dict(dp_epsilon=-1.0)),
    ("dp-budget-off", dict(dp_epsilon=1.0)),
    ("dp-budget-noiseless", dict(SKETCH, dp="sketch", dp_epsilon=1.0)),
    ("trim-frac", dict(robust_trim_frac=0.5)),
    ("clip-norm", dict(robust_clip_norm=-1.0)),
    ("median-groups", dict(robust_median_groups=-1)),
    ("dp-mode", dict(mode="uncompressed", dp="sketch")),
    ("dp-and-do-dp", dict(SKETCH, dp="sketch", do_dp=True)),
    ("dp-chunk", dict(SKETCH, dp="sketch", client_chunk=2, num_workers=4)),
    ("dp-median", dict(SKETCH, dp="sketch", robust_agg="median")),
    ("dp-auto-clip", dict(SKETCH, dp="sketch", robust_agg="clip")),
    ("robust-chunk", dict(SKETCH, robust_agg="trimmed", client_chunk=2,
                          num_workers=4)),
    ("median-groups-divide", dict(SKETCH, robust_agg="median",
                                  robust_median_groups=3, num_workers=4)),
]


@pytest.mark.parametrize("name,kw", BAD_FLAGS, ids=[c[0] for c in BAD_FLAGS])
def test_flag_checks_match_jax(name, kw):
    """The DP and robust flags' checks refuse what the reference's
    refuse, with its messages (parse-time ``validate``, then
    ``validate_runtime``)."""
    errors = []
    for make in (lambda: JaxConfig(**kw),
                 lambda: Config(device="cpu", **kw)):
        with pytest.raises(AssertionError) as err:
            make().validate_runtime()
        errors.append(str(err.value))
    assert errors[0] == errors[1]

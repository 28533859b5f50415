"""The chaos harness (data/chaos.py) and ``--dropout_prob`` in the port
against the JAX package on the CPU.

- ``ChaosInjector``: the seeded byzantine ids, the correlated dropout
  trace (``drop_slots``), ``poison_batch`` and ``wrap_loader`` exactly
  the reference's; ``transmit_transform``'s sign flip and scale bit for
  bit on the same stack and ids, its noise attack on the byzantine rows
  only, replayed by round (the draw's distribution is held, never its
  bits: JAX's threefry and torch's Philox differ);
- ``--dropout_prob``: the loader's masks exactly the JAX loader's, and a
  numpy replay of ``RandomState(seed).rand(W) < p`` a round;
- the fused round's weight-decay share under dropout bit for bit
  against the JAX round (a zero gradient, so the aggregate is the share
  alone): the whole (wd/W)·p while any client is alive, exactly 0 on a
  round whose clients all dropped.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.core.rounds import ClientStates as JaxStates
from commefficient_tpu.core.rounds import build_client_round as jax_client
from commefficient_tpu.data.chaos import ChaosConfig as JaxChaosConfig
from commefficient_tpu.data.chaos import ChaosInjector as JaxInjector
from commefficient_tpu.data.fed_sampler import FedSampler as JaxSampler
from commefficient_tpu.data.loader import FedLoader as JaxLoader
from commefficient_tpu.data.synthetic import FedSynthetic as JaxSynthetic
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.core.rounds import build_client_round
from commefficient_tpu_torch.data import FedLoader, FedSampler
from commefficient_tpu_torch.data.chaos import ChaosConfig, ChaosInjector
from commefficient_tpu_torch.data.synthetic import FedSynthetic

from test_modes import linear_loss, make_cfg
from test_torch_modes import torch_linear_loss

INJECTORS = [
    ("sign-frac", dict(seed=3, attack="sign_flip", byzantine_frac=0.25,
                       burst_start_prob=0.3, burst_stop_prob=0.4)),
    ("scale-ids", dict(seed=5, attack="scale", byzantine_ids=[4, 1, 4],
                       attack_scale=7.0, burst_start_prob=0.5,
                       burst_drop_frac=0.25)),
    ("label-flip", dict(seed=8, attack="label_flip", byzantine_frac=0.3,
                        num_classes=10)),
    ("noise", dict(seed=11, attack="noise", byzantine_frac=0.2,
                   noise_std=2.0)),
]


@pytest.mark.parametrize("name,kw", INJECTORS, ids=[c[0] for c in INJECTORS])
def test_injector_schedules_match_jax(name, kw):
    ours = ChaosInjector(ChaosConfig(**kw), 20)
    theirs = JaxInjector(JaxChaosConfig(**kw), 20)
    np.testing.assert_array_equal(ours.byzantine, theirs.byzantine)
    assert ours.byzantine.dtype == theirs.byzantine.dtype
    rs = np.random.RandomState(0)
    batches = [{"client_ids": rs.choice(20, 6, replace=False)
                .astype(np.int32),
                "y": rs.randint(0, 10, (6, 4)).astype(np.int32),
                "mask": np.ones((6, 4), np.float32)} for _ in range(25)]
    got = list(ours.wrap(batches))
    want = list(theirs.wrap(batches))
    assert len(ours.wrap(batches)) == 25
    for a, b in zip(got, want):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])
    for _ in range(10):
        a, b = ours.drop_slots(6), theirs.drop_slots(6)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("attack", ["sign_flip", "scale"])
def test_transmit_transform_matches_jax(attack):
    kw = dict(seed=2, attack=attack, byzantine_ids=[1, 3], attack_scale=5.0)
    rs = np.random.RandomState(1)
    t = rs.randn(5, 3, 16).astype(np.float32)
    ids = np.array([3, 0, 1, 4, 2], np.int32)
    mask = np.ones((5, 4), np.float32)
    want = JaxInjector(JaxChaosConfig(**kw), 6).transmit_transform()(
        jnp.asarray(t), {"mask": jnp.asarray(mask)}, jnp.asarray(ids),
        jax.random.PRNGKey(0))
    got = ChaosInjector(ChaosConfig(**kw), 6).transmit_transform()(
        torch.from_numpy(t), {"mask": torch.from_numpy(mask)},
        torch.from_numpy(ids.astype(np.int64)), 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ChaosInjector(ChaosConfig(seed=2, attack="label_flip",
                                     num_classes=3), 6) \
        .transmit_transform() is None


def test_noise_attack_replays_by_round():
    inj = ChaosInjector(ChaosConfig(seed=4, attack="noise",
                                    byzantine_ids=[2], noise_std=3.0), 6)
    fn = inj.transmit_transform()
    t = torch.ones(3, 4096)
    mask = torch.zeros(3, 4)
    mask[:, :2] = 1.0
    ids = torch.tensor([0, 2, 5])
    a = fn(t, {"mask": mask}, ids, 7)
    assert torch.equal(a, fn(t, {"mask": mask}, ids, 7))
    assert not torch.equal(a, fn(t, {"mask": mask}, ids, 8))
    assert torch.equal(a[[0, 2]], t[[0, 2]])
    # sigma * N(0, 1) * the client's 2 datapoints
    assert abs(float(a[1].std()) / 6.0 - 1.0) < 0.05


@pytest.mark.parametrize("p", [0.25, 0.6])
def test_dropout_masks_match_jax_and_numpy_replay(p):
    W, B, seed = 4, 4, 21
    kw = dict(do_iid=False, num_clients=10, seed=seed, per_class=8,
              num_val=8)
    ours = FedSynthetic("", "Synthetic", train=True, **kw)
    theirs = JaxSynthetic("", "Synthetic", train=True, **kw)
    got = list(FedLoader(ours, FedSampler(ours, W, B, seed=seed),
                         dropout_prob=p, dropout_seed=seed))
    want = list(JaxLoader(theirs, JaxSampler(theirs, W, B, seed=seed),
                          dropout_prob=p, dropout_seed=seed))
    assert len(got) == len(want) >= 5
    replay = np.random.RandomState(seed)
    dropped = 0
    for a, b in zip(got, want):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])
        drop = replay.rand(W) < p
        assert not a["mask"][drop].any()
        assert a["mask"][~drop].sum(axis=1).min() > 0
        dropped += drop.sum()
    assert dropped > 0


@pytest.mark.parametrize("dropped", [[], [1], [0, 1, 2]])
def test_fused_weight_decay_share_under_dropout_matches_jax(dropped):
    d, W, B, wd = 16, 3, 4, 0.01
    kw = dict(mode="uncompressed", weight_decay=wd, num_workers=W,
              local_batch_size=B, dropout_prob=0.25)
    jcfg = dataclasses.replace(make_cfg(**kw), grad_size=d)
    fields = {f.name for f in dataclasses.fields(Config)}
    tcfg = Config(device="cpu", grad_size=d,
                  **{k: v for k, v in vars(jcfg).items()
                     if k in fields and k not in ("device", "grad_size")})
    # zero data: the loss has no gradient, so the aggregate is the
    # weight-decay share alone
    mask = np.ones((W, B), np.float32)
    mask[dropped] = 0.0
    batch = {"x": np.zeros((W, B, d), np.float32),
             "y": np.zeros((W, B), np.float32), "mask": mask}
    ids = np.arange(W, dtype=np.int32)
    p = np.random.RandomState(0).randn(d).astype(np.float32)
    res = jax.jit(jax_client(jcfg, linear_loss, B))(
        jnp.asarray(p), JaxStates.init(jcfg, W, jnp.asarray(p)),
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(ids),
        jax.random.PRNGKey(0), jnp.float32(1.0))
    want = np.asarray(res.aggregated)
    got = build_client_round(tcfg, torch_linear_loss, B)(
        torch.from_numpy(p), {k: torch.from_numpy(v)
                              for k, v in batch.items()},
        None, torch.from_numpy(ids.astype(np.int64))).aggregated.numpy()
    np.testing.assert_array_equal(got, want)
    if len(dropped) == W:
        assert not got.any()
    else:
        np.testing.assert_array_equal(
            got, (np.float32(wd / W) * np.float32(1.0)) * p)

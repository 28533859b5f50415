"""GPT-2's robust folds and DP (``--robust_agg``, ``--do_dp``, ``--dp
sketch``) through its per-client round, on the CPU.

A small GPT-2 (n_embd 64, one layer, vocab 2000, d = 182 273, past the
sparse re-sketch gate d > 90·r·k at r = 5, c = 8192, k = 300), W = 3
clients of B = 2 examples, the port on the fused CE's vmap rules (plain
versions here), the JAX package on its chunked CE, the same function:

- ``--robust_agg median`` and the legacy ``--do_dp`` (L2-clip to
  ``--l2_norm_clip``, noise multiplier 0: the port's noise streams never
  match JAX's threefry): a round through both packages'
  FedModel/FedOptimizer at tests/test_torch_gpt2_clients.py's
  tolerances (weights rtol 1e-4 / atol 1e-6, losses rtol 1e-5, both byte
  vectors and the selected set exactly);
- every robust fold (median; trimmed at frac 0.34, one client off each
  tail; clip at the median alive norm): the port's aggregated table
  against the JAX package's ``robust_fold`` of the W client tables the
  JAX median round made (recorded through its ``transmit_transform``
  hook; one JAX GPT-2 round serves the three folds), rtol 1e-4 / atol
  1e-6, the upload bytes equal. A robust fold sketches every client's
  own table, the legacy DP the summed clipped gradients once;
- ``--dp sketch`` (clip, the static W·B denominator, one noise draw):
  the released table is the noiseless one plus the replayed draw of the
  round's noise stream (privacy/mechanism.py), bit for bit, whose std is
  ``table_noise_std`` within 3%; its clip fold at noise 0 is held to
  JAX's on ResNet9 in tests/test_torch_robust.py.

One round a case: the JAX package compiles its GPT-2 round twice (the
first two rounds), ~8 s each on the CPU.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.core.robust import robust_fold as jax_robust_fold
from commefficient_tpu.runtime import fed_model as jax_fed_model
from commefficient_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JaxGPT2
from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.runtime.fed_model import FedOptimizer as JaxFedOpt
from commefficient_tpu.train.gpt2_train import \
    make_compute_loss_train as jax_loss
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
from commefficient_tpu_torch.ops import sketch as tsketch
from commefficient_tpu_torch.privacy.mechanism import (NOISE_TAG,
                                                       gaussian_noise,
                                                       noise_generator,
                                                       table_noise_std)
from commefficient_tpu_torch.runtime.fed_model import FedModel, FedOptimizer
from commefficient_tpu_torch.train.gpt2_train import make_compute_loss_train

GEOM = dict(vocab_size=2000, n_positions=64, n_embd=64, n_layer=1,
            n_head=2)
D, R, C, K = 182_273, 5, 8192, 300
W, B, N, T, NUM_CLIENTS, SEED = 3, 2, 2, 32, 9, 0
FOLDS = {
    "median": dict(robust_agg="median"),
    "trimmed": dict(robust_agg="trimmed", robust_trim_frac=0.34),
    "clip": dict(robust_agg="clip"),
}
DO_DP = dict(do_dp=True, l2_norm_clip=0.5, noise_multiplier=0.0)
DP_SKETCH = dict(dp="sketch", dp_clip=0.5)


def _batch(rng):
    v = GEOM["vocab_size"]
    lab = rng.randint(0, v, (W, B, N, T)).astype(np.int32)
    lab[:, :, :, :5] = -1
    lab[0, 1, :, 20:] = -1
    mask = np.ones((W, B), np.float32)
    mask[1, 1] = 0.0  # a ragged client
    return {"client_ids": rng.choice(NUM_CLIENTS, W, replace=False)
            .astype(np.int32),
            "input_ids": rng.randint(0, v, (W, B, N, T)).astype(np.int32),
            "token_type_ids": rng.randint(v - 3, v, (W, B, N, T))
            .astype(np.int32),
            "lm_labels": lab,
            "mc_token_ids": rng.randint(T - 8, T, (W, B, N))
            .astype(np.int32),
            "mc_labels": rng.randint(0, N, (W, B)).astype(np.int32),
            "mask": mask}


@pytest.fixture(scope="module")
def models():
    jm = JaxGPT2(JaxGPT2Config(**GEOM))
    dummy = jnp.zeros((1, N, 8), jnp.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(SEED), dummy,
                              jnp.zeros((1, N), jnp.int32), dummy)["params"]
    tm = GPT2DoubleHeads(GPT2Config(**GEOM))
    flat = tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    assert flat.numel() == D, flat.numel()
    return jm, params, tm, flat


def _kw(extra):
    return dict(mode="sketch", error_type="virtual", local_momentum=0.0,
                virtual_momentum=0.9, num_workers=W, local_batch_size=B,
                k=K, num_rows=R, num_cols=C, seed=SEED,
                num_clients=NUM_CLIENTS, dataset_name="PERSONA",
                num_candidates=N, **extra)


def _port(models, kw):
    _, _, tm, flat = models
    tcfg = Config(device="cpu", fused_ce="on", **kw)
    model = FedModel(tm, flat, make_compute_loss_train(tm, tcfg, True), tcfg)
    return model, FedOptimizer([{"lr": 0.04}], tcfg)


def _jax_round(models, kw, monkeypatch, record=None):
    """One round of the JAX package's FedModel on ``_batch``; with
    ``record`` its per-client transmit stack is appended there (the
    round's ``transmit_transform`` hook, an identity)."""
    jm, params, _, _ = models
    if record is not None:
        def keep(transmit, batch, client_ids, rng):
            jax.debug.callback(lambda t: record.append(np.asarray(t)),
                               transmit)
            return transmit

        monkeypatch.setattr(jax_fed_model, "build_client_round",
                            functools.partial(
                                jax_fed_model.build_client_round,
                                transmit_transform=keep))
    jcfg = JaxConfig(fused_ce="off", **kw)
    jmodel = JaxFedModel(jm, params, jax_loss(jm, jcfg), jcfg,
                         padded_batch_size=B,
                         mesh=make_mesh([jax.devices()[0]]))
    jopt = JaxFedOpt([{"lr": 0.04}], jcfg)
    batch = _batch(np.random.RandomState(SEED + 2))
    jmet = jmodel(batch)
    aggregated = np.asarray(jmodel.pending_aggregated)
    jopt.step()
    return jcfg, jmodel, jmet, aggregated, batch


def _port_round(models, kw, monkeypatch, batch):
    sketches = []
    orig = tsketch.CountSketch.sketch
    monkeypatch.setattr(tsketch.CountSketch, "sketch", lambda self, g: (
        sketches.append(1), orig(self, g))[1])
    tmodel, topt = _port(models, kw)
    tmet = tmodel(batch)
    aggregated = tmodel.pending_aggregated.numpy().copy()
    topt.step()
    return tmodel, tmet, aggregated, len(sketches)


def _same_round(models, tmodel, tmet, jmodel, jmet):
    np.testing.assert_allclose(tmet[0], jmet[0], rtol=1e-5)
    np.testing.assert_allclose(tmodel.ps_weights.numpy(),
                               np.asarray(jmodel.ps_weights),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(tmet[-1], jmet[-1])
    np.testing.assert_array_equal(tmet[-2], jmet[-2])
    sel = tmodel.last_updated == 1
    assert sel.sum() == K
    np.testing.assert_array_equal(sel, jmodel.last_updated == 1)
    assert np.any(tmodel.ps_weights.numpy() != models[3].numpy())


@pytest.fixture(scope="module")
def jax_median(models):
    """The JAX median round and the W client tables it folded."""
    with pytest.MonkeyPatch.context() as mp:
        tables = []
        out = _jax_round(models, _kw(FOLDS["median"]), mp, tables)
    assert len(tables) == 1 and tables[0].shape == (W, R, C)
    return out + (tables[0],)


@pytest.mark.parametrize("case", sorted(FOLDS))
def test_per_client_robust_and_dp_rounds_match_jax(models, jax_median,
                                                   case, monkeypatch):
    _, jmodel, jmet, jagg, batch, tables = jax_median
    kw = _kw(FOLDS[case])
    tmodel, tmet, agg, sketches = _port_round(models, kw, monkeypatch,
                                              batch)
    # every client sketches its own table
    assert sketches == W
    if case == "median":
        want = jagg
        _same_round(models, tmodel, tmet, jmodel, jmet)
    else:
        jcfg = JaxConfig(fused_ce="off", **kw)
        want = np.asarray(jax.jit(lambda t, m: jax_robust_fold(
            jcfg, t, {"mask": m})[0])(tables, batch["mask"]))
        np.testing.assert_array_equal(tmet[-1], jmet[-1])
    np.testing.assert_allclose(agg, want, rtol=1e-4, atol=1e-6)
    assert not np.allclose(agg, tables.sum(0) / batch["mask"].sum(),
                           rtol=1e-3)


def test_per_client_legacy_dp_round_matches_jax(models, monkeypatch):
    kw = _kw(DO_DP)
    _, jmodel, jmet, jagg, batch = _jax_round(models, kw, monkeypatch)
    tmodel, tmet, agg, sketches = _port_round(models, kw, monkeypatch,
                                              batch)
    # the clipped gradients are summed, then sketched once
    assert sketches == 1
    _same_round(models, tmodel, tmet, jmodel, jmet)
    np.testing.assert_allclose(agg, jagg, rtol=1e-4, atol=1e-6)


def test_dp_sketch_noise_is_the_replayed_draw(models):
    """One round at ``--dp_noise_mult`` 1 against the same round at 0:
    the release is the noiseless table plus round 0's draw of the noise
    stream (seed, 0, NOISE_TAG), bit for bit, of std table_noise_std."""
    batch = _batch(np.random.RandomState(SEED + 3))
    tables = {}
    for mult in (0.0, 1.0):
        kw = _kw(dict(DP_SKETCH, dp_noise_mult=mult))
        model, _ = _port(models, kw)
        model(batch)
        tables[mult] = model.pending_aggregated
    cfg = model.args
    std = table_noise_std(cfg)
    noise = gaussian_noise(noise_generator(cfg.seed, 0, NOISE_TAG, "cpu"),
                           (R, C), std=std)
    assert torch.equal(tables[1.0], tables[0.0] + noise)
    got = float((tables[1.0] - tables[0.0]).std())
    assert abs(got / std - 1) < 0.03
    assert model.privacy_epsilon() > 0

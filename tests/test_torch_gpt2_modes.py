"""GPT-2's other four modes, and its resume, on the CPU.

- ``local_topk`` with local error (the per-client rows in the host client
  store on both sides), ``true_topk`` and ``uncompressed`` with virtual
  momentum (the fused round) and ``fedavg`` (the per-client round's
  local SGD): two rounds through the port's FedModel/FedOptimizer
  against the JAX package's on the same weights, batches and seed, at
  the geometry and tolerances of ``test_torch_gpt2_round.py``: the
  losses within rtol 1e-5, the weights within rtol 1e-4 / atol 1e-6,
  the upload and download bytes equal.
- ``gpt2_train.main --test`` in each of these modes finishes; a
  ``local_topk`` run under the host store, stopped after its first
  epoch's checkpoint and resumed, ends on the weights of the run that
  was never stopped, bit for bit (on the card every compressed save of
  a full-width GPT-2 row is ~0.5 GB, so its resume is held here).
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JaxGPT2
from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.runtime.fed_model import FedOptimizer as JaxFedOpt
from commefficient_tpu.train.gpt2_train import \
    make_compute_loss_train as jax_loss
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
from commefficient_tpu_torch.runtime import checkpoint, fed_model
from commefficient_tpu_torch.runtime.fed_model import FedModel, FedOptimizer
from commefficient_tpu_torch.train import gpt2_train
from commefficient_tpu_torch.train.gpt2_train import make_compute_loss_train
from test_torch_gpt2_round import (GEOM, NUM_CLIENTS, SEED, B, D, K, N, W,
                                   _batch)

MODES = {
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.0, clientstore="host",
                       clientstore_bytes=4 * D),
    "true_topk": dict(mode="true_topk", error_type="virtual",
                      local_momentum=0.0, virtual_momentum=0.9),
    "uncompressed": dict(mode="uncompressed", error_type="none",
                         local_momentum=0.0, virtual_momentum=0.9),
    "fedavg": dict(mode="fedavg", error_type="none", local_momentum=0.0,
                   local_batch_size=-1, fedavg_batch_size=1),
}


@pytest.fixture(scope="module")
def weights():
    jm = JaxGPT2(JaxGPT2Config(**GEOM))
    dummy = jnp.zeros((1, N, 8), jnp.int32)
    params = jm.init(jax.random.PRNGKey(SEED), dummy,
                     jnp.zeros((1, N), jnp.int32), dummy)["params"]
    tm = GPT2DoubleHeads(GPT2Config(**GEOM))
    flat = tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    assert flat.numel() == D
    return jm, params, tm, flat


@pytest.mark.parametrize("mode", sorted(MODES))
def test_two_gpt2_rounds_match_jax(mode, weights):
    jm, params, tm, flat = weights
    kw = dict(dict(num_workers=W, local_batch_size=B, k=K, seed=SEED,
                   num_clients=NUM_CLIENTS, dataset_name="PERSONA",
                   num_candidates=N), **MODES[mode])
    jcfg = JaxConfig(fused_ce="off", **kw)
    tcfg = Config(device="cpu", fused_ce="on", **kw)
    jmodel = JaxFedModel(jm, params, jax_loss(jm, jcfg), jcfg,
                         padded_batch_size=B,
                         mesh=make_mesh([jax.devices()[0]]))
    jopt = JaxFedOpt([{"lr": 1.0}], jcfg)
    tmodel = FedModel(tm, flat.clone(),
                      make_compute_loss_train(tm, tcfg, True), tcfg,
                      padded_batch_size=B)
    topt = FedOptimizer([{"lr": 1.0}], tcfg)
    assert tmodel.clientstore == jmodel.clientstore
    rng = np.random.RandomState(SEED + 2)
    for rnd in range(2):
        batch = _batch(rng)
        for g in jopt.param_groups + topt.param_groups:
            g["lr"] = 0.04
        jmet = jmodel(batch)
        jopt.step()
        tmet = tmodel(batch)
        topt.step()
        msg = f"{mode}, round {rnd}"
        np.testing.assert_allclose(tmet[0], jmet[0], rtol=1e-5,
                                   err_msg=msg)
        np.testing.assert_allclose(tmodel.ps_weights.numpy(),
                                   np.asarray(jmodel.ps_weights),
                                   rtol=1e-4, atol=1e-6, err_msg=msg)
        np.testing.assert_array_equal(tmet[-1], jmet[-1], err_msg=msg)
        np.testing.assert_array_equal(tmet[-2], jmet[-2], err_msg=msg)
    # the rounds moved the weights
    assert not torch.equal(tmodel.ps_weights, flat)
    if mode == "local_topk":
        ours, _ = tmodel.client_store.gather(np.arange(NUM_CLIENTS))
        theirs, _ = jmodel.client_store.gather(np.arange(NUM_CLIENTS))
        np.testing.assert_allclose(ours["errors"], theirs["errors"],
                                   rtol=1e-4, atol=1e-6)
    tmodel.finalize()
    jmodel.finalize()


ARGV = ["--device", "cpu", "--test", "--dataset_name", "PERSONA",
        "--num_workers", "2", "--valid_batch_size", "2", "--seed", "5"]
TRAIN_MODES = {
    "local_topk": ["--mode", "local_topk", "--error_type", "local",
                   "--local_momentum", "0", "--local_batch_size", "2",
                   "--clientstore", "host", "--clientstore_bytes", "0"],
    "true_topk": ["--mode", "true_topk", "--error_type", "virtual",
                  "--local_momentum", "0", "--virtual_momentum", "0.9",
                  "--local_batch_size", "2"],
    "uncompressed": ["--mode", "uncompressed", "--local_momentum", "0",
                     "--virtual_momentum", "0.9", "--local_batch_size", "2"],
    "fedavg": ["--mode", "fedavg", "--local_momentum", "0",
               "--local_batch_size", "-1"],
}


@pytest.mark.parametrize("mode", sorted(TRAIN_MODES))
def test_gpt2_trainer_runs_every_mode(mode, tmp_path):
    results = gpt2_train.main(ARGV + TRAIN_MODES[mode] + [
        "--num_epochs", "1", "--dataset_dir", str(tmp_path)])
    assert len(results) == 1
    for row in results:
        assert np.isfinite(row["train_loss"]) and np.isfinite(row["val_nll"])
        assert row["up (MiB)"] > 0


def test_gpt2_resume_is_bit_exact(tmp_path):
    """--test runs one round an epoch, so the run stops at an epoch's
    checkpoint (a round-cadence save inside --test's cut epoch would
    resume into rounds the uncut run never took)."""
    argv = ARGV + TRAIN_MODES["local_topk"] + [
        "--schedule_epochs", "3", "--dataset_dir", str(tmp_path / "data")]
    straight = gpt2_train.main(argv + ["--num_epochs", "3"])
    want = fed_model._CURRENT_MODEL.ps_weights.clone()
    ck = ["--checkpoint", "--checkpoint_path", str(tmp_path / "ck")]
    first = gpt2_train.main(argv + ck + ["--num_epochs", "1"])
    meta = checkpoint.validate_checkpoint(str(tmp_path / "ck" /
                                              "ckpt_gpt2.npz"))
    assert meta["epoch"] == 1 and meta["clientstore"]["fields"] == [
        "errors"]
    rest = gpt2_train.main(argv + ck + ["--num_epochs", "3", "--resume"])
    assert torch.equal(fed_model._CURRENT_MODEL.ps_weights, want)
    assert [r["train_loss"] for r in first + rest] == \
        [r["train_loss"] for r in straight]

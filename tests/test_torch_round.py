"""The ported slice as a whole: three chained FetchSGD rounds through
the port's FedModel/FedOptimizer against the JAX package's, on the
same weights, batches and seed, on the CPU.

Half-width ResNet9 (channels 32/64/128/256, d = 1 651 552) with
r = 5, c = 131 072 (m = 13), k = 5000, W = 2, B = 2: the same gates
as the full configuration -- threshold select (d >= 2^20) and the
dense re-sketch (d <= 90*r*k).

Tolerances: ``ps`` after each round within rtol 1e-4 (atol 1e-6: the
convolutions' gradients differ in summation order, ~1e-6 relative,
and coordinates near zero have no relative scale); round 1's selected
set and the upload/download byte totals exactly.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.runtime.fed_model import FedOptimizer as JaxFedOpt
from commefficient_tpu.train.cv_train import make_compute_loss as jax_loss
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.core.rounds import round_plan
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.runtime.fed_model import FedModel, FedOptimizer
from commefficient_tpu_torch.train.cv_train import make_compute_loss

HALF = {"prep": 32, "layer1": 64, "layer2": 128, "layer3": 256}
W, B, NUM_CLIENTS, SEED = 2, 2, 6, 0


def test_three_rounds_match_jax():
    kw = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9, weight_decay=5e-4, num_workers=W,
              local_batch_size=B, k=5000, num_rows=5, num_cols=131_072,
              seed=SEED, num_clients=NUM_CLIENTS, dataset_name="Synthetic")
    jm = JaxResNet9(num_classes=10, channels=HALF)
    params = jm.init(jax.random.PRNGKey(SEED),
                     jnp.zeros((1, 32, 32, 3)))["params"]
    tm = ResNet9(num_classes=10, channels=HALF)
    flat = tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    assert flat.numel() == 1_651_552

    jcfg, tcfg = JaxConfig(**kw), Config(device="cpu", **kw)
    jmodel = JaxFedModel(jm, params, jax_loss(jm), jcfg,
                         padded_batch_size=B,
                         mesh=make_mesh([jax.devices()[0]]))
    jopt = JaxFedOpt([{"lr": 1.0}], jcfg)
    tmodel = FedModel(tm, flat, make_compute_loss(tm), tcfg)
    topt = FedOptimizer([{"lr": 1.0}], tcfg)
    plan = round_plan(tcfg)
    assert plan["fused_grad"] and plan["sketch"]["rot_lanes"] == 0

    rng = np.random.RandomState(SEED + 1)
    for rnd in range(3):
        batch = {"client_ids": rng.choice(NUM_CLIENTS, W, replace=False)
                 .astype(np.int32),
                 "x": rng.randn(W, B, 32, 32, 3).astype(np.float32),
                 "y": rng.randint(0, 10, (W, B)).astype(np.int32),
                 "mask": np.ones((W, B), np.float32)}
        for g in jopt.param_groups + topt.param_groups:
            g["lr"] = 0.1
        jmet = jmodel(batch)
        jopt.step()
        tmet = tmodel(batch)
        topt.step()

        np.testing.assert_allclose(tmet[0], jmet[0], rtol=1e-5)
        np.testing.assert_allclose(tmodel.ps_weights.numpy(),
                                   np.asarray(jmodel.ps_weights),
                                   rtol=1e-4, atol=1e-6)
        # upload and download byte totals
        np.testing.assert_array_equal(tmet[-1], jmet[-1])
        np.testing.assert_array_equal(tmet[-2], jmet[-2])
        if rnd == 0:
            sel = tmodel.last_updated == 1
            assert sel.sum() == 5000
            np.testing.assert_array_equal(sel, jmodel.last_updated == 1)
    assert tmet[-1].sum() == pytest.approx(W * 4 * 5 * 131_072)

"""The GPT-2 slice as a whole: three chained FetchSGD rounds through the
port's FedModel/FedOptimizer against the JAX package's, on the same
weights, batches and seed, on the CPU.

GPT-2 at n_embd 128, 2 layers, 2 heads, vocab 6000, n_positions 64
(d = 1 173 121) with r = 5, c = 65 536, k = 2000; W = 2 clients of
B = 2 examples, N = 2 candidates, T = 32 tokens. These take the full
configuration's gates: threshold select (d >= 2^20) and the sparse
re-sketch (d > 90*r*k = 900 000). The port runs ``--fused_ce on``
(its plain version on the CPU); the JAX package's CPU run takes the
chunked path, the same function.

Tolerances: ``ps`` after each round within rtol 1e-4 (atol 1e-6: the
gradients differ in summation order, and coordinates near zero have
no relative scale); the round's losses within 1e-5 relative; round 1's
selected set and the upload/download byte totals exactly.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np

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
from commefficient_tpu_torch.ops.sketch import CountSketch
from commefficient_tpu_torch.runtime.fed_model import FedModel, FedOptimizer
from commefficient_tpu_torch.train.gpt2_train import make_compute_loss_train

GEOM = dict(vocab_size=6000, n_positions=64, n_embd=128, n_layer=2,
            n_head=2)
W, B, N, T, NUM_CLIENTS, SEED = 2, 2, 2, 32, 6, 0
D, C, R, K = 1_173_121, 65_536, 5, 2000


def _batch(rng):
    v = GEOM["vocab_size"]
    lab = rng.randint(0, v, (W, B, N, T)).astype(np.int32)
    # padded positions, as the loader leaves them
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


def test_three_gpt2_rounds_match_jax():
    kw = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9, num_workers=W,
              local_batch_size=B, k=K, num_rows=R, num_cols=C, seed=SEED,
              num_clients=NUM_CLIENTS, dataset_name="PERSONA",
              num_candidates=N)
    jm = JaxGPT2(JaxGPT2Config(**GEOM))
    dummy = jnp.zeros((1, N, 8), jnp.int32)
    params = jm.init(jax.random.PRNGKey(SEED), dummy,
                     jnp.zeros((1, N), jnp.int32), dummy)["params"]
    tm = GPT2DoubleHeads(GPT2Config(**GEOM))
    flat = tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    assert flat.numel() == D

    jcfg = JaxConfig(fused_ce="off", **kw)
    tcfg = Config(device="cpu", fused_ce="on", **kw)
    sketch = CountSketch(d=D, c=C, r=R)
    assert sketch.prefer_sparse_resketch(K) and D >= 1 << 20
    jmodel = JaxFedModel(jm, params, jax_loss(jm, jcfg), jcfg,
                         padded_batch_size=B,
                         mesh=make_mesh([jax.devices()[0]]))
    jopt = JaxFedOpt([{"lr": 1.0}], jcfg)
    tmodel = FedModel(tm, flat, make_compute_loss_train(tm, tcfg, True),
                      tcfg)
    topt = FedOptimizer([{"lr": 1.0}], tcfg)

    rng = np.random.RandomState(SEED + 1)
    for rnd in range(3):
        batch = _batch(rng)
        for g in jopt.param_groups + topt.param_groups:
            g["lr"] = 0.04
        jmet = jmodel(batch)
        jopt.step()
        tmet = tmodel(batch)
        topt.step()

        np.testing.assert_allclose(tmet[0], jmet[0], rtol=1e-5)
        np.testing.assert_allclose(tmodel.ps_weights.numpy(),
                                   np.asarray(jmodel.ps_weights),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(tmet[-1], jmet[-1])
        np.testing.assert_array_equal(tmet[-2], jmet[-2])
        if rnd == 0:
            sel = tmodel.last_updated == 1
            assert sel.sum() == K
            np.testing.assert_array_equal(sel, jmodel.last_updated == 1)
    assert tmet[-1].sum() == W * 4 * R * C

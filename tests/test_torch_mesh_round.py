"""The port's 1-D mesh round (``--num_devices C``) against the JAX
package's mesh round at the same C, on the ResNet9 cell cut narrow.

Quarter-width ResNet9 (channels 16/32/64/128, d = 413 568) through
``FedModel``/``FedOptimizer`` in both packages, from the same weights,
on the same batches (W = 4 clients x B = 2): the JAX side on
``make_mesh(jax.devices()[:C])`` of its 8-device CPU mesh, the port on
C launched gloo ranks, each running its W/C clients and the round's
crossings (the table's all-reduce, f32 or int8 with C addends of
headroom). Three chained rounds of sketch mode at f32 and on the int8
wire with ``--downlink_encoding delta`` at C = 2 and 4, and of
true_topk and uncompressed at C = 2.

Tolerances (those of tests/test_torch_round.py and
tests/test_torch_quant_round.py for the one-device round): the
clients' losses within rtol 1e-5; the aggregate within rtol 1e-4 (atol
1e-6 x its largest value) at f32, and on the int8 wire within one wire
step (rowmax / (127 // C)) of the JAX table a value, a bucket next to a
rounding boundary landing one step apart; ``ps`` within rtol 1e-4, atol
1e-6 plus, on the int8 wire, what the flipped buckets can move it; the
first round's selected set and every round's upload and download bytes
exactly; every rank's weights the same bits.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_workers as workers
from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.runtime.fed_model import FedOptimizer as JaxFedOpt
from commefficient_tpu.train.cv_train import make_compute_loss as jax_loss
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.parallel.mesh import launch

QUARTER = {"prep": 16, "layer1": 32, "layer2": 64, "layer3": 128}
W, B, NUM_CLIENTS, SEED, LR, ROUNDS = 4, 2, 8, 0, 0.1, 3
SKETCH = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9, weight_decay=5e-4, num_workers=W,
              local_batch_size=B, k=2000, num_rows=5, num_cols=32_768,
              seed=SEED)
CONFIGS = {
    "sketch_f32": SKETCH,
    "sketch_int8": dict(SKETCH, sketch_dtype="int8",
                        downlink_encoding="delta"),
    "true_topk": dict(SKETCH, mode="true_topk", virtual_momentum=0.0),
    "uncompressed": dict(SKETCH, mode="uncompressed", error_type="none"),
}
RUNS = {2: list(CONFIGS), 4: ["sketch_f32", "sketch_int8"]}


def _batches():
    rng = np.random.RandomState(SEED + 1)
    return [{"client_ids": rng.choice(NUM_CLIENTS, W, replace=False)
             .astype(np.int32),
             "x": rng.randn(W, B, 32, 32, 3).astype(np.float32),
             "y": rng.randint(0, 10, (W, B)).astype(np.int32),
             "mask": np.ones((W, B), np.float32)} for _ in range(ROUNDS)]


@pytest.fixture(scope="module")
def setup():
    jm = JaxResNet9(num_classes=10, channels=QUARTER)
    params = jm.init(jax.random.PRNGKey(SEED),
                     jnp.zeros((1, 32, 32, 3)))["params"]
    flat = ResNet9(num_classes=10, channels=QUARTER).from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)).numpy()
    batches = _batches()
    port = {}
    for c, names in RUNS.items():
        outs = launch(c, workers.resnet9_rounds,
                      [dict(CONFIGS[n], num_devices=c) for n in names],
                      flat, QUARTER, batches, NUM_CLIENTS, LR,
                      device_type="cpu")
        for i, name in enumerate(names):
            port[(c, name)] = [o[i] for o in outs]
    return jm, params, batches, port


def _jax_rounds(jm, params, batches, c, kw):
    cfg = JaxConfig(num_clients=NUM_CLIENTS, dataset_name="Synthetic", **kw)
    model = JaxFedModel(jm, params, jax_loss(jm), cfg, padded_batch_size=B,
                        mesh=make_mesh(jax.devices()[:c]))
    opt = JaxFedOpt([{"lr": LR}], cfg)
    out = []
    for b in batches:
        met = model(dict(b))
        agg = np.asarray(model.pending_aggregated)
        opt.step()
        out.append({"agg": agg, "ps": np.asarray(model.ps_weights),
                    "loss": met[0], "down": met[-2], "up": met[-1],
                    "last_updated": model.last_updated.copy()})
    return out


@pytest.mark.parametrize("c,name", [(c, n) for c, names in RUNS.items()
                                    for n in names])
def test_mesh_rounds_match_jax(setup, c, name):
    jm, params, batches, port = setup
    ranks = port[(c, name)]
    want = _jax_rounds(jm, params, batches, c, CONFIGS[name])
    wire = CONFIGS[name].get("sketch_dtype", "f32")
    vel = err = ps_tol = 0.0
    for rnd, (jr, tr) in enumerate(zip(want, ranks[0]["rounds"])):
        for other in ranks[1:]:
            assert other["rounds"][rnd]["ps"].tobytes() == tr["ps"].tobytes()
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-5)
        ja, ta = jr["agg"], tr["agg"]
        f32_tol = 1e-4 * np.abs(ja) + 1e-6 * np.abs(ja).max()
        if wire == "int8":
            step = np.max(np.abs(ja), axis=1, keepdims=True) / (127 // c)
            diff = np.abs(ta - ja)
            assert np.all(diff <= step * (1 + 1e-5) + f32_tol), rnd
            flips = bool(np.any(diff > f32_tol))
            vel = (float(step.max()) if flips else 0.0) + 0.9 * vel
            err += vel
            ps_tol += LR * err
        else:
            assert np.all(np.abs(ta - ja) <= f32_tol), rnd
        np.testing.assert_allclose(tr["ps"], jr["ps"], rtol=1e-4,
                                   atol=1e-6 + ps_tol)
        np.testing.assert_array_equal(tr["up"], jr["up"])
        np.testing.assert_array_equal(tr["down"], jr["down"])
        if rnd == 0:
            np.testing.assert_array_equal(tr["last_updated"] == 1,
                                          jr["last_updated"] == 1)
    assert ranks[0]["state_shape"] == tuple(
        np.asarray(want[0]["agg"]).shape)

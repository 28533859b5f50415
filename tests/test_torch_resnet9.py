"""The port's ResNet9 against the JAX package's, at f32 on the CPU,
with the JAX weights carried over by ``from_jax_params``.

Tolerances (convolutions sum in another order in each framework):
- flat parameter order: exact, leaf by leaf against ravel_pytree;
- logits: rtol 1e-5, atol 1e-5;
- loss: within 1e-6;
- flat gradient: rtol 1e-4, atol 1e-6.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu.train.cv_train import make_compute_loss as jax_loss
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.ops.vec import ravel_order
from commefficient_tpu_torch.train.cv_train import make_compute_loss

CH = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 32}


@pytest.fixture(scope="module")
def pair():
    jm = JaxResNet9(num_classes=10, channels=CH)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))[
        "params"]
    tm = ResNet9(num_classes=10, channels=CH)
    flat = tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.RandomState(1)
    batch = {"x": rng.randn(6, 32, 32, 3).astype(np.float32),
             "y": rng.randint(0, 10, 6).astype(np.int32),
             "mask": np.array([1, 1, 1, 1, 1, 0], np.float32)}
    return jm, params, tm, flat, batch


def test_full_width_size():
    assert ResNet9().num_params == 6_584_000


def test_flat_order_matches_ravel_pytree_leaf_by_leaf(pair):
    jm, params, tm, flat, _ = pair
    jflat, _ = ravel_pytree(params)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    ours = ravel_order(tm.leaf_shapes())
    assert len(leaves) == len(ours)
    for (jpath, leaf), (path, shape) in zip(leaves, ours):
        assert tuple(k.key for k in jpath) == path
        assert tuple(leaf.shape) == tuple(shape)


def test_logits_loss_and_gradient_match(pair):
    jm, params, tm, flat, batch = pair
    jlogits = np.asarray(jm.apply({"params": params},
                                  jnp.asarray(batch["x"])))
    logits = tm(flat, torch.from_numpy(batch["x"])).detach().numpy()
    np.testing.assert_allclose(logits, jlogits, rtol=1e-5, atol=1e-5)

    jcl = jax_loss(jm)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    flat_j, unravel = ravel_pytree(params)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jcl(unravel(p), jbatch, None), has_aux=True)(flat_j)

    cl = make_compute_loss(tm)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    p = flat.clone().requires_grad_(True)
    loss, _ = cl(p, tbatch, None)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-6
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg),
                               rtol=1e-4, atol=1e-6)


def test_per_client_losses_from_one_forward(pair):
    """A (W, B, ...) batch gives per-client masked means equal to
    one client at a time."""
    _, _, tm, flat, batch = pair
    cl = make_compute_loss(tm)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    two = {k: v.reshape((2, 3) + v.shape[1:]) for k, v in tb.items()}
    loss, (acc,) = cl(flat, two, None)
    for w in range(2):
        one = {k: v[w] for k, v in two.items()}
        lw, (aw,) = cl(flat, one, None)
        assert float(lw) == pytest.approx(float(loss[w]), rel=1e-6)
        assert float(aw) == pytest.approx(float(acc[w]), rel=1e-6)


def test_bf16_logits_close_to_f32(pair):
    jm, params, tm, flat, batch = pair
    tb = ResNet9(num_classes=10, channels=CH, dtype=torch.bfloat16)
    x = torch.from_numpy(batch["x"])
    lo = tb(flat, x)
    assert lo.dtype == torch.float32
    ref = tm(flat, x)
    assert float((lo - ref).abs().max()) <= 0.05 * float(ref.abs().max())


def test_batchnorm_not_ported():
    """--batchnorm raised until it was ported; now ResNet9 builds a
    tracking norm after each conv, with the flax tree's leaves (scale
    and bias) and running statistics (mean 0, var 1 at init)."""
    tm = ResNet9(do_batchnorm=True)
    assert tm.tracks_stats
    assert tm.num_params == 6_584_000 + 2 * (64 + 128 * 3 + 256 + 512 * 3)
    state = tm.init_state()
    assert len(state) == 2 * 8
    assert all(float(v.sum()) == (0.0 if path[-1] == "mean" else v.numel())
               for path, v in state.items())

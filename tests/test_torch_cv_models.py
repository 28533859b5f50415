"""The port's other CV models against the JAX package's flax modules,
at f32 on the CPU, with the JAX weights carried over by
``from_jax_params``.

Tolerances:
- parameter trees: the flat order and every leaf shape exactly;
- the loss: rtol 1e-4, atol 1e-5;
- logits and the loss's flat gradient: rtol 1e-4, atol 1e-5 x the
  largest magnitude of the JAX values. The convolutions sum in another
  order in each framework, and ~10 layers compound it to ~3e-6 (logits)
  and ~1e-5 (gradients, batch statistics of 5 samples at 1x1) of that
  scale: 1-6e-5 at scales 5-30, so an entry near 0 has no relative
  scale of its own;
- ``BatchStatNorm`` on a (W, B) batch against the JAX norm vmapped over
  the W clients: outputs and recorded statistics within 1e-6.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.models import fixup_resnet9 as jfix
from commefficient_tpu.models import resnet18 as jr18
from commefficient_tpu.models import resnets as jres
from commefficient_tpu.models.norms import BatchStatNorm as JaxBSN
from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu.ops.vec import param_group_indices as jax_groups
from commefficient_tpu.train import cv_train as jax_cv_train
from commefficient_tpu_torch.models import fixup_resnet9 as tfix
from commefficient_tpu_torch.models import get_model
from commefficient_tpu_torch.models import resnet18 as tr18
from commefficient_tpu_torch.models import resnets as tres
from commefficient_tpu_torch.models.layers import Ctx
from commefficient_tpu_torch.models.norms import BatchStatNorm
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.ops.vec import param_group_indices, ravel_order
from commefficient_tpu_torch.train import cv_train

RTOL, ATOL = 1e-4, 1e-5
SMALL9 = {"prep": 4, "layer1": 8, "layer2": 8, "layer3": 16}


def _family(block, norm, groups=1, width=64, classes=62):
    return (lambda: jres.ResNet(block=getattr(jres, block),
                                layers=(1, 1, 1, 1), num_classes=classes,
                                norm=norm, groups=groups,
                                width_per_group=width),
            lambda: tres.ResNet(block=getattr(tres, block),
                                layers=(1, 1, 1, 1), num_classes=classes,
                                norm=norm, groups=groups,
                                width_per_group=width,
                                sample_shape=(28, 28, 1)),
            (28, 28, 1))


# name -> (flax module, port module, sample shape (H, W, C))
MODELS = {
    "basic_batch": _family("BasicBlock", "batch"),
    "basic_layer": _family("BasicBlock", "layer"),
    "bottleneck_batch": _family("Bottleneck", "batch"),
    "bottleneck_layer": _family("Bottleneck", "layer"),
    "bottleneck_groups": _family("Bottleneck", "batch", groups=2, width=16),
    "fixup_resnet9_test": (
        lambda: jfix.FixupResNet9(**jfix.FixupResNet9.test_config(10)),
        lambda: tfix.FixupResNet9(**tfix.FixupResNet9.test_config(10)),
        (32, 32, 3)),
    "fixup_resnet9_small": (
        lambda: jfix.FixupResNet9(channels=SMALL9),
        lambda: tfix.FixupResNet9(channels=SMALL9), (32, 32, 3)),
    "fixup_resnet18": (
        lambda: jr18.FixupResNet18(num_blocks=(1, 1, 1, 1)),
        lambda: tr18.FixupResNet18(num_blocks=(1, 1, 1, 1)), (32, 32, 3)),
    "fixup_resnet50": (
        lambda: jfix.FixupResNet50(num_classes=10, stage_sizes=(1, 1, 1, 1)),
        lambda: tfix.FixupResNet50(num_classes=10, stage_sizes=(1, 1, 1, 1),
                                   sample_shape=(32, 32, 3)),
        (32, 32, 3)),
    "resnet18": (
        lambda: jr18.ResNet18(num_blocks=(1, 1, 1, 1)),
        lambda: tr18.ResNet18(num_blocks=(1, 1, 1, 1)), (32, 32, 3)),
    "resnet9_batchnorm": (
        lambda: JaxResNet9(channels=SMALL9, do_batchnorm=True),
        lambda: ResNet9(channels=SMALL9, do_batchnorm=True), (32, 32, 3)),
}


@pytest.fixture(autouse=True)
def native_cpu_convolutions():
    """PyTorch's native CPU convolutions rather than oneDNN's. These
    ReLU nets have pre-activations within f32 rounding of zero; oneDNN
    sums in another order than XLA's CPU convolutions, so a few ReLUs
    flip and move gradient entries by a discrete amount (0.013 on a
    Fixup scalar of FixupResNet18), where the native convolutions stay
    within the stated tolerances. On the card the port runs cuDNN."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@functools.lru_cache(maxsize=None)
def _pair(name, seed=0):
    jmake, tmake, shape = MODELS[name]
    jm, tm = jmake(), tmake()
    variables = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1,) + shape))
    params = variables["params"]
    flat = tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    return jm, tm, variables, flat, shape


def _perturbed(variables, seed):
    """The flax init zeroes the Fixup branches' last convs and heads, and
    sets every norm to scale 1 / bias 0: perturb every leaf so that each
    parameter's gradient and each affine term is exercised."""
    leaves, tree = jax.tree_util.tree_flatten(variables["params"])
    rng = np.random.RandomState(seed)
    leaves = [np.asarray(a) + 0.05 * rng.randn(*np.shape(a)).astype(
        np.float32) for a in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_parameter_tree_matches_flax(name):
    jm, tm, variables, flat, _ = _pair(name)
    jflat, _ = ravel_pytree(variables["params"])
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    leaves, _ = jax.tree_util.tree_flatten_with_path(variables["params"])
    ours = ravel_order(tm.leaf_shapes())
    assert [(tuple(k.key for k in p), tuple(a.shape)) for p, a in leaves] \
        == [(p, tuple(s)) for p, s in ours]
    assert tm.num_params == flat.numel()
    jstats = variables.get("batch_stats")
    assert tm.tracks_stats == (jstats is not None)
    if jstats is not None:
        state = tm.init_state()
        want = {p: np.asarray(a) for p, a in ravel_order(
            jax.tree_util.tree_map(np.asarray, jstats))}
        assert set(state) == set(want)
        for p, a in want.items():
            np.testing.assert_array_equal(state[p].numpy(), a)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_loss_and_gradient_match_flax(name):
    """One client's batch of 5 (one padded row): logits, the masked CE
    loss and its flat gradient (the JAX loss at the flax init's
    batch_stats, as ``jax_cv_train.make_compute_loss`` takes them)."""
    jm, tm, variables, _, shape = _pair(name)
    params = _perturbed(variables, 1)
    flat = tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.RandomState(2)
    n_cls = tm.num_classes
    batch = {"x": rng.randn(5, *shape).astype(np.float32),
             "y": rng.randint(0, n_cls, 5).astype(np.int32),
             "mask": np.array([1, 1, 1, 1, 0], np.float32)}
    init_stats = variables.get("batch_stats")
    jloss = jax_cv_train.make_compute_loss(jm, init_stats)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    flat_j, unravel = ravel_pytree(params)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(unravel(p), jbatch, None), has_aux=True))(flat_j)

    tloss = cv_train.make_compute_loss(tm)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    p = flat.clone().requires_grad_(True)
    loss, _ = tloss(p, tbatch, None)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL,
                               atol=ATOL)
    _close(p.grad, jg)

    # the logits of the real rows (the JAX forward with the mask where
    # its loss passes one)
    if init_stats is not None:
        jlogits, _ = jm.apply({"params": params, "batch_stats": init_stats},
                              jbatch["x"], mask=jbatch["mask"],
                              mutable=["batch_stats"])
        tlogits = tm(flat, tbatch["x"], mask=tbatch["mask"][None])
    else:
        jlogits = jm.apply({"params": params}, jbatch["x"])
        tlogits = tm(flat, tbatch["x"])
    _close(tlogits, jlogits)


def _close(ours, theirs):
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(
        ours.detach().numpy(), theirs, rtol=RTOL,
        atol=ATOL * max(1.0, float(np.abs(theirs).max())))


def test_fixup_resnet9_full_width_forward():
    jm, tm = jfix.FixupResNet9(), tfix.FixupResNet9()
    variables = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))
    params = _perturbed(variables, 4)
    flat = tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    assert flat.numel() == tm.num_params == 6_568_673
    x = np.random.RandomState(5).randn(2, 32, 32, 3).astype(np.float32)
    _close(tm(flat, torch.from_numpy(x)),
           jm.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("name,size", [
    ("ResNet101LN", 43_124_350), ("FixupResNet9", 6_568_673),
    ("FixupResNet50", 25_504_026), ("FixupResNet18", 5_200_626),
    ("ResNet18", 5_206_218)])
def test_registry_builds_full_width(name, size):
    """The trainer's registry builds every family at full width with the
    dataset's sample shape (EMNIST 1x28x28 for ResNet101LN, ImageNet
    3x224x224 with 1000 classes for FixupResNet50): d as the flax
    init gives it."""
    kw = {"ResNet101LN": dict(num_classes=62, sample_shape=(28, 28, 1)),
          "FixupResNet50": dict(num_classes=1000,
                                sample_shape=(224, 224, 3))}.get(name, {})
    assert get_model(name)(**kw).num_params == size


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("track", [False, True])
def test_batch_stat_norm_per_client(masked, track):
    """(W, B) = (3, 4) clients in one call against the JAX norm vmapped
    over the clients: each client normalized by its own statistics,
    padded rows out of them where the mask is passed; ``track_stats``
    records the raw mean and the Bessel-corrected variance."""
    W, B, H, Wd, C = 3, 4, 5, 5, 6
    rng = np.random.RandomState(7)
    x = (rng.randn(W, B, H, Wd, C) * 2 + 1).astype(np.float32)
    mask = np.array([[1, 1, 1, 0], [1, 0, 0, 0], [1, 1, 1, 1]], np.float32)
    scale = rng.rand(C).astype(np.float32) + 0.5
    bias = rng.randn(C).astype(np.float32)
    jn = JaxBSN(track_stats=track)
    variables = jn.init(jax.random.PRNGKey(0), jnp.zeros((1, H, Wd, C)))
    variables = dict(variables, params={"scale": scale, "bias": bias})

    def one(xc, mc):
        kw = {"mask": mc} if masked else {}
        if track:
            y, upd = jn.apply(variables, xc, mutable=["batch_stats"], **kw)
            return y, upd["batch_stats"]["mean"], upd["batch_stats"]["var"]
        return jn.apply(variables, xc, **kw), None, None

    jy, jmean, jvar = jax.vmap(one)(jnp.asarray(x), jnp.asarray(mask))
    tn = BatchStatNorm(C, ("site",), track_stats=track)
    record = {}
    ctx = Ctx(groups=W, mask=torch.from_numpy(mask) if masked else None,
              record=record)
    xt = torch.from_numpy(x).reshape(W * B, H, Wd, C).permute(0, 3, 1, 2)
    y = tn({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
           xt, ctx)
    y = y.permute(0, 2, 3, 1).reshape(W, B, H, Wd, C).numpy()
    np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-6, atol=1e-6)
    if track:
        np.testing.assert_allclose(record[("site", "mean")].numpy(),
                                   np.asarray(jmean), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(record[("site", "var")].numpy(),
                                   np.asarray(jvar), rtol=1e-6, atol=1e-6)
    else:
        assert record == {}
    # reducing over all W*B samples at once is another answer
    flat_ctx = Ctx(groups=1, mask=(torch.from_numpy(mask).reshape(1, -1)
                                   if masked else None))
    y_all = tn({"scale": torch.from_numpy(scale),
                "bias": torch.from_numpy(bias)}, xt, flat_ctx)
    y_all = y_all.permute(0, 2, 3, 1).reshape(W, B, H, Wd, C).numpy()
    assert np.abs(y_all - np.asarray(jy)).max() > 1e-2


def test_fixup_param_groups_match_jax():
    """The Fixup LR groups (bias, scale, other) over FixupResNet9's flat
    order: the same index arrays as the JAX package's."""
    jm = jfix.FixupResNet9(**jfix.FixupResNet9.test_config(10))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))[
        "params"]
    want = jax_groups(params, jax_cv_train.fixup_bias_name,
                      jax_cv_train.fixup_scale_name)
    tm = tfix.FixupResNet9(**tfix.FixupResNet9.test_config(10))
    got = param_group_indices(tm.leaf_shapes(), cv_train.fixup_bias_name,
                              cv_train.fixup_scale_name)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert sum(len(g) for g in got) == tm.num_params
    assert len(got[0]) > 0 and len(got[1]) > 0


@pytest.mark.parametrize("argv", [[], ["--lr_scale", "0.3"]])
def test_fixup_resnet50_config_overlay_matches_jax(argv):
    """``FixupResNet50Config`` overlays the same fields onto the parsed
    flags as the JAX package's (explicit flags win) and gives the same
    step schedule."""
    from commefficient_tpu.config import parse_args as jax_parse_args
    from commefficient_tpu.models.configs import \
        get_model_config as jax_config
    from commefficient_tpu_torch.config import parse_args
    from commefficient_tpu_torch.models.configs import get_model_config
    argv = ["--model", "FixupResNet50"] + argv
    ours, theirs = (parse_args(default_lr=cv_train.DEFAULT_LR, argv=argv),
                    jax_parse_args(default_lr=cv_train.DEFAULT_LR,
                                   argv=argv))
    cfg, jcfg = get_model_config("FixupResNet50"), jax_config("FixupResNet50")
    applied = cfg.set_args(ours, vars(parse_args(
        default_lr=cv_train.DEFAULT_LR, argv=[])))
    japplied = jcfg.set_args(theirs, vars(jax_parse_args(
        default_lr=cv_train.DEFAULT_LR, argv=[])))
    assert applied == japplied and "weight_decay" in applied
    for name in ("lr_scale", "weight_decay", "num_epochs"):
        assert getattr(ours, name) == getattr(theirs, name)
    for epoch in (0, 29.5, 30, 61, 95, 100):
        assert cfg.lr_schedule_shape(epoch) == jcfg.lr_schedule_shape(epoch)
    assert get_model_config("ResNet9") is None

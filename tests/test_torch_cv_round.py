"""The image models' federated rounds through the port's
FedModel/FedOptimizer against the JAX package's, on the same weights,
batches and seed, on the CPU; and ``cv_train.main`` against the JAX
trainer on a CIFAR10 fixture.

- FixupResNet9 (channels 8/16/32/32, d = 38 585) in sketch mode with
  the three Fixup LR groups (a per-coordinate LR), on the dense
  re-sketch (k = 400) and on the sparse one (k = 40: d > 90*r*k);
- ResNet9 ``--batchnorm`` on ragged clients, fused (sketch) and per
  client (local_topk, the batched vmap pass): the server's blended
  running statistics and the eval loss, which reads them;
- a batch-statistics ResNet (BasicBlock, 1x28x28, d = 4 931 326) on the
  fused path with W = 3 ragged clients of B = 8, each normalized by its
  own batch: the case that fails if one forward normalizes over all W*B
  samples (checked here too), on the sparse re-sketch (k = 100), for 2
  rounds.

Tolerances: per-client losses, weights and running statistics within
rtol 1e-5, atol 1e-6 after each of 3 rounds; the selected sets (each
coordinate's last update round) and the byte totals exactly. The
batch-statistics ResNet's losses and weights within rtol 1e-4, atol
1e-5: its last stage is 1x1 on 28x28 inputs, so each channel's
statistics run over a client's 8 values, and near-constant channels
amplify the frameworks' f32 rounding (the fused gradient agrees to
4.5e-5 relative L2 at B = 4; losses moved by up to 5e-5, weights by
3e-6); one forward over all W*B samples misses by > 1e-3. The
trainer's losses within 1e-5.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.config import parse_args as jax_parse_args
from commefficient_tpu.models import fixup_resnet9 as jfix
from commefficient_tpu.models import resnets as jres
from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu.ops.vec import param_group_indices as jax_groups
from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.runtime.fed_model import FedOptimizer as JaxFedOpt
from commefficient_tpu.train import cv_train as jax_cv_train
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.data.fixtures import write_cifar
from commefficient_tpu_torch.models import fixup_resnet9 as tfix
from commefficient_tpu_torch.models import resnets as tres
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.ops.vec import ravel_order
from commefficient_tpu_torch.runtime.fed_model import FedModel, FedOptimizer
from commefficient_tpu_torch.train import cv_train

RTOL, ATOL = 1e-5, 1e-6
B, NUM_CLIENTS, LR = 4, 6, 0.1
FIXUP_CH = {"prep": 8, "layer1": 16, "layer2": 32, "layer3": 32}
BN_CH = {"prep": 4, "layer1": 8, "layer2": 8, "layer3": 16}
RAGGED = np.array([[1, 1, 1, 0], [1, 0, 0, 0], [1, 1, 1, 1]], np.float32)


@pytest.fixture(autouse=True)
def native_cpu_convolutions():
    """PyTorch's native CPU convolutions rather than oneDNN's: they
    round as XLA's CPU convolutions do closely enough that no ReLU near
    zero flips between the frameworks (tests/test_torch_cv_models.py)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _perturbed(params, seed):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(a) + 0.05 * rng.randn(*np.shape(a)).astype(np.float32)
        for a in leaves])


def _pair(jm, tm, params, kw, jgroups, tgroups, stats=None):
    """The JAX and the port's FedModel/FedOptimizer on the same
    weights (B = ``kw["local_batch_size"]``)."""
    b = kw["local_batch_size"]
    jcfg, tcfg = JaxConfig(**kw), Config(device="cpu", **kw)
    jkw, tkw = {}, {}
    if stats is not None:
        jkw = dict(stats_fn=jax_cv_train.make_bn_stats_fn(jm, stats),
                   compute_loss_val=jax_cv_train.make_compute_loss_eval(jm),
                   init_model_state=stats)
        tkw = dict(stats_fn=cv_train.make_bn_stats_fn(tm),
                   compute_loss_val=cv_train.make_compute_loss_eval(tm),
                   init_model_state=tm.init_state())
    jmodel = JaxFedModel(jm, params, jax_cv_train.make_compute_loss(jm, stats),
                         jcfg, padded_batch_size=b,
                         mesh=make_mesh([jax.devices()[0]]), **jkw)
    jopt = JaxFedOpt(jgroups, jcfg)
    flat = tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    tmodel = FedModel(tm, flat, cv_train.make_compute_loss(tm), tcfg,
                      padded_batch_size=b, **tkw)
    topt = FedOptimizer(tgroups(tcfg, tm), tcfg)
    return jmodel, jopt, tmodel, topt


def _batch(rng, shape, classes, mask):
    w, b = mask.shape
    return {"client_ids": rng.choice(NUM_CLIENTS, w, replace=False)
            .astype(np.int32),
            "x": rng.randn(w, b, *shape).astype(np.float32),
            "y": rng.randint(0, classes, (w, b)).astype(np.int32),
            "mask": mask}


def _rounds(jmodel, jopt, tmodel, topt, shape, classes, mask, rounds=3,
            check=None, rtol=RTOL, atol=ATOL):
    rng = np.random.RandomState(11)
    bases = [g["lr"] for g in topt.param_groups]
    for rnd in range(rounds):
        batch = _batch(rng, shape, classes, mask)
        for groups in (jopt.param_groups, topt.param_groups):
            for g, base in zip(groups, bases):
                g["lr"] = base * LR
        jmet = jmodel(batch)
        jopt.step()
        tmet = tmodel(batch)
        topt.step()
        np.testing.assert_allclose(tmet[0], jmet[0], rtol=rtol, atol=atol)
        np.testing.assert_allclose(tmodel.ps_weights.numpy(),
                                   np.asarray(jmodel.ps_weights),
                                   rtol=rtol, atol=atol)
        np.testing.assert_array_equal(tmodel.last_updated,
                                      jmodel.last_updated)
        assert (tmodel.last_updated == rnd + 1).sum() > 0
        np.testing.assert_array_equal(tmet[-1], jmet[-1])
        np.testing.assert_array_equal(tmet[-2], jmet[-2])
        if check is not None:
            check(jmodel, tmodel)


def _fixup_groups(params):
    bias, scale, other = jax_groups(params, jax_cv_train.fixup_bias_name,
                                    jax_cv_train.fixup_scale_name)
    return [{"lr": 1.0, "index": other}, {"lr": 0.1, "index": bias},
            {"lr": 0.1, "index": scale}]


@pytest.mark.parametrize("k", [400, 40])
def test_fixup_sketch_rounds_with_lr_groups_match_jax(k):
    jm = jfix.FixupResNet9(channels=FIXUP_CH)
    tm = tfix.FixupResNet9(channels=FIXUP_CH)
    params = _perturbed(jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 32, 3)))["params"], 1)
    kw = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9, num_workers=2, local_batch_size=B, k=k,
              num_rows=5, num_cols=4096, seed=0, num_clients=NUM_CLIENTS,
              dataset_name="CIFAR10", model="FixupResNet9")
    jmodel, jopt, tmodel, topt = _pair(jm, tm, params, kw,
                                       _fixup_groups(params),
                                       cv_train.param_groups_of)
    assert tm.num_params == 38_585
    sketch_sparse = 38_585 > 90 * 5 * k
    assert sketch_sparse == (k == 40)
    assert len(topt.param_groups) == 3
    assert isinstance(topt.get_lr(), torch.Tensor)
    _rounds(jmodel, jopt, tmodel, topt, (32, 32, 3), 10,
            np.ones((2, B), np.float32))


def _state_close(jmodel, tmodel):
    want = dict(ravel_order(jax.tree_util.tree_map(np.asarray,
                                                   jmodel.model_state)))
    assert set(want) == set(tmodel.model_state)
    for path, a in want.items():
        np.testing.assert_allclose(tmodel.model_state[path].numpy(), a,
                                   rtol=RTOL, atol=ATOL)


MODES = {
    "sketch": dict(mode="sketch", error_type="virtual", local_momentum=0.0,
                   virtual_momentum=0.9, k=300, num_rows=5, num_cols=2048),
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, k=300),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_batchnorm_rounds_running_stats_and_eval_match_jax(mode):
    """ResNet9 --batchnorm, W = 3 ragged clients: the fused sketch round
    (one forward over the W clients) and the per-client round (each
    client's pass under vmap); the running statistics the server blends
    each round, then the eval loss of a validation batch normalized by
    them."""
    jm = JaxResNet9(channels=BN_CH, do_batchnorm=True)
    tm = ResNet9(channels=BN_CH, do_batchnorm=True)
    variables = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))
    params, stats = _perturbed(variables["params"], 3), variables[
        "batch_stats"]
    kw = dict(num_workers=3, local_batch_size=B, seed=0,
              num_clients=NUM_CLIENTS, dataset_name="CIFAR10",
              model="ResNet9", do_batchnorm=True, **MODES[mode])
    jmodel, jopt, tmodel, topt = _pair(
        jm, tm, params, kw, [{"lr": 1.0}],
        lambda cfg, m: [{"lr": 1.0}], stats=stats)
    _rounds(jmodel, jopt, tmodel, topt, (32, 32, 3), 10, RAGGED,
            check=_state_close)
    # the statistics moved from their init
    assert float(tmodel.model_state[("ConvBN_0", "BatchStatNorm_0",
                                     "var")].sub(1).abs().max()) > 1e-3

    rng = np.random.RandomState(5)
    val = {"x": rng.randn(2, B, 32, 32, 3).astype(np.float32),
           "y": rng.randint(0, 10, (2, B)).astype(np.int32),
           "mask": np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.float32)}
    jmodel.train(False)
    tmodel.train(False)
    jout, tout = jmodel(val), tmodel(val)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_batch_stat_resnet_fused_rounds_per_client_stats_match_jax():
    b = 8
    mask = np.zeros((3, b), np.float32)
    mask[0, :b - 1] = mask[1, :1] = mask[2] = 1
    jm = jres.ResNet(block=jres.BasicBlock, layers=(1, 1, 1, 1),
                     num_classes=62, norm="batch")
    tm = tres.ResNet(block=tres.BasicBlock, layers=(1, 1, 1, 1),
                     num_classes=62, norm="batch", sample_shape=(28, 28, 1))
    params = _perturbed(jm.init(jax.random.PRNGKey(4),
                                jnp.zeros((1, 28, 28, 1)))["params"], 5)
    kw = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9, num_workers=3, local_batch_size=b,
              k=100, num_rows=5, num_cols=65_536, seed=0,
              num_clients=NUM_CLIENTS, dataset_name="EMNIST",
              model="resnet18")
    jmodel, jopt, tmodel, topt = _pair(jm, tm, params, kw, [{"lr": 1.0}],
                                       lambda cfg, m: [{"lr": 1.0}])
    assert tm.num_params == 4_931_326 > 90 * 5 * 100
    _rounds(jmodel, jopt, tmodel, topt, (28, 28, 1), 62, mask, rounds=2,
            rtol=1e-4, atol=1e-5)

    # one forward normalizing over all W*B samples gives other losses
    batch = _batch(np.random.RandomState(11), (28, 28, 1), 62, mask)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()
          if k != "client_ids"}
    flat = tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    per_client, _ = cv_train.make_compute_loss(tm)(flat, tb, None)
    logits = tm(flat, tb["x"].reshape(-1, 28, 28, 1), groups=1)
    pooled, _ = cv_train._ce_loss_and_acc(logits.reshape(3, b, -1), tb)
    jl, _ = jax.vmap(lambda one: jax_cv_train.make_compute_loss(jm)(
        params, one, None))({k: jnp.asarray(v) for k, v in batch.items()
                             if k != "client_ids"})
    np.testing.assert_allclose(per_client.detach().numpy(), np.asarray(jl),
                               rtol=1e-4, atol=1e-5)
    assert np.abs(pooled.detach().numpy() - np.asarray(jl)).max() > 1e-3


def test_trainer_fixup_mixup_matches_jax(tmp_path, monkeypatch):
    """``cv_train.main --test`` with FixupResNet9 (its LR groups) and
    ``--mixup`` on a CIFAR10 fixture, from the JAX trainer's initial
    weights: two rounds, the per-round losses within 1e-5, the bytes
    equal."""
    argv = ["--test", "--dataset_name", "CIFAR10", "--model", "FixupResNet9",
            "--mixup", "--mixup_alpha", "0.2", "--mode", "sketch",
            "--error_type", "virtual", "--local_momentum", "0",
            "--num_workers", "2", "--local_batch_size", "4",
            "--num_epochs", "2", "--lr_scale", "0.1", "--pivot_epoch", "1"]
    port_dir = write_cifar(str(tmp_path / "port"), per_class=6, seed=1)
    jax_dir = write_cifar(str(tmp_path / "jax"), per_class=6, seed=1)
    port_build = cv_train.build_model

    def build_model(args, device="cpu"):
        module, _ = port_build(args, device)
        _, params, _ = jax_cv_train.build_model(jax_parse_args(
            default_lr=cv_train.DEFAULT_LR,
            argv=argv + ["--dataset_dir", jax_dir]))
        return module, module.from_jax_params(
            jax.tree_util.tree_map(np.asarray, params), device)

    monkeypatch.setattr(cv_train, "build_model", build_model)
    mixed = []
    port_mixup = cv_train.apply_mixup
    monkeypatch.setattr(cv_train, "apply_mixup", lambda *a: mixed.append(1)
                        or port_mixup(*a))
    results = cv_train.main(["--device", "cpu", "--dataset_dir", port_dir]
                            + argv)
    jax_results = jax_cv_train.main(argv + ["--dataset_dir", jax_dir])
    assert len(results) == len(jax_results) == 2 and len(mixed) == 2
    for row, jrow in zip(results, jax_results):
        np.testing.assert_allclose(row["train_loss"], jrow["train_loss"],
                                   rtol=0, atol=1e-5)
        assert row["up (MiB)"] == jrow["up (MiB)"] > 0
        assert row["down (MiB)"] == jrow["down (MiB)"]
        assert np.isfinite(row["test_loss"])


def test_card_smoke_emnist_checks_reject_wrong_results():
    """chip_smoke.py's emnist_path checks pass the right launches,
    branch, d, upload and losses, and raise on each wrong one: a dense
    re-sketch (the server's sketch launch too, and no sparse call), a
    launch missing, another d, another upload, a NaN loss."""
    import chip_smoke as cs
    rounds, w = 4, 8
    model = types.SimpleNamespace(args=types.SimpleNamespace(
        grad_size=cs.EMNIST_D, num_workers=w))
    row = {"up (MiB)": rounds * w * cs.R * cs.C * 4 / 2**20,
           "round_losses": [4.1] * rounds, "test_loss": 4.2}
    counts = cs.sketch_round_launches(rounds)
    assert counts["sketch_kernel"] == counts["take_mask_kernel"] == rounds
    cs.emnist_checks(row, counts, rounds, model, rounds)

    dense = cs.sketch_round_launches(rounds, sketches=2)
    missing = dict(counts, threshold_key_kernel=rounds - 1)
    cases = [
        (row, dense, model, rounds, "launch counts"),
        (row, counts, model, 0, "dense branch"),
        (row, missing, model, rounds, "launch counts"),
        (row, counts, types.SimpleNamespace(args=types.SimpleNamespace(
            grad_size=cs.EMNIST_D - 1, num_workers=w)), rounds, "d = "),
        (dict(row, **{"up (MiB)": row["up (MiB)"] / 2}), counts, model,
         rounds, "up "),
        (dict(row, round_losses=[4.1, float("nan"), 4.0, 4.0]), counts,
         model, rounds, "train losses"),
    ]
    for r, c, m, sparse, msg in cases:
        with pytest.raises(AssertionError, match=msg):
            cs.emnist_checks(r, c, rounds, m, sparse)

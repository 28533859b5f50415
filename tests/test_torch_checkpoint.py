"""The CV trainer's ``--checkpoint`` and ``--finetune`` and the
torch-format export (models/torch_export.py), the port against the JAX
package on the CPU.

- ``cv_state_dict`` key for key and tensor for tensor (bit for bit)
  against the reference's ``cv_state_dict`` on the same flax tree (the
  port's ``FlatModel.to_params_tree``), for every family
  ``supports_torch_export`` names: ResNet9 with and without
  ``--batchnorm`` (its running statistics, and the identity statistics
  and ``num_batches_tracked`` of a batch-statistics-only site),
  FixupResNet9, FixupResNet50, ResNet18, FixupResNet18 and the
  ``resnets.py`` family (BasicBlock with batch norms, Bottleneck with
  LayerNorms); ``cv_load_state_dict`` inverts it;
- the ``.pkl`` that ``--checkpoint`` writes against the reference's
  tree from the same flat vector (``jax.device_get`` of its
  ``unravel``): paths, key order, dtypes, shapes and bits equal, and
  so after a pickle round trip (the pickled bytes themselves differ:
  pickle memoizes each dtype object it meets once, and the
  reference's leaves carry dtype objects of their own where the port's
  share numpy's);
- ``cv_train.main --checkpoint``: the ``.pkl`` leaf for leaf equal to
  ``FedModel.params()``, the ``.pt`` the reference's key set, nothing
  written by a diverged run; ``--finetune`` from it on a CIFAR100
  fixture: every leaf but the head the saved one, the head fresh, the
  reinitialised paths those the reference's ``merge_finetune_params``
  names; ``save_pretrained(torch_format=True)``'s ``state_dict.pt``.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import io
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.models import fixup_resnet9 as jfix
from commefficient_tpu.models import resnet18 as jr18
from commefficient_tpu.models import resnets as jres
from commefficient_tpu.models import torch_export as jexport
from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu.ops.vec import flatten_params as jax_flatten
from commefficient_tpu.train import cv_train as jax_cv_train
from commefficient_tpu_torch.data.fixtures import write_fixture
from commefficient_tpu_torch.models import fixup_resnet9 as tfix
from commefficient_tpu_torch.models import resnet18 as tr18
from commefficient_tpu_torch.models import resnets as tres
from commefficient_tpu_torch.models import torch_export as texport
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.runtime import fed_model
from commefficient_tpu_torch.train import cv_train

CH = {"prep": 2, "layer1": 4, "layer2": 4, "layer3": 8}

# (name, the port's module, the reference's module of the same geometry)
FAMILIES = [
    ("ResNet9", lambda: ResNet9(num_classes=10, channels=CH),
     lambda: JaxResNet9(num_classes=10, channels=CH)),
    ("ResNet9-batchnorm",
     lambda: ResNet9(num_classes=10, channels=CH, do_batchnorm=True),
     lambda: JaxResNet9(num_classes=10, channels=CH, do_batchnorm=True)),
    ("FixupResNet9", lambda: tfix.FixupResNet9(num_classes=10, channels=CH),
     lambda: jfix.FixupResNet9(num_classes=10, channels=CH)),
    ("FixupResNet50",
     lambda: tfix.FixupResNet50(num_classes=7, stage_sizes=(1, 2, 1, 1),
                                sample_shape=(32, 32, 3)),
     lambda: jfix.FixupResNet50(num_classes=7, stage_sizes=(1, 2, 1, 1))),
    ("ResNet18", lambda: tr18.ResNet18(num_classes=10, num_blocks=(1, 2, 1, 1)),
     lambda: jr18.ResNet18(num_classes=10, num_blocks=(1, 2, 1, 1))),
    ("FixupResNet18",
     lambda: tr18.FixupResNet18(num_classes=10, num_blocks=(1, 2, 1, 1)),
     lambda: jr18.FixupResNet18(num_classes=10, num_blocks=(1, 2, 1, 1))),
    ("ResNet-basic-batch",
     lambda: tres.ResNet(tres.BasicBlock, (1, 2, 1, 1), num_classes=62,
                         norm="batch"),
     lambda: jres.ResNet(block=jres.BasicBlock, layers=(1, 2, 1, 1),
                         num_classes=62, norm="batch")),
    ("ResNet-bottleneck-layer",
     lambda: tres.ResNet(tres.Bottleneck, (1, 1, 2, 1), num_classes=62,
                         norm="layer"),
     lambda: jres.ResNet(block=jres.Bottleneck, layers=(1, 1, 2, 1),
                         num_classes=62, norm="layer")),
]


@pytest.mark.parametrize("name,port,ref", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_cv_state_dict_matches_jax(name, port, ref):
    tm, jm = port(), ref()
    assert texport.supports_torch_export(tm)
    assert jexport.supports_torch_export(jm)
    tree = tm.to_params_tree(tm.init_flat(3))
    state = None
    if tm.tracks_stats:
        # moved running statistics, so the export reads them
        state = {k: v + 0.25 for k, v in tm.init_state().items()}
    nested = texport.nest_state(state)
    want = jexport.cv_state_dict(jm, tree, nested)
    got = texport.cv_state_dict(tm, tree, nested)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # every batch-norm site carries torch BatchNorm's buffers; a
    # batch-statistics-only site exports identity statistics
    sites = [k[:-len(".num_batches_tracked")] for k in got
             if k.endswith(".num_batches_tracked")]
    assert bool(sites) == (name in ("ResNet9-batchnorm", "ResNet18",
                                    "ResNet-basic-batch"))
    for site in sites:
        assert got[f"{site}.num_batches_tracked"] == 0
        identity = (not got[f"{site}.running_mean"].any()
                    and (got[f"{site}.running_var"] == 1.0).all())
        assert identity == (state is None), site
    back = texport.cv_load_state_dict(tm, tree, got, nested)
    back_tree = back[0] if nested else back
    for path, leaf in _leaves(tree):
        np.testing.assert_array_equal(_get(back_tree, path), leaf)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _get(tree, path):
    for seg in path:
        tree = tree[seg]
    return tree


def _key_order(tree):
    return [(k, _key_order(v) if isinstance(v, dict) else None)
            for k, v in tree.items()]


def test_pickled_tree_matches_the_reference_tree():
    """The port's ``FedModel.params()`` tree, as ``--checkpoint``
    pickles it, against ``jax.device_get(unravel(flat))`` from the same
    flat vector: keys in the same order at every level, every leaf of
    the same dtype, shape and bits, before and after a pickle round
    trip."""
    jm = JaxResNet9(num_classes=10, channels=CH, do_batchnorm=True)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1),
                                 jnp.zeros((1, 32, 32, 3)))
    flat, unravel = jax_flatten(variables["params"])
    flat = flat + jnp.linspace(-1.0, 1.0, flat.size, dtype=jnp.float32)
    want = jax.device_get(unravel(flat))
    tm = ResNet9(num_classes=10, channels=CH, do_batchnorm=True)
    got = tm.to_params_tree(torch.from_numpy(np.array(flat)))
    assert _key_order(got) == _key_order(want)
    for path, leaf in _leaves(want):
        mine = _get(got, path)
        assert type(mine) is type(leaf) is np.ndarray, path
        assert (mine.dtype, mine.shape) == (leaf.dtype, leaf.shape), path
        assert mine.tobytes() == leaf.tobytes(), path
    mine, theirs = (pickle.loads(pickle.dumps(t)) for t in (got, want))
    assert _key_order(mine) == _key_order(theirs)
    for path, leaf in _leaves(theirs):
        assert _get(mine, path).tobytes() == leaf.tobytes(), path


TINY = ["--device", "cpu", "--test", "--mode", "sketch", "--error_type",
        "virtual", "--local_momentum", "0", "--num_workers", "2",
        "--local_batch_size", "4", "--num_epochs", "1", "--lr_scale", "0.1",
        "--pivot_epoch", "1"]
SYNTH = ["--dataset_name", "Synthetic", "--num_clients", "10"]


def test_checkpoint_then_finetune(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    cv_train.main(TINY + SYNTH + ["--checkpoint", "--checkpoint_path", ckpt])
    model = fed_model._CURRENT_MODEL
    pkl, pt = (os.path.join(ckpt, "ResNet9" + ext) for ext in (".pkl", ".pt"))
    with open(pkl, "rb") as f:
        saved = pickle.load(f)
    params = model.params()
    assert _key_order(saved) == _key_order(params)
    for path, leaf in _leaves(params):
        np.testing.assert_array_equal(_get(saved, path), leaf)
    sd = torch.load(pt, weights_only=True)
    want = jexport.cv_state_dict(
        jax_cv_train.build_model(jax_cv_train.parse_args(
            argv=TINY[2:] + SYNTH))[0], saved)
    assert list(sd) == list(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(sd[key].numpy(), arr, err_msg=key)
    assert "saved checkpoint to" in capsys.readouterr().out

    # --finetune on CIFAR100 (100 classes): the head is reinitialised,
    # the rest is the checkpoint
    data = write_fixture("CIFAR100", str(tmp_path / "cifar100"))
    argv = TINY + ["--dataset_name", "CIFAR100", "--dataset_dir", data,
                   "--num_clients", "100", "--finetune", "--finetune_path",
                   ckpt, "--finetuned_from", "Synthetic"]
    args = cv_train.parse_args(argv=argv)
    module, fresh = cv_train.build_model(args)
    start = cv_train.load_finetune_params(args, module, fresh)
    out = capsys.readouterr().out
    _, replaced = jax_cv_train.merge_finetune_params(
        module.to_params_tree(fresh), saved)
    assert replaced == ["Dense_0/kernel"]
    assert f"reinitialised: {replaced}" in out
    start_tree, fresh_tree = (module.to_params_tree(p)
                              for p in (start, fresh))
    for path, leaf in _leaves(start_tree):
        src = fresh_tree if path == ("Dense_0", "kernel") else saved
        np.testing.assert_array_equal(leaf, _get(src, path))
    results = cv_train.main(argv)
    assert np.isfinite(results[-1]["train_loss"])


def test_merge_finetune_params_matches_jax():
    rs = np.random.RandomState(0)
    target = {"Conv_0": {"kernel": rs.randn(3, 3, 3, 4).astype(np.float32)},
              "Dense_0": {"bias": np.zeros(100, np.float32),
                          "kernel": rs.randn(4, 100).astype(np.float32)},
              "extra": {"scale": np.ones(2, np.float32)}}
    source = {"Conv_0": {"kernel": rs.randn(3, 3, 3, 4).astype(np.float32)},
              "Dense_0": {"bias": np.ones(10, np.float32),
                          "kernel": rs.randn(4, 10).astype(np.float32)}}
    got, got_rep = cv_train.merge_finetune_params(target, source)
    want, want_rep = jax_cv_train.merge_finetune_params(target, source)
    assert got_rep == want_rep == ["Dense_0/bias", "Dense_0/kernel",
                                   "extra"]
    assert _key_order(got) == _key_order(want)
    for path, leaf in _leaves(want):
        np.testing.assert_array_equal(_get(got, path), np.asarray(leaf))


def test_diverged_run_writes_no_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    assert cv_train.main(TINY + SYNTH + [
        "--checkpoint", "--checkpoint_path", ckpt,
        "--nan_threshold", "-1"]) == []
    assert fed_model._CURRENT_MODEL.diverged
    assert not os.path.exists(ckpt)


def test_save_pretrained_torch_format(tmp_path):
    tm = ResNet9(num_classes=10, channels=CH, do_batchnorm=True)
    model = cv_train.make_fed_model(
        tm, tm.init_flat(2), cv_train.parse_args(argv=TINY[2:] + SYNTH)
        .replace(device="cpu", num_clients=10), 4, "cpu")
    model.save_pretrained(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["flax_model.msgpack"]
    model.save_pretrained(str(tmp_path), torch_format=True)
    sd = torch.load(os.path.join(tmp_path, "state_dict.pt"),
                    weights_only=True)
    want = texport.cv_state_dict(tm, model.params(),
                                 texport.nest_state(model.model_state))
    assert list(sd) == list(want)
    buf = io.BytesIO()
    torch.save(sd, buf)
    for key, arr in want.items():
        np.testing.assert_array_equal(sd[key].numpy(), arr, err_msg=key)

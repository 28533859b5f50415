"""ImageNet on the port (``data/fed_imagenet.py``) against the JAX
package, on JPEG trees the test writes (as the reference's
tests/test_data_breadth.py does; nothing is fetched).

- the dataset's items, raw and through the ImageNet transforms (PIL's
  bilinear resample in numpy on the port, PIL itself in the reference),
  bit for bit; its stats-only preparation and its refusal to overwrite;
- ``scripts/imagenet.sh``'s flags (FixupResNet50, uncompressed, virtual
  error and momentum 0.9, iid, ``--mixup``), cut to 2 clients x 2
  samples, through ``cv_train.main --test`` from the reference
  trainer's initial weights: one round on 32 x 32 JPEGs (resized to
  224 x 224 by the transforms) at the LR ramp's peak, the train loss
  and the validation loss after it within rtol 1e-4, bytes equal.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import json
import os

import jax
import numpy as np
import pytest
import torch

from commefficient_tpu.data import get_dataset_cls as jax_dataset_cls
from commefficient_tpu.data import transforms as JT
from commefficient_tpu.train import cv_train as jax_cv_train
from commefficient_tpu_torch.data import get_dataset_cls
from commefficient_tpu_torch.data import transforms as T
from commefficient_tpu_torch.data.fed_imagenet import FedImageNet
from commefficient_tpu_torch.train import cv_train
from commefficient_tpu_torch.utils import recipe_argv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WNIDS = ["n01440764", "n01443537", "n01484850"]


def write_tree(root, train=(3, 2, 3), val=(1, 1, 1), shape=(32, 40, 3),
               seed=0):
    from PIL import Image
    rng = np.random.RandomState(seed)
    for split, counts in (("train", train), ("val", val)):
        for ci, wnid in enumerate(WNIDS):
            d = os.path.join(root, split, wnid)
            os.makedirs(d)
            for i in range(counts[ci]):
                arr = rng.randint(0, 255, shape, np.uint8)
                Image.fromarray(arr).save(os.path.join(d, f"img{i}.JPEG"))
    return root


@pytest.fixture()
def trees(tmp_path):
    return (write_tree(str(tmp_path / "port")),
            write_tree(str(tmp_path / "jax")))


def test_registry_and_stats_only_preparation(trees):
    assert get_dataset_cls("ImageNet") is FedImageNet
    ours = FedImageNet(trees[0], "ImageNet", train=True)
    theirs = jax_dataset_cls("ImageNet")(trees[1], "ImageNet", train=True)
    np.testing.assert_array_equal(ours.images_per_client,
                                  theirs.images_per_client)
    with open(os.path.join(trees[0], "stats.json")) as f, \
            open(os.path.join(trees[1], "stats.json")) as g:
        assert json.load(f) == json.load(g)
    with pytest.raises(RuntimeError, match="overwrite"):
        ours.prepare_datasets()
    with pytest.raises(RuntimeError, match="download"):
        ours.prepare_datasets(download=True)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("iid", [False, True])
def test_items_bit_equal_raw_and_transformed(trees, split, iid):
    train = split == "train"
    kw = dict(train=train, do_iid=iid, num_clients=4 if iid else None,
              seed=3)
    ours = FedImageNet(trees[0], "ImageNet", **kw)
    theirs = jax_dataset_cls("ImageNet")(trees[1], "ImageNet", **kw)
    assert len(ours) == len(theirs) > 0
    for idx in range(len(ours)):
        (ca, xa, ya), (cb, xb, yb) = ours[idx], theirs[idx]
        assert (ca, ya) == (cb, yb)
        assert xa.dtype == xb.dtype == np.uint8
        np.testing.assert_array_equal(xa, xb)
    stack = "imagenet_train" if train else "imagenet_val"
    ours.transform = getattr(T, f"{stack}_transform")()
    theirs.transform = getattr(JT, f"{stack}_transform")()
    for idx in range(len(ours)):
        np.random.seed(idx)
        _, xa, _ = ours[idx]
        np.random.seed(idx)
        _, xb, _ = theirs[idx]
        assert xa.shape == xb.shape == (224, 224, 3)
        assert xa.dtype == xb.dtype == np.float32
        np.testing.assert_array_equal(xa, xb)


def test_imagenet_recipe_rounds_match_the_reference(tmp_path, monkeypatch):
    argv = recipe_argv(os.path.join(REPO, "scripts", "imagenet.sh")) + [
        "--test", "--num_clients", "2", "--num_workers", "2",
        "--local_batch_size", "2", "--valid_batch_size", "2",
        "--num_epochs", "1", "--pivot_epoch", "0"]
    port_dir = write_tree(str(tmp_path / "port"), shape=(32, 32, 3))
    jax_dir = write_tree(str(tmp_path / "jax"), shape=(32, 32, 3))
    init = []
    jax_build = jax_cv_train.build_model

    def jax_build_model(args):
        out = jax_build(args)
        init.append(jax.tree_util.tree_map(np.asarray, out[1]))
        return out

    monkeypatch.setattr(jax_cv_train, "build_model", jax_build_model)
    np.random.seed(0)
    jax_results = jax_cv_train.main(argv + ["--dataset_dir", jax_dir])
    port_build = cv_train.build_model

    def build_model(args, device="cpu"):
        module, _ = port_build(args, device)
        return module, module.from_jax_params(init[0], device)

    monkeypatch.setattr(cv_train, "build_model", build_model)
    np.random.seed(0)
    with torch.backends.mkldnn.flags(enabled=False):
        results = cv_train.main(["--device", "cpu", "--dataset_dir",
                                 port_dir] + argv)
    assert len(results) == len(jax_results) == 1
    for row, jrow in zip(results, jax_results):
        np.testing.assert_allclose(row["train_loss"], jrow["train_loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(row["test_loss"], jrow["test_loss"],
                                   rtol=1e-4)
        assert row["up (MiB)"] == jrow["up (MiB)"] > 0
        assert row["down (MiB)"] == jrow["down (MiB)"]
    # the round moved the weights (the LR ramp starts at its peak): the
    # validation after it scores below the round's own loss
    assert results[-1]["test_loss"] < results[-1]["train_loss"]

"""The port's image data against the JAX package's, on the CPU, on
archives the tests write (``data/fixtures.py``): the CIFAR python
pickles and LEAF FEMNIST JSON shards.

Everything here is host-side numpy with the same RNG draws in the same
order, so every comparison is exact:
- the numpy bilinear resample against ``PIL.Image.resize(BILINEAR)``,
  byte for byte, at every crop size ``RandomResizedCrop`` produces on a
  28 x 28 FEMNIST image (and on CIFAR's 3 channels);
- the CIFAR and FEMNIST transform stacks, seeded alike;
- ``FedCIFAR10``/``FedCIFAR100``/``FedEMNIST``: client sizes, items
  and the Python loader's transformed round batches, bit for bit.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import numpy as np
import pytest
from PIL import Image

from commefficient_tpu.data import transforms as JT
from commefficient_tpu.data.fed_cifar import FedCIFAR10 as JaxCIFAR10
from commefficient_tpu.data.fed_cifar import FedCIFAR100 as JaxCIFAR100
from commefficient_tpu.data.fed_emnist import FedEMNIST as JaxEMNIST
from commefficient_tpu.data.fed_sampler import FedSampler as JaxSampler
from commefficient_tpu.data.loader import FedLoader as JaxLoader
from commefficient_tpu.data.loader import ValLoader as JaxValLoader
from commefficient_tpu_torch.data import (FedCIFAR10, FedCIFAR100, FedEMNIST,
                                          FedLoader, FedSampler, ValLoader,
                                          get_dataset_cls)
from commefficient_tpu_torch.data import transforms as T
from commefficient_tpu_torch.data.fixtures import write_cifar, write_leaf

# every (h, w) crop of a 28 x 28 image that RandomResizedCrop's area
# (0.8-1.2) and aspect (4/5-5/4) draws can give, resized to 28 x 28
CROPS = [(h, w) for h in range(20, 29) for w in range(20, 29)
         if 0.8 * 784 * 0.75 <= h * w and 4 / 5 - 0.1 <= w / h <= 5 / 4 + 0.1]


@pytest.mark.parametrize("channels", [1, 3])
def test_bilinear_resample_equals_pil(channels):
    rng = np.random.RandomState(channels)
    for h, w in CROPS + [(32, 32), (64, 48), (7, 5)]:
        a = rng.randint(0, 256, (h, w, channels)).astype(np.uint8)
        img = Image.fromarray(a[..., 0] if channels == 1 else a)
        want = np.asarray(img.resize((28, 28), Image.BILINEAR))
        got = T.pil_bilinear_resize(a, 28, 28)
        np.testing.assert_array_equal(got.reshape(want.shape), want)
        # and the float path against the JAX package's PIL resize
        f = rng.rand(h, w, channels).astype(np.float32)
        np.testing.assert_array_equal(T.resize(f, 28, 28),
                                      JT._pil_resize(f, 28, 28))


@pytest.mark.parametrize("stack", ["femnist_train", "femnist_val",
                                   "cifar_train", "cifar_val"])
def test_transform_stacks_match_jax(stack):
    """Seeded alike, the port's stack gives the JAX stack's arrays bit
    for bit (the global numpy RNG, drawn in the same order)."""
    rng = np.random.RandomState(3)
    if stack.startswith("femnist"):
        images = [rng.rand(28, 28, 1).astype(np.float32) for _ in range(40)]
    else:
        images = [rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
                  for _ in range(40)]
    ours, theirs = (getattr(T, f"{stack}_transform")(),
                    getattr(JT, f"{stack}_transform")())
    np.random.seed(11)
    got = [ours(x) for x in images]
    np.random.seed(11)
    want = [theirs(x) for x in images]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _cifar(tmp_path, name):
    return (write_cifar(str(tmp_path / "port"), name, per_class=6,
                        num_test=10, seed=4),
            write_cifar(str(tmp_path / "jax"), name, per_class=6,
                        num_test=10, seed=4))


def _leaf(tmp_path):
    return (write_leaf(str(tmp_path / "port"), writers=7, per_writer=5,
                       seed=5),
            write_leaf(str(tmp_path / "jax"), writers=7, per_writer=5,
                       seed=5))


DATASETS = {
    "CIFAR10": (FedCIFAR10, JaxCIFAR10, T.cifar_train_transform,
                JT.cifar_train_transform, T.cifar_val_transform,
                JT.cifar_val_transform),
    "CIFAR100": (FedCIFAR100, JaxCIFAR100,
                 lambda: T.cifar_train_transform(T.CIFAR100_MEAN,
                                                 T.CIFAR100_STD),
                 lambda: JT.cifar_train_transform(JT.CIFAR100_MEAN,
                                                  JT.CIFAR100_STD),
                 lambda: T.cifar_val_transform(T.CIFAR100_MEAN,
                                               T.CIFAR100_STD),
                 lambda: JT.cifar_val_transform(JT.CIFAR100_MEAN,
                                                JT.CIFAR100_STD)),
    "EMNIST": (FedEMNIST, JaxEMNIST, T.femnist_train_transform,
               JT.femnist_train_transform, T.femnist_val_transform,
               JT.femnist_val_transform),
}


@pytest.mark.parametrize("iid", [False, True])
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_datasets_and_loader_batches_match_jax(name, iid, tmp_path):
    ours_cls, jax_cls, t_train, j_train, t_val, j_val = DATASETS[name]
    roots = _leaf(tmp_path) if name == "EMNIST" else _cifar(tmp_path, name)
    assert get_dataset_cls(name) is ours_cls
    num_clients = 14 if iid else None
    kw = dict(do_iid=iid, num_clients=num_clients, seed=8)
    ours = ours_cls(roots[0], name, transform=t_train(), train=True, **kw)
    theirs = jax_cls(roots[1], name, transform=j_train(), train=True, **kw)
    assert ours.num_clients == theirs.num_clients
    np.testing.assert_array_equal(ours.data_per_client,
                                  theirs.data_per_client)
    assert len(ours) == len(theirs) > 0
    ours.transform = theirs.transform = None
    for idx in range(len(ours)):
        (ca, xa, ya), (cb, xb, yb) = ours[idx], theirs[idx]
        assert (ca, ya) == (cb, yb)
        np.testing.assert_array_equal(xa, xb)
    ours.transform, theirs.transform = t_train(), j_train()

    w, b = 3, 4
    loaders = (FedLoader(ours, FedSampler(ours, w, b, seed=9)),
               JaxLoader(theirs, JaxSampler(theirs, w, b, seed=9)))
    batches = []
    for loader in loaders:
        np.random.seed(12)
        batches.append(list(loader))
    assert len(batches[0]) == len(batches[1]) > 0
    for a, b_ in zip(*batches):
        assert set(a) == set(b_)
        for key in a:
            assert a[key].dtype == b_[key].dtype, key
            np.testing.assert_array_equal(a[key], b_[key])

    val = (ours_cls(roots[0], name, transform=t_val(), train=False, **kw),
           jax_cls(roots[1], name, transform=j_val(), train=False, **kw))
    vb = [list(ValLoader(val[0], 4, 2)), list(JaxValLoader(val[1], 4, 2))]
    assert len(vb[0]) == len(vb[1]) > 0
    for a, b_ in zip(*vb):
        for key in a:
            np.testing.assert_array_equal(a[key], b_[key])


def test_missing_archive_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="never downloads"):
        FedCIFAR10(str(tmp_path), "CIFAR10", train=True)


@pytest.mark.parametrize("sep", [1.0, 0.025])
def test_synthetic_bayes_accuracy_equals_jax(sep):
    from commefficient_tpu.data.synthetic import FedSynthetic as JaxSynthetic
    from commefficient_tpu_torch.data.synthetic import FedSynthetic
    kw = dict(train=False, do_iid=False, num_clients=None, per_class=8,
              num_val=400, separation=sep, seed=0)
    want = JaxSynthetic("", "Synthetic", **kw).bayes_accuracy()
    got = FedSynthetic("", "Synthetic", **kw).bayes_accuracy()
    assert got == want
    assert (got == 1.0) if sep == 1.0 else (0.5 < got < 0.95)

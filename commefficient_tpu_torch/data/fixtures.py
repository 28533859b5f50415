"""Small image datasets in the archives' own formats, from a seed, for
tests and smoke runs that have no dataset on disk:

- ``write_cifar``: the python-pickle CIFAR10 (``cifar-10-batches-py/``,
  five ``data_batch_*`` and ``test_batch``) or CIFAR100
  (``cifar-100-python/``, ``train`` and ``test``) archive, random uint8
  pixels, ``per_class`` training images of each class;
- ``write_leaf``: LEAF FEMNIST JSON shards (``train/`` and ``test/``,
  ``{"users", "num_samples", "user_data"}``), ``writers`` writers of
  ``per_writer`` 28 x 28 images, random pixels in [0, 1] and labels
  below 62.

``FedCIFAR10``/``FedCIFAR100``/``FedEMNIST`` read them as they read
the real archives.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np


def write_cifar(root: str, name: str = "CIFAR10", per_class: int = 8,
                num_test: int = 16, seed: int = 0) -> str:
    """Writes the archive under ``root`` and returns ``root`` (the
    trainer's ``--dataset_dir``)."""
    rng = np.random.RandomState(seed)
    classes = 10 if name == "CIFAR10" else 100
    y = np.repeat(np.arange(classes), per_class)
    y = y[rng.permutation(len(y))]
    x = rng.randint(0, 256, (len(y), 3 * 32 * 32)).astype(np.uint8)
    ty = rng.randint(0, classes, num_test)
    tx = rng.randint(0, 256, (num_test, 3 * 32 * 32)).astype(np.uint8)
    if name == "CIFAR10":
        src, key = os.path.join(root, "cifar-10-batches-py"), b"labels"
        parts = np.array_split(np.arange(len(y)), 5)
        files = {f"data_batch_{i + 1}": idx for i, idx in enumerate(parts)}
        test_file = "test_batch"
    else:
        src, key = os.path.join(root, "cifar-100-python"), b"fine_labels"
        files = {"train": np.arange(len(y))}
        test_file = "test"
    os.makedirs(src, exist_ok=True)
    for fn, idx in files.items():
        with open(os.path.join(src, fn), "wb") as f:
            pickle.dump({b"data": x[idx], key: y[idx].tolist()}, f)
    with open(os.path.join(src, test_file), "wb") as f:
        pickle.dump({b"data": tx, key: ty.tolist()}, f)
    return root


def write_leaf(root: str, writers: int = 4, per_writer: int = 8,
               test_writers: int = 2, shards: int = 2,
               seed: int = 0) -> str:
    """Writes ``train/`` and ``test/`` shards under ``root`` and
    returns ``root``. Writer w holds ``per_writer + w % 3`` images, so
    client sizes differ."""
    rng = np.random.RandomState(seed)
    for split, n_writers in (("train", writers), ("test", test_writers)):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        users = [f"f{split}_{w:04d}" for w in range(n_writers)]
        for s, part in enumerate(np.array_split(np.arange(n_writers),
                                                shards)):
            data = {}
            for w in part:
                n = per_writer + int(w) % 3
                data[users[w]] = {
                    "x": np.round(rng.rand(n, 784), 6).tolist(),
                    "y": rng.randint(0, 62, n).tolist()}
            with open(os.path.join(d, f"shard_{s}.json"), "w") as f:
                json.dump({"users": [users[w] for w in part],
                           "num_samples": [len(data[users[w]]["y"])
                                           for w in part],
                           "user_data": data}, f)
    return root


def write_fixture(dataset_name: str, root: str, seed: int = 0) -> str:
    """The smoke runs' fixture of an image dataset (``chip_smoke.py``,
    ``profile_round``): EMNIST 16 writers of 32-34 images and 2 test
    writers (9 rounds an epoch at 8 clients x 8 samples); CIFAR 64
    images a class and 64 test images (10 rounds an epoch). Returns
    the ``--dataset_dir``."""
    if dataset_name == "EMNIST":
        return write_leaf(root, writers=16, per_writer=32, test_writers=2,
                          shards=4, seed=seed)
    if dataset_name in ("CIFAR10", "CIFAR100"):
        return write_cifar(root, dataset_name, per_class=64, num_test=64,
                           seed=seed)
    raise ValueError(f"no fixture for {dataset_name}")

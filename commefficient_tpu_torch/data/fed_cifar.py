"""Federated CIFAR10/100 (numpy-only copy of
``commefficient_tpu/data/fed_cifar.py``): natural partition = one
class per client. On first use it reads the standard python-pickle
CIFAR archive from ``dataset_dir`` (it never downloads: place
``cifar-10-batches-py/`` or ``cifar-100-python/`` there) and writes
per-client ``client{i}.npy`` files + ``test.npz`` + ``stats.json``.
Non-iid CIFAR means "each client holds one class", subdivided among
``--num_clients`` by ``data_per_client`` (fed_dataset.py:40-48).
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import FedDataset

__all__ = ["FedCIFAR10", "FedCIFAR100"]


class FedCIFAR10(FedDataset):
    num_classes = 10
    _archive = "cifar-10-batches-py"
    _train_files = [f"data_batch_{i}" for i in range(1, 6)]
    _test_file = "test_batch"
    _label_key = b"labels"

    def prepare_datasets(self):
        src = os.path.join(self.dataset_dir, self._archive)
        if not os.path.exists(src):
            raise FileNotFoundError(
                f"{src} not found; place the CIFAR archive there "
                "(the loader never downloads)")
        xs, ys = [], []
        for fn in self._train_files:
            with open(os.path.join(src, fn), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.append(np.array(d[self._label_key]))
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(
            0, 2, 3, 1)  # NHWC
        y = np.concatenate(ys)

        images_per_client = []
        for c in range(self.num_classes):
            idx = np.where(y == c)[0]
            images_per_client.append(len(idx))
            np.save(os.path.join(self.dataset_dir, f"client{c}.npy"),
                    x[idx])
        with open(os.path.join(src, self._test_file), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        tx = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        ty = np.array(d[self._label_key])
        np.savez(os.path.join(self.dataset_dir, "test.npz"),
                 x=tx, y=ty)
        with open(self.stats_fn(), "w") as f:
            json.dump({"images_per_client": images_per_client,
                       "num_val_images": len(ty)}, f)

    def _load_meta(self, train):
        super()._load_meta(train)
        if train:
            self._clients = [
                np.load(os.path.join(self.dataset_dir, f"client{c}.npy"))
                for c in range(self.num_classes)]
        else:
            d = np.load(os.path.join(self.dataset_dir, "test.npz"))
            self._test_x, self._test_y = d["x"], d["y"]

    def _get_train_item(self, client_id, idx_within_client):
        # label == natural client id (one class per client,
        # fed_cifar.py:80)
        return self._clients[client_id][idx_within_client], int(client_id)

    def _get_val_item(self, idx):
        return self._test_x[idx], int(self._test_y[idx])


class FedCIFAR100(FedCIFAR10):
    num_classes = 100
    _archive = "cifar-100-python"
    _train_files = ["train"]
    _test_file = "test"
    _label_key = b"fine_labels"

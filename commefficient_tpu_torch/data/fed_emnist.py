"""Federated EMNIST (LEAF FEMNIST; numpy-only copy of
``commefficient_tpu/data/fed_emnist.py``): natural partition = one
writer per client (3500 writers in the full dataset). The LEAF
preprocessing pipeline (the reference's ``leaf`` git submodule) emits
json shards with keys ``users`` / ``user_data`` where
``user_data[u] = {"x": [flat 784-pixel images], "y": [labels]}``;
``prepare_datasets`` parses those once and repacks them as **packed
``.npy`` memmaps** — concatenated ``(N, 28, 28)`` float32 images +
targets + client offsets. A handful of mmap-able files instead of 3500
tiny ``.pt`` files solves the same fd-limit problem the reference
works around at runtime (fed_emnist.py:42-59), and items slice out of
the memmap without loading the ~GB image array into RAM.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import FedDataset

__all__ = ["FedEMNIST", "read_leaf_dir"]


def read_leaf_dir(data_dir: str) -> Dict[str, dict]:
    """Parse every ``*.json`` LEAF shard in ``data_dir`` into one
    ``{user: {"x": [...], "y": [...]}}`` dict (reference
    fed_emnist.py:11-34)."""
    data: Dict[str, dict] = {}
    for f in sorted(os.listdir(data_dir)):
        if not f.endswith(".json"):
            continue
        with open(os.path.join(data_dir, f), "rb") as inf:
            cdata = json.loads(inf.read())
        data.update(cdata["user_data"])
    return data


def _pack(user_data: Dict[str, dict]):
    images: List[np.ndarray] = []
    targets: List[np.ndarray] = []
    offsets = [0]
    for u, cdata in user_data.items():
        x = np.asarray(cdata["x"], np.float32).reshape(-1, 28, 28)
        y = np.asarray(cdata["y"], np.int32)
        images.append(x)
        targets.append(y)
        offsets.append(offsets[-1] + len(y))
    return (np.concatenate(images), np.concatenate(targets),
            np.asarray(offsets, np.int64))


class FedEMNIST(FedDataset):
    num_classes = 62

    def prepare_datasets(self):
        if os.path.exists(self.stats_fn()):
            raise RuntimeError("won't overwrite existing stats file")
        train_dir = os.path.join(self.dataset_dir, "train")
        test_dir = os.path.join(self.dataset_dir, "test")

        x, y, offsets = _pack(read_leaf_dir(train_dir))
        np.save(self._fn("train_x"), x)
        np.save(self._fn("train_y"), y)
        np.save(self._fn("train_offsets"), offsets)
        images_per_client = np.diff(offsets).tolist()

        tx, ty, _ = _pack(read_leaf_dir(test_dir))
        np.save(self._fn("test_x"), tx)
        np.save(self._fn("test_y"), ty)

        with open(self.stats_fn(), "w") as f:
            json.dump({"images_per_client": images_per_client,
                       "num_val_images": int(len(ty))}, f)

    def _load_meta(self, train):
        super()._load_meta(train)
        if train:
            # .npy memmaps: zero-copy per-item slices (npz would load
            # the whole array — numpy ignores mmap_mode for archives)
            self._x = np.load(self._fn("train_x"), mmap_mode="r")
            self._y = np.load(self._fn("train_y"), mmap_mode="r")
            self._offsets = np.load(self._fn("train_offsets"))
        else:
            self._test_x = np.load(self._fn("test_x"), mmap_mode="r")
            self._test_y = np.load(self._fn("test_y"), mmap_mode="r")

    def _get_train_item(self, client_id, idx_within_client):
        i = int(self._offsets[client_id]) + int(idx_within_client)
        return self._x[i][..., None], int(self._y[i])

    def _get_val_item(self, idx):
        return self._test_x[idx][..., None], int(self._test_y[idx])

    def _fn(self, name):
        return os.path.join(self.dataset_dir, f"{name}_packed.npy")

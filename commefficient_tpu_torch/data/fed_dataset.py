"""Federated dataset base class (numpy-only copy of
``commefficient_tpu/data/fed_dataset.py``).

A dataset is a natural partition of records over clients
(``images_per_client``); ``--iid`` applies a global permutation while
keeping synthetic client ids; ``--num_clients`` re-splits natural
partitions. Items are ``(client_id, image, target)`` with client_id -1
for validation records, the image passed through ``transform`` where
one is given (the numpy stacks of ``data/transforms.py``). Same seeds
give the same partitions as the reference.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["FedDataset"]


class FedDataset:
    def __init__(self, dataset_dir, dataset_name, transform=None,
                 do_iid=False, num_clients=None, train=True, seed=None):
        self.dataset_dir = dataset_dir
        self.dataset_name = dataset_name
        self.transform = transform
        self.do_iid = do_iid
        self._num_clients = num_clients
        self.type = "train" if train else "val"

        if not do_iid and num_clients == 1:
            raise ValueError("can't have 1 client when non-iid")

        if not os.path.exists(self.stats_fn()):
            self.prepare_datasets()

        self._load_meta(train)

        if self.do_iid:
            rng = (np.random if seed is None
                   else np.random.RandomState(seed))
            self.iid_shuffle = rng.permutation(len(self))

    @property
    def data_per_client(self):
        """Records per client (cached: immutable after _load_meta)."""
        cached = getattr(self, "_dpc_cache", None)
        if cached is not None:
            return cached
        if self.do_iid:
            num_data = len(self)
            ipc = (np.ones(self.num_clients, dtype=int)
                   * num_data // self.num_clients)
            extra = num_data % self.num_clients
            if extra:
                ipc[self.num_clients - extra:] += 1
        elif self._num_clients is None:
            ipc = np.asarray(self.images_per_client)
        else:
            if self._num_clients < len(self.images_per_client):
                raise ValueError(
                    f"non-iid needs num_clients >= "
                    f"{len(self.images_per_client)} natural partitions "
                    f"(got {self._num_clients}); pass --iid to re-split")
            n_natural = len(self.images_per_client)
            if self._num_clients % n_natural:
                raise ValueError(
                    f"non-iid re-split divides clients evenly over "
                    f"the {n_natural} natural partitions: "
                    f"--num_clients must be a multiple of {n_natural} "
                    f"(got {self._num_clients}); pass --iid for an "
                    f"arbitrary client count")
            new_ipc = []
            for num_images in self.images_per_client:
                n_per_class = self._num_clients // n_natural
                extra = num_images % n_per_class
                split = [num_images // n_per_class
                         for _ in range(n_per_class)]
                split[-1] += extra
                new_ipc.extend(split)
            ipc = np.array(new_ipc)
        self._dpc_cache = ipc
        self._dpc_cumsum = np.cumsum(ipc)
        return ipc

    @property
    def num_clients(self):
        return (self._num_clients if self._num_clients is not None
                else len(self.images_per_client))

    def _load_meta(self, train):
        with open(self.stats_fn(), "r") as f:
            stats = json.load(f)
            self.images_per_client = np.array(stats["images_per_client"])
            self.num_val_images = stats["num_val_images"]

    @property
    def _ipc_cumsum(self):
        cached = getattr(self, "_ipc_cumsum_cache", None)
        if cached is None:
            cached = np.cumsum(self.images_per_client)
            self._ipc_cumsum_cache = cached
        return cached

    def __len__(self):
        if self.type == "train":
            return int(sum(self.images_per_client))
        return int(self.num_val_images)

    def __getitem__(self, idx):
        if self.type == "train":
            orig_idx = idx
            if self.do_iid:
                idx = self.iid_shuffle[idx]
            cumsum = self._ipc_cumsum
            natural_client = np.searchsorted(cumsum, idx, side="right")
            start = cumsum[natural_client - 1] if natural_client else 0
            image, target = self._get_train_item(natural_client,
                                                 idx - start)
            # the reported client id comes from data_per_client over
            # the original index
            self.data_per_client  # ensure _dpc_cumsum
            client_id = int(np.searchsorted(self._dpc_cumsum, orig_idx,
                                            side="right"))
        else:
            image, target = self._get_val_item(idx)
            client_id = -1
        if self.transform is not None:
            image = self.transform(image)
        return client_id, image, target

    def stats_fn(self):
        return os.path.join(self.dataset_dir, "stats.json")

    # subclass API
    def prepare_datasets(self):
        raise NotImplementedError

    def _get_train_item(self, client_id, idx_within_client):
        raise NotImplementedError

    def _get_val_item(self, idx):
        raise NotImplementedError

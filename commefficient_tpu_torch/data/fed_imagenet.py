"""Federated ImageNet (numpy copy of
``commefficient_tpu/data/fed_imagenet.py``): natural partition = one
wnid (class) per client.

``prepare_datasets`` never downloads; it only writes ``stats.json``
over an extracted tree::

    dataset_dir/
      train/<wnid>/<image>.JPEG ...
      val/<wnid>/<image>.JPEG ...

The tree is indexed directly: the wnids, sorted, are the client ids
(torchvision's class order). Each item decodes lazily through Pillow,
imported only where an image is read; the transforms
(``data/transforms.py``) resize, crop and normalize.
"""

from __future__ import annotations

import json
import os

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import FedDataset

__all__ = ["FedImageNet"]

_EXTS = (".jpeg", ".jpg", ".png")


def _index_split(split_dir: str):
    """[(path, class_idx)] sorted by (wnid, filename), plus counts."""
    wnids = sorted(d for d in os.listdir(split_dir)
                   if os.path.isdir(os.path.join(split_dir, d)))
    samples, counts = [], []
    for ci, wnid in enumerate(wnids):
        cdir = os.path.join(split_dir, wnid)
        files = sorted(f for f in os.listdir(cdir)
                       if f.lower().endswith(_EXTS))
        samples.extend((os.path.join(cdir, f), ci) for f in files)
        counts.append(len(files))
    return samples, counts


class FedImageNet(FedDataset):
    num_classes = 1000

    def prepare_datasets(self, download=False):
        if download:
            raise RuntimeError("Can't download ImageNet")
        if os.path.exists(self.stats_fn()):
            raise RuntimeError("won't overwrite existing stats file")
        _, counts = _index_split(os.path.join(self.dataset_dir, "train"))
        val_samples, _ = _index_split(os.path.join(self.dataset_dir,
                                                   "val"))
        with open(self.stats_fn(), "w") as f:
            json.dump({"images_per_client": counts,
                       "num_val_images": len(val_samples)}, f)

    def _load_meta(self, train):
        super()._load_meta(train)
        split = "train" if train else "val"
        self._samples, counts = _index_split(
            os.path.join(self.dataset_dir, split))
        # the fresh walk wins over the stats.json snapshot: a
        # re-extracted tree would otherwise desync the indices
        if train:
            self.images_per_client = np.asarray(counts)
        else:
            self.num_val_images = len(self._samples)

    def _decode(self, path):
        from PIL import Image
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    def _get_train_item(self, client_id, idx_within_client):
        cumsum = self._ipc_cumsum
        start = int(cumsum[client_id - 1]) if client_id else 0
        path, target = self._samples[start + int(idx_within_client)]
        return self._decode(path), int(target)

    def _get_val_item(self, idx):
        path, target = self._samples[int(idx)]
        return self._decode(path), int(target)

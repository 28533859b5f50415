"""Round-batch construction (numpy-only copy of ``FedLoader`` and
``ValLoader`` from ``commefficient_tpu/data/loader.py``): sampler
output -> fixed-shape padded batches, client axis first, with a (W, B)
mask for ragged clients."""

from __future__ import annotations

from typing import Iterator

import numpy as np

from commefficient_tpu_torch.utils import steps_per_epoch

__all__ = ["FedLoader", "ValLoader"]


class FedLoader:
    """CV rounds: ``client_ids`` (W,), ``x`` (W, B, ...) f32, ``y``
    (W, B) i32, ``mask`` (W, B) f32. Rounds with fewer than
    ``num_workers`` clients are skipped, as the reference does."""

    _img_shape = None

    def __init__(self, dataset, sampler):
        self.dataset = dataset
        self.sampler = sampler
        if sampler.local_batch_size != -1:
            self.B = sampler.local_batch_size
        else:
            self.B = int(np.max(dataset.data_per_client))
        self.W = sampler.num_workers

    def __iter__(self) -> Iterator[dict]:
        for round_spec in self.sampler:
            if len(round_spec) < self.W:
                continue  # incomplete round: skip
            yield self.collate(round_spec)

    def __len__(self):
        return steps_per_epoch(self.sampler.local_batch_size,
                               self.dataset, self.W)

    def collate(self, round_spec) -> dict:
        W, B = self.W, self.B
        if self._img_shape is None:
            self._img_shape = np.asarray(
                self.dataset[int(round_spec[0][1][0])][1]).shape
        x = np.zeros((W, B) + self._img_shape, np.float32)
        y = np.zeros((W, B), np.int32)
        mask = np.zeros((W, B), np.float32)
        ids = np.zeros((W,), np.int32)
        for i, (cid, idxs) in enumerate(round_spec):
            ids[i] = cid
            for j, idx in enumerate(idxs[:B]):
                client_id, img, target = self.dataset[int(idx)]
                assert client_id == cid, (client_id, cid)
                x[i, j] = img
                y[i, j] = target
                mask[i, j] = 1.0
        return {"client_ids": ids, "x": x, "y": y, "mask": mask}


class ValLoader:
    """Validation shards: (S, B, ...) stacked shards of
    ``valid_batch_size`` each; the final partial/empty shards are
    padded and masked."""

    _img_shape = None

    def __init__(self, dataset, valid_batch_size: int,
                 shards_per_step: int = 8):
        self.dataset = dataset
        self.B = valid_batch_size
        self.S = shards_per_step

    def __len__(self):
        return int(np.ceil(len(self.dataset) / (self.B * self.S)))

    def __iter__(self):
        n = len(self.dataset)
        step = self.B * self.S
        for start in range(0, n, step):
            idxs = np.arange(start, min(start + step, n))
            if self._img_shape is None:
                self._img_shape = np.asarray(
                    self.dataset[int(idxs[0])][1]).shape
            x = np.zeros((self.S, self.B) + self._img_shape, np.float32)
            y = np.zeros((self.S, self.B), np.int32)
            mask = np.zeros((self.S, self.B), np.float32)
            for pos, idx in enumerate(idxs):
                s, j = divmod(pos, self.B)
                _, img, target = self.dataset[int(idx)]
                x[s, j] = img
                y[s, j] = target
                mask[s, j] = 1.0
            yield {"x": x, "y": y, "mask": mask}

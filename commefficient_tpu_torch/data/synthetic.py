"""Synthetic federated image dataset (numpy-only copy of
``commefficient_tpu/data/synthetic.py``): class-conditional Gaussian
blobs, by default one class per natural client. Same ``gen_seed``,
same images as the reference."""

from __future__ import annotations

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import FedDataset

__all__ = ["FedSynthetic"]


class FedSynthetic(FedDataset):
    """``classes_per_client`` is the heterogeneity dial (1 = one class
    per client); ``separation`` scales the class means against the
    fixed 0.5 noise std."""

    def __init__(self, *args, num_classes=10, image_shape=(32, 32, 3),
                 per_class=64, num_val=128, gen_seed=0,
                 classes_per_client=1, separation=1.0, **kw):
        self.num_classes = num_classes
        self.image_shape = image_shape
        self.per_class = per_class
        self.num_val = num_val
        self.gen_seed = gen_seed
        self.classes_per_client = classes_per_client
        self.separation = separation
        super().__init__(*args, **kw)

    # entirely in-memory: no disk prep
    def prepare_datasets(self):
        pass

    def stats_fn(self):
        return ""  # never consulted

    def _gen(self):
        rng = np.random.RandomState(self.gen_seed)
        self._means = (self.separation
                       * rng.randn(self.num_classes,
                                   *self.image_shape)).astype(np.float32)
        vx, vy = [], []
        for c in range(self.num_classes):
            n = self.num_val // self.num_classes
            vx.append(self._means[c] + 0.5 * rng.randn(
                n, *self.image_shape).astype(np.float32))
            vy.append(np.full(n, c))
        self._val_x = np.concatenate(vx)
        self._val_y = np.concatenate(vy)

    def _load_meta(self, train):
        self.images_per_client = np.full(self.num_classes,
                                         self.per_class)
        self._gen()
        self.num_val_images = len(self._val_y)

    def _get_train_item(self, client_id, idx_within_client):
        rng = np.random.RandomState(
            self.gen_seed + 17 + int(client_id) * 100003
            + int(idx_within_client))
        # client c holds classes {c, ..., c+cpc-1} (mod K), cycled
        label = (int(client_id)
                 + int(idx_within_client) % self.classes_per_client) \
            % self.num_classes
        img = (self._means[label]
               + 0.5 * rng.randn(*self.image_shape).astype(np.float32))
        return img, label

    def _get_val_item(self, idx):
        return self._val_x[idx], int(self._val_y[idx])

    def bayes_accuracy(self):
        """Accuracy of the Bayes-optimal rule on this validation split:
        the noise is isotropic with one covariance for every class, so
        the rule is the nearest true class mean. It is the ceiling of a
        run whose ``separation`` is below 1."""
        x = self._val_x.reshape(len(self._val_y), -1)
        mu = self._means.reshape(self.num_classes, -1)
        d2 = ((x[:, None, :] - mu[None, :, :]) ** 2).sum(-1)
        return float((np.argmin(d2, 1) == self._val_y).mean())

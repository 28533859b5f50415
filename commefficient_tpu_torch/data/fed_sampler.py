"""Federated round scheduler (numpy-only copy of
``commefficient_tpu/data/fed_sampler.py``): shuffle within each
client, then each round sample ``num_workers`` non-exhausted clients
without replacement and take up to ``local_batch_size`` records from
each (-1 = the client's whole remaining data); an epoch ends when every
client is exhausted. Same seed, same cohorts as the reference."""

from __future__ import annotations

import numpy as np

__all__ = ["FedSampler"]


class _Lookahead:
    """Iterator that draws ONE round ahead, as the reference's does.
    Kept for its RNG stream: when a consumer stops mid-epoch the
    reference sampler has already drawn the next round, and the next
    epoch's permutation must follow the same draws."""

    def __init__(self, it):
        self._it = it
        self._advance()

    def _advance(self):
        try:
            self._buf = next(self._it)
            self._has = True
        except StopIteration:
            self._buf = None
            self._has = False

    def __iter__(self):
        return self

    def __next__(self):
        if not self._has:
            raise StopIteration
        out = self._buf
        self._advance()
        return out


class FedSampler:
    def __init__(self, dataset, num_workers, local_batch_size, seed=None):
        self.dataset = dataset
        self.num_workers = num_workers
        self.local_batch_size = local_batch_size
        self.rng = (np.random if seed is None
                    else np.random.RandomState(seed))

    def __iter__(self):
        data_per_client = np.asarray(self.dataset.data_per_client)
        cumsum = np.hstack([[0], np.cumsum(data_per_client)])
        permuted = np.hstack([
            s + self.rng.permutation(u)
            for s, u in zip(cumsum, data_per_client)])
        cur = np.zeros(self.dataset.num_clients, dtype=int)

        def sampler():
            while True:
                alive = np.where(cur < data_per_client)[0]
                if len(alive) == 0:
                    break
                n = min(self.num_workers, len(alive))
                workers = self.rng.choice(alive, n, replace=False)
                remaining = data_per_client[workers] - cur[workers]
                if self.local_batch_size == -1:
                    sizes = remaining
                else:
                    sizes = np.clip(remaining, 0, self.local_batch_size)
                idx_lists = [
                    permuted[s:s + sizes[i]]
                    for i, s in enumerate(cumsum[workers] + cur[workers])]
                yield list(zip(workers.tolist(), idx_lists))
                cur[workers] += sizes

        return _Lookahead(sampler())

    def __len__(self):
        return len(self.dataset)

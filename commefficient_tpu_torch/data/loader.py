"""Round-batch construction (numpy-only copy of ``FedLoader``,
``ValLoader``, ``PersonaFedLoader`` and ``PersonaValLoader`` from
``commefficient_tpu/data/loader.py``): sampler output -> fixed-shape
padded batches, client axis first, with a (W, B) mask for ragged
clients. ``PersonaFedLoader`` tokenizes and collates on one background
thread up to 2 rounds ahead of the consumer, as the
reference does (loader.py:252-310); the items and every RNG stream are
the reference's, the ``--dropout_prob`` client drops
(``_apply_dropout``, reference loader.py:41-65) included. A checkpoint
saves and restores the dropout stream (``_dropout_rng``) and the
PersonaChat dataset's ``_rng`` (runtime/checkpoint.py) as they stand,
the prefetched rounds' draws included, as the reference's does; the
round counter it also carries belongs to the reference's native
loader, which seeds its augmentation from it and is not ported."""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from commefficient_tpu_torch.utils import steps_per_epoch

__all__ = ["FedLoader", "ValLoader", "PersonaFedLoader",
           "PersonaValLoader"]


class FedLoader:
    """CV rounds: ``client_ids`` (W,), ``x`` (W, B, ...) f32, ``y``
    (W, B) i32, ``mask`` (W, B) f32. Rounds with fewer than
    ``num_workers`` clients are skipped, as the reference does.

    ``dropout_prob`` injects client failures: each sampled client drops
    with that probability, from the loader's own
    ``RandomState(dropout_seed)`` (``rand(W) < p`` a round), and its
    mask row is zeroed. The round leaves its state untouched and
    renormalises over the survivors; a round whose clients all dropped
    still runs, with a zero aggregate."""

    _img_shape = None

    def __init__(self, dataset, sampler, dropout_prob: float = 0.0,
                 dropout_seed: int = 0):
        self.dataset = dataset
        self.sampler = sampler
        if sampler.local_batch_size != -1:
            self.B = sampler.local_batch_size
        else:
            self.B = int(np.max(dataset.data_per_client))
        self.W = sampler.num_workers
        self.dropout_prob = dropout_prob
        self._dropout_rng = np.random.RandomState(dropout_seed)

    def _apply_dropout(self, batch: dict) -> dict:
        """Zero the dropped clients' mask rows."""
        if self.dropout_prob <= 0.0:
            return batch
        drop = self._dropout_rng.rand(self.W) < self.dropout_prob
        if drop.any():
            batch = dict(batch)
            mask = batch["mask"].copy()
            mask[drop] = 0.0
            batch["mask"] = mask
        return batch

    def __iter__(self) -> Iterator[dict]:
        for round_spec in self.sampler:
            if len(round_spec) < self.W:
                continue  # incomplete round: skip
            yield self._apply_dropout(self.collate(round_spec))

    def peek_next_client_ids(self):
        """Next round's participant ids one round ahead (the host client
        store's prefetch feed, runtime/fed_model.py; reference
        loader.py:73-84). None when the sampler cannot see ahead or the
        peeked round is incomplete (it would be skipped): the store
        then gathers synchronously, so a miss costs time, never
        correctness."""
        peek = getattr(self.sampler, "peek_next_client_ids", None)
        ids = peek() if peek is not None else None
        if ids is None or len(ids) < self.W:
            return None
        return ids

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


class PersonaFedLoader(FedLoader):
    """PersonaChat rounds (reference loader.py:226-336): ``client_ids``
    (W,), ``input_ids`` / ``token_type_ids`` / ``lm_labels`` (W, B, N,
    T) i32 (``lm_labels`` padded with -1), ``mc_token_ids`` (W, B, N),
    ``mc_labels`` (W, B) and ``mask`` (W, B) f32.

    The batches are built on ONE background thread, up to
    ``PREFETCH_DEPTH`` rounds ahead, so the host's item preparation
    overlaps the card's round. The one in-order producer keeps every
    RNG stream (sampler, the dataset's personality shuffles, dropout)
    the synchronous path's; it draws them ahead of the consumer, so a
    consumer that stops early (``--test``'s one round an epoch) leaves
    the streams where the reference's leaves them. Every put is
    stop-aware and bounded, a producer error is raised in the consumer,
    and an abandoned iterator retires its thread (5 s join). While the
    thread runs, ``peek_next_client_ids`` reads the head of its queue
    (the consumer's next round) instead of the sampler, which only the
    producer touches."""

    #: rounds the producer may run ahead (the reference's default)
    PREFETCH_DEPTH = 2

    def __init__(self, dataset, sampler, num_candidates: int,
                 max_seq_len: int, pad_id: int = 0,
                 dropout_prob: float = 0.0, dropout_seed: int = 0):
        super().__init__(dataset, sampler, dropout_prob, dropout_seed)
        self.N, self.T, self.pad_id = num_candidates, max_seq_len, pad_id
        # the running producer's queue; None when no thread runs
        self._queue = None
        self.thread = None

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH_DEPTH)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # bounded and stop-aware: an abandoning consumer can never
            # leave this thread blocked past the join
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for batch in FedLoader.__iter__(self):
                    if stop.is_set() or not put_or_stop(("batch", batch)):
                        return
            except BaseException as e:  # raised again in the consumer
                put_or_stop(("error", e))
                return
            put_or_stop(("done", None))

        t = threading.Thread(target=produce, daemon=True,
                             name="persona-prefetch")
        self._queue, self.thread = q, t
        t.start()
        try:
            while True:
                kind, val = q.get()
                if kind == "batch":
                    yield val
                elif kind == "error":
                    raise val
                else:
                    break
        finally:
            # abandoned mid-epoch (--test, a divergence stop) or done:
            # unblock and retire the producer, so it cannot race a later
            # epoch's iteration of the same sampler
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
            self._queue = None

    def peek_next_client_ids(self):
        """The consumer's next round's ids: the head of the producer's
        queue while the thread runs (None when it has not produced that
        round yet, a prefetch miss), else the sampler's lookahead."""
        q = self._queue
        if q is None:
            return super().peek_next_client_ids()
        with q.mutex:
            head = q.queue[0] if q.queue else None
        if head is None or head[0] != "batch":
            return None
        return head[1]["client_ids"]

    def collate(self, round_spec) -> dict:
        from commefficient_tpu_torch.data.fed_persona import persona_collate
        W, B, N, T = self.W, self.B, self.N, self.T
        batch = {
            "input_ids": np.zeros((W, B, N, T), np.int32),
            "token_type_ids": np.zeros((W, B, N, T), np.int32),
            "lm_labels": np.full((W, B, N, T), -1, np.int32),
            "mc_token_ids": np.zeros((W, B, N), np.int32),
            "mc_labels": np.zeros((W, B), np.int32),
            "mask": np.zeros((W, B), np.float32),
        }
        ids = np.zeros((W,), np.int32)
        for i, (cid, idxs) in enumerate(round_spec):
            ids[i] = cid
            records = [self.dataset[int(ix)] for ix in idxs[:B]]
            assert all(r[0] == cid for r in records)
            _, arrs = persona_collate(records, N, T, self.pad_id)
            n = len(records)
            for k in ("input_ids", "token_type_ids", "lm_labels",
                      "mc_token_ids", "mc_labels"):
                batch[k][i, :n] = arrs[k]
            batch["mask"][i, :n] = 1.0
        batch["client_ids"] = ids
        return batch


class PersonaValLoader(ValLoader):
    """PersonaChat validation shards (reference loader.py:338-417): the
    arrays of ``PersonaFedLoader`` with a shard axis S first, plus
    ``cand_mask`` (S, B, N), 1 on real candidate slots."""

    def __init__(self, dataset, valid_batch_size: int,
                 num_candidates: int, max_seq_len: int, pad_id: int = 0,
                 shards_per_step: int = 8):
        super().__init__(dataset, valid_batch_size, shards_per_step)
        self.N, self.T, self.pad_id = num_candidates, max_seq_len, pad_id

    def __iter__(self):
        from commefficient_tpu_torch.data.fed_persona import persona_collate
        S, B, N, T = self.S, self.B, self.N, self.T
        n_items = len(self.dataset)
        for start in range(0, n_items, B * S):
            idxs = np.arange(start, min(start + B * S, n_items))
            batch = {
                "input_ids": np.zeros((S, B, N, T), np.int32),
                "token_type_ids": np.zeros((S, B, N, T), np.int32),
                "lm_labels": np.full((S, B, N, T), -1, np.int32),
                "mc_token_ids": np.zeros((S, B, N), np.int32),
                "mc_labels": np.zeros((S, B), np.int32),
                "cand_mask": np.zeros((S, B, N), np.float32),
                "mask": np.zeros((S, B), np.float32),
            }
            for s in range(S):
                rows = idxs[s * B:(s + 1) * B]
                if len(rows) == 0:
                    break
                records = [self.dataset[int(ix)] for ix in rows]
                _, arrs = persona_collate(records, N, T, self.pad_id)
                n = len(records)
                for k in ("input_ids", "token_type_ids", "lm_labels",
                          "mc_token_ids", "mc_labels", "cand_mask"):
                    batch[k][s, :n] = arrs[k]
                batch["mask"][s, :n] = 1.0
            yield batch

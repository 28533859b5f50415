"""Federated round scheduler (numpy-only copy of
``commefficient_tpu/data/fed_sampler.py``): shuffle within each
client, then each round sample ``num_workers`` non-exhausted clients
without replacement and take up to ``local_batch_size`` records from
each (-1 = the client's whole remaining data); an epoch ends when every
client is exhausted. Same seed, same cohorts as the reference. The
one-round lookahead is peekable (``peek_next_client_ids``, the host
client store's prefetch feed), and ``export_state``/``import_state``
carry a live epoch across a mid-epoch checkpoint (reference :67-130)."""

from __future__ import annotations

import numpy as np

__all__ = ["FedSampler"]


class _Lookahead:
    """Iterator that buffers ONE item ahead so the round spec the
    consumer will receive next is peekable — the client-store prefetch
    thread (runtime/fed_model.py) needs round N+1's participant ids
    while round N computes. Each underlying draw happens one ``next``
    earlier than it would unbuffered, but the draw ORDER (and hence
    the sampler RNG stream a checkpoint captures) is unchanged."""

    def __init__(self, it):
        self._it = it
        self._buf = None
        self._has = False
        self._advance()

    def _advance(self):
        try:
            self._buf = next(self._it)
            self._has = True
        except StopIteration:
            self._buf = None
            self._has = False

    def peek(self):
        return self._buf if self._has else None

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
        self._lookahead = None
        # live epoch arrays (set by __iter__) — what export_state
        # captures for mid-epoch checkpointing
        self._permuted = None
        self._cur = None
        self._resume_state = None

    def peek_next_client_ids(self):
        """Participant ids of the round the active iterator will yield
        NEXT, or None (no active iterator / epoch exhausted)."""
        la = self._lookahead
        spec = la.peek() if la is not None else None
        if spec is None:
            return None
        return [cid for cid, _ in spec]

    def export_state(self):
        """Mid-epoch snapshot for the round-cadence autosaver
        (runtime/checkpoint.py). Captures the live epoch arrays, the
        RNG (AFTER the lookahead's one-ahead draw) and the buffered
        round spec, so a resumed iterator replays the remaining
        rounds bit-exactly: the buffered spec is re-yielded first,
        then the generator continues from the restored cursor/RNG.
        None when no epoch iterator is active (epoch boundary — the
        plain end-of-epoch RNG capture suffices there)."""
        if self._lookahead is None or self._permuted is None:
            return None
        spec = self._lookahead.peek()
        state = {
            "permuted": np.asarray(self._permuted).copy(),
            "cur": np.asarray(self._cur).copy(),
        }
        if isinstance(self.rng, np.random.RandomState):
            state["rng_state"] = self.rng.get_state()
        if spec is not None:
            state["spec_workers"] = np.asarray(
                [cid for cid, _ in spec], np.int64)
            state["spec_sizes"] = np.asarray(
                [len(ix) for _, ix in spec], np.int64)
            state["spec_idx"] = (np.concatenate(
                [np.asarray(ix, np.int64) for _, ix in spec])
                if spec else np.zeros((0,), np.int64))
        return state

    def import_state(self, state):
        """Arm the NEXT ``__iter__`` to continue the exported epoch
        instead of starting a fresh one (one-shot)."""
        self._resume_state = state

    def _consume_resume(self):
        state = self._resume_state
        self._resume_state = None
        if isinstance(self.rng, np.random.RandomState) \
                and state.get("rng_state") is not None:
            self.rng.set_state(state["rng_state"])
        permuted = np.asarray(state["permuted"])
        cur = np.asarray(state["cur"]).copy()
        pending = None
        if state.get("spec_workers") is not None \
                and len(state["spec_workers"]):
            workers = [int(w) for w in state["spec_workers"]]
            sizes = [int(s) for s in state["spec_sizes"]]
            idx = np.asarray(state["spec_idx"])
            lists, off = [], 0
            for s in sizes:
                lists.append(idx[off:off + s])
                off += s
            pending = (workers, sizes, list(zip(workers, lists)))
        return permuted, cur, pending

    def __iter__(self):
        data_per_client = np.asarray(self.dataset.data_per_client)
        cumsum = np.hstack([[0], np.cumsum(data_per_client)])
        pending = None
        if self._resume_state is not None:
            permuted, cur, pending = self._consume_resume()
        else:
            permuted = np.hstack([
                s + self.rng.permutation(u)
                for s, u in zip(cumsum, data_per_client)])
            cur = np.zeros(self.dataset.num_clients, dtype=int)
        self._permuted, self._cur = permuted, cur

        def sampler():
            if pending is not None:
                p_workers, p_sizes, p_spec = pending
                yield p_spec
                cur[p_workers] += p_sizes
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
                # per-client index lists (the engine wants them grouped,
                # unlike the reference's flat concatenation which the
                # server re-groups, fed_aggregator.py:219-225)
                idx_lists = [
                    permuted[s:s + sizes[i]]
                    for i, s in enumerate(cumsum[workers] + cur[workers])]
                yield list(zip(workers.tolist(), idx_lists))
                cur[workers] += sizes

        self._lookahead = _Lookahead(sampler())
        return self._lookahead

    def __len__(self):
        return len(self.dataset)

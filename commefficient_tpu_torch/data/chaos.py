"""Deterministic adversary and dropout-trace injection (the chaos
harness), byzantine and dropout-trace half.

Port of ``commefficient_tpu/data/chaos.py`` (``ChaosConfig`` :62,
``ChaosInjector`` :92 with ``poison_batch`` :123,
``transmit_transform`` :137, ``drop_slots`` :190, ``wrap_loader`` :198,
and ``_ChaosLoader``). Everything is seeded and replayable: the same
``ChaosConfig`` gives the same byzantine client set and the same
dropout trace on every run.

Byzantine clients
    A seeded subset of client ids turns adversarial. ``label_flip``
    poisons the data (y -> (num_classes-1) - y on the byzantine rows,
    by ``wrap_loader``). ``sign_flip`` (transmit x -1), ``scale``
    (transmit x C) and ``noise`` (transmit replaced by
    N(0, noise_std²) times the client's datapoint count) act on the
    per-client transmit stack in the round, through the function
    ``transmit_transform`` returns, passed to
    ``build_client_round(..., transmit_transform=...)``.

Dropout traces
    Beside the loader's i.i.d. ``--dropout_prob``: a seeded two-state
    Markov chain (calm/burst) drops a correlated subset of the round's
    client slots for the whole burst.

No module of the port's round, runtime or trainers imports this file:
the round's hook is a plain parameter, and the attacks live here, for
tests and scripts.

Arrival schedules (``ArrivalSchedule``, reference :241-362): when each
issued client's update lands, in fold steps, for the asynchronous
rounds' driver (asyncfed/), attached with
``FedModel.attach_arrival_process``; no module of the port builds one.

Host faults (reference :363-447): ``PreemptionDrill`` signals this
process once at a seeded round, ``FlakyStore`` makes a client store's
gathers fail or stall on a seeded schedule, and ``kill_prefetch_worker``
marks a ``StorePrefetcher``'s worker dead, and ``wrap_loader`` sleeps
``straggler_delay_s`` on every ``straggler_every``-th round (reference
:198-208).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

__all__ = ["ATTACKS", "ArrivalSchedule", "ChaosConfig", "ChaosInjector",
           "FlakyStore", "PreemptionDrill", "kill_prefetch_worker"]

ATTACKS = ("none", "label_flip", "sign_flip", "scale", "noise")


@dataclasses.dataclass
class ChaosConfig:
    """One replayable fault scenario. Every schedule derives from
    ``seed``; a field's zero value disables that fault family."""

    seed: int = 0
    # -- byzantine clients ------------------------------------------
    attack: str = "none"
    byzantine_frac: float = 0.0        # fraction of the client pool
    byzantine_ids: Optional[Sequence[int]] = None  # explicit override
    attack_scale: float = 10.0         # C for the "scale" attack
    noise_std: float = 1.0             # sigma for the "noise" attack
    num_classes: int = 0               # required for label_flip
    # -- correlated dropout trace -----------------------------------
    burst_start_prob: float = 0.0      # calm -> burst per round
    burst_stop_prob: float = 0.5       # burst -> calm per round
    burst_drop_frac: float = 0.5       # slots dropped during a burst
    # -- host faults ------------------------------------------------
    shard_fail_prob: float = 0.0       # FlakyStore transient failures
    shard_fail_streak: int = 1         # consecutive failures per hit
    shard_delay_s: float = 0.0         # FlakyStore read latency
    straggler_every: int = 0           # every Nth round is a straggler
    straggler_delay_s: float = 0.0     # how long the slow lane sleeps

    def __post_init__(self):
        assert self.attack in ATTACKS, self.attack
        if self.attack == "label_flip":
            assert self.num_classes > 1, \
                "label_flip needs ChaosConfig.num_classes"


# the noise attack's stream tag (the reference folds 7 into its
# (round key, seed + 2) key)
_NOISE_ATTACK_TAG = 7


class ChaosInjector:
    """One ``ChaosConfig`` against a pool of ``num_clients`` clients."""

    def __init__(self, cfg: ChaosConfig, num_clients: int):
        self.cfg = cfg
        self.num_clients = int(num_clients)
        rng = np.random.RandomState(cfg.seed)
        if cfg.byzantine_ids is not None:
            ids = np.asarray(sorted(set(int(i) for i
                                        in cfg.byzantine_ids)), np.int32)
        elif cfg.attack != "none" and cfg.byzantine_frac > 0:
            k = max(1, int(round(cfg.byzantine_frac * num_clients)))
            ids = np.sort(rng.choice(num_clients, size=min(
                k, num_clients), replace=False)).astype(np.int32)
        else:
            ids = np.zeros((0,), np.int32)
        self.byzantine = ids
        # independent streams: toggling one fault family never moves
        # another's schedule
        self._drop_rng = np.random.RandomState(cfg.seed + 1)
        self._noise_seed = cfg.seed + 2
        self._in_burst = False
        self._burst_slots: Optional[np.ndarray] = None
        self._round = 0

    # -- byzantine side ---------------------------------------------

    def is_byzantine(self, client_ids) -> np.ndarray:
        return np.isin(np.asarray(client_ids), self.byzantine)

    def poison_batch(self, batch: dict) -> dict:
        """label_flip: y -> (num_classes-1) - y on the byzantine rows.
        The other attacks act on transmits: a no-op here."""
        if self.cfg.attack != "label_flip" or "y" not in batch:
            return batch
        bad = self.is_byzantine(batch["client_ids"])
        if not bad.any():
            return batch
        batch = dict(batch)
        y = batch["y"].copy()
        y[bad] = (self.cfg.num_classes - 1) - y[bad]
        batch["y"] = y
        return batch

    def transmit_transform(self):
        """``(transmit, batch, client_ids, round_index, slots=None) ->
        transmit`` for ``build_client_round``, or None where the attack
        acts on the data. Membership in the byzantine set is tested on
        the device (``torch.isin``), so no client id is read on the
        host. The noise attack draws from a generator on the transmit's
        device seeded by (seed + 2, round, 7) (privacy/mechanism.py
        ``noise_generator``): the same round gives the same bits. On a
        mesh rank ``slots`` is ``(first slot, the round's W)``: the draw
        is the whole round's and the rank keeps its slots' noise."""
        if self.cfg.attack not in ("sign_flip", "scale", "noise"):
            return None
        from commefficient_tpu_torch.privacy.mechanism import (
            gaussian_noise, noise_generator)
        byz_np = self.byzantine.astype(np.int64)
        attack = self.cfg.attack
        C = float(self.cfg.attack_scale)
        sigma = float(self.cfg.noise_std)
        noise_seed = self._noise_seed

        def transform(transmit, batch, client_ids, round_index,
                      slots=None):
            if byz_np.size == 0:
                return transmit
            byz = torch.as_tensor(byz_np, device=transmit.device)
            bad = torch.isin(client_ids.to(transmit.device, torch.int64),
                             byz)
            badx = bad.reshape((-1,) + (1,) * (transmit.ndim - 1))
            if attack == "sign_flip":
                evil = -transmit
            elif attack == "scale":
                evil = C * transmit
            else:  # sigma * N(0, 1) * datapoint count, scaled as an
                # honest transmit is by its batch size
                mask = batch["mask"]
                n = torch.sum(mask.reshape(mask.shape[0], -1), dim=1)
                gen = noise_generator(noise_seed, round_index,
                                      _NOISE_ATTACK_TAG, transmit.device)
                lo, w = (0, transmit.shape[0]) if slots is None else slots
                noise = gaussian_noise(gen, (w,) + tuple(transmit.shape[1:]),
                                       transmit.dtype, std=sigma)
                evil = (noise[lo:lo + transmit.shape[0]]
                        * n.reshape(badx.shape))
            return torch.where(badx, evil, transmit)

        return transform

    # -- dropout trace ----------------------------------------------

    def _advance_burst(self, W: int):
        c = self.cfg
        if self._in_burst:
            if self._drop_rng.rand() < c.burst_stop_prob:
                self._in_burst, self._burst_slots = False, None
        elif c.burst_start_prob > 0 \
                and self._drop_rng.rand() < c.burst_start_prob:
            self._in_burst = True
            k = max(1, int(round(c.burst_drop_frac * W)))
            self._burst_slots = self._drop_rng.choice(
                W, size=min(k, W), replace=False)

    def drop_slots(self, W: int) -> Optional[np.ndarray]:
        """This round's correlated-drop slot indices (None when calm);
        the same subset for the burst's whole lifetime."""
        self._advance_burst(W)
        return self._burst_slots if self._in_burst else None

    # -- loader wrapping --------------------------------------------

    def wrap_loader(self, loader) -> Iterator[dict]:
        """Iterate ``loader`` with the data poisoning, the correlated
        dropout trace and the straggler sleeps applied, in round
        order."""
        c = self.cfg
        for batch in loader:
            self._round += 1
            if c.straggler_every > 0 and c.straggler_delay_s > 0 \
                    and self._round % c.straggler_every == 0:
                time.sleep(c.straggler_delay_s)
            batch = self.poison_batch(batch)
            slots = self.drop_slots(batch["mask"].shape[0])
            if slots is not None and len(slots):
                batch = dict(batch)
                mask = batch["mask"].copy()
                mask[slots] = 0.0
                batch["mask"] = mask
            yield batch

    def wrap(self, loader):
        return _ChaosLoader(self, loader)


class _ChaosLoader:
    """Loader facade: chaos-wrapped iteration, everything else (len,
    W, B) delegated."""

    def __init__(self, injector: ChaosInjector, loader):
        self._injector = injector
        self._loader = loader

    def __iter__(self):
        return self._injector.wrap_loader(self._loader)

    def __len__(self):
        return len(self._loader)

    def __getattr__(self, name):
        return getattr(self._loader, name)


class ArrivalSchedule:
    """Seeded, replayable per-client arrival process: when each issued
    client's update lands, in fold steps (reference ``ArrivalSchedule``,
    data/chaos.py:241). Three kinds:

    ``uniform``
        Every client arrives the round it was issued (delay 0); with
        ``--async_buffer_size`` at the cohort size this is the
        synchronous round.
    ``churny``
        Each client is late with probability ``churn_frac``, by
        1..``max_delay`` rounds, independently.
    ``bursty``
        A two-state Markov chain (calm/burst, the transition logic of
        ``ChaosInjector.drop_slots``) delays a correlated ``drop_frac``
        subset of each issued cohort by ``max_delay`` rounds for the
        burst's whole lifetime.

    Delays come from one sequential ``np.random.RandomState(seed)``
    stream, drawn in the reference's order, so the same seed replays
    the reference's trace bit for bit; ``reset()`` rewinds it.
    Instances are callable as ``(round_index, n) -> delays``, the
    signature of ``AsyncRoundDriver.attach_arrival_process``."""

    KINDS = ("uniform", "churny", "bursty")

    def __init__(self, kind: str = "uniform", seed: int = 0,
                 max_delay: int = 4, churn_frac: float = 0.5,
                 burst_start_prob: float = 0.15,
                 burst_stop_prob: float = 0.5,
                 drop_frac: float = 0.5):
        assert kind in self.KINDS, kind
        assert max_delay >= 1, "max_delay must be >= 1"
        self.kind = kind
        self.seed = int(seed)
        self.max_delay = int(max_delay)
        self.churn_frac = float(churn_frac)
        self.burst_start_prob = float(burst_start_prob)
        self.burst_stop_prob = float(burst_stop_prob)
        self.drop_frac = float(drop_frac)
        self.reset()

    def reset(self) -> None:
        """Rewind to round 0 of the trace."""
        self._rng = np.random.RandomState(self.seed)
        self._in_burst = False
        self._burst_slots: Optional[np.ndarray] = None
        self._round = 0

    def delays(self, n: int) -> np.ndarray:
        """Arrival delays (int64, >= 0) of the next issued cohort of
        ``n`` clients. Consumes the stream: call in round order."""
        self._round += 1
        if self.kind == "uniform":
            return np.zeros((n,), np.int64)
        if self.kind == "churny":
            late = self._rng.rand(n) < self.churn_frac
            lag = self._rng.randint(1, self.max_delay + 1, size=n)
            return np.where(late, lag, 0).astype(np.int64)
        # bursty: advance the calm/burst chain, then stall the burst's
        # slot subset by the full max_delay
        if self._in_burst:
            if self._rng.rand() < self.burst_stop_prob:
                self._in_burst, self._burst_slots = False, None
        elif self.burst_start_prob > 0 \
                and self._rng.rand() < self.burst_start_prob:
            self._in_burst = True
            k = max(1, int(round(self.drop_frac * n)))
            self._burst_slots = self._rng.choice(
                n, size=min(k, n), replace=False)
        out = np.zeros((n,), np.int64)
        if self._in_burst and self._burst_slots is not None:
            out[self._burst_slots[self._burst_slots < n]] = self.max_delay
        return out

    def __call__(self, round_index: int, n: int) -> np.ndarray:
        return self.delays(n)

    @staticmethod
    def replay_stats(alive: Sequence[float], cohort: int) -> dict:
        """Burst statistics of a replayed trace from the per-round alive
        fractions a run observed (reference :333): bursts, burst rounds,
        the longest burst, the alive fraction's minimum and mean, and
        the client rounds lost."""
        alive = [float(a) for a in alive]
        ragged = [a for a in alive if a < 1.0]
        burst_rounds, bursts, in_burst = 0, 0, False
        longest, cur = 0, 0
        for a in alive:
            if a < 1.0:
                burst_rounds += 1
                cur += 1
                if not in_burst:
                    bursts += 1
                in_burst = True
                longest = max(longest, cur)
            else:
                in_burst, cur = False, 0
        return {
            "burst_count": bursts,
            "burst_rounds": burst_rounds,
            "longest_burst": longest,
            "alive_frac_min": round(min(alive), 3) if alive else 1.0,
            "alive_frac_mean": round(sum(alive) / max(len(alive), 1), 3),
            "dropped_client_rounds": round(
                sum(1.0 - a for a in ragged) * cohort),
        }


class PreemptionDrill:
    """Seeded self-preemption: kill THIS process mid-round, once.

    The elastic-restore drill's first act. A seeded RandomState picks
    the kill round from ``[min_round, max_round]`` and the signal from
    ``signals`` (SIGTERM for the graceful-shutdown path, SIGKILL for
    the torn-write path), so the same seed always dies at the same
    point — a failed drill is a repro, not a flake. The driving test
    calls :meth:`should_kill` each round at the chosen fault point
    (between forward and fold, after the autosave, wherever it wants
    the cut) and :meth:`execute` delivers the signal to ``os.getpid``.

    Like everything in this module the drill is test/bench-only; the
    survivor half of the story (restart on fewer hosts, resume from
    the last valid autosave, converge-or-alarm) lives in the chaos
    tests, not here.
    """

    def __init__(self, seed: int = 0, min_round: int = 1,
                 max_round: int = 4,
                 signals: Sequence[int] = (signal.SIGTERM,
                                           signal.SIGKILL)):
        assert 0 <= min_round <= max_round
        rng = np.random.RandomState(seed)
        self.kill_round = int(rng.randint(min_round, max_round + 1))
        self.signal = int(signals[int(rng.randint(len(signals)))])
        self.fired = False

    def should_kill(self, round_index: int) -> bool:
        """True once ``round_index`` reaches the drawn kill round (and
        the drill has not fired yet)."""
        return not self.fired and int(round_index) >= self.kill_round

    def execute(self) -> None:
        """Deliver the drawn signal to this process. SIGKILL never
        returns; SIGTERM returns to let the harness's handler (e.g.
        ``sigterm_raises``) unwind the run."""
        self.fired = True
        os.kill(os.getpid(), self.signal)


class FlakyStore:
    """Clientstore wrapper whose ``gather`` transiently fails and/or
    stalls on a seeded schedule — the fixture behind the prefetch
    retry/backoff tests. A scheduled hit raises for
    ``shard_fail_streak`` consecutive attempts, then succeeds: with
    bounded retry (3 tries) a streak of 2 recovers invisibly and a
    streak of 3+ surfaces as the worker-death RuntimeError."""

    def __init__(self, store, cfg: ChaosConfig):
        self._store = store
        self._cfg = cfg
        self._rng = np.random.RandomState(cfg.seed + 3)
        self._streak_left = 0
        self.attempts = 0
        self.failures = 0

    def gather(self, ids, out=None):
        self.attempts += 1
        if self._cfg.shard_delay_s > 0:
            time.sleep(self._cfg.shard_delay_s)
        if self._streak_left == 0 \
                and self._cfg.shard_fail_prob > 0 \
                and self._rng.rand() < self._cfg.shard_fail_prob:
            self._streak_left = max(1, int(self._cfg.shard_fail_streak))
        if self._streak_left > 0:
            self._streak_left -= 1
            self.failures += 1
            raise OSError("chaos: transient shard read failure")
        return self._store.gather(ids, out=out)

    def __getattr__(self, name):
        return getattr(self._store, name)


def kill_prefetch_worker(prefetcher) -> None:
    """Simulate a prefetch-worker crash: poison the work queue so the
    worker thread exits its loop as if it had died mid-run. The next
    ``take``/``submit`` must surface the worker-death
    RuntimeError rather than hang."""
    fail = getattr(prefetcher, "_fail_for_test", None)
    if callable(fail):
        fail(RuntimeError("chaos: prefetch worker killed"))
        return
    raise RuntimeError("prefetcher exposes no kill hook")

"""The chaos harness's straggler sleeps (``ChaosConfig.straggler_every``
and ``straggler_delay_s``, ``ChaosInjector.wrap_loader``) against the
reference's: with ``time.sleep`` replaced by a recorder, the sleeps
fall on the same rounds for the same seconds, and the batches that come
out are the reference's, bit for bit, and the unwrapped loader's where
no other fault is armed.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import time

import numpy as np
import pytest

from commefficient_tpu.data.chaos import ChaosConfig as JaxChaosConfig
from commefficient_tpu.data.chaos import ChaosInjector as JaxInjector
from commefficient_tpu_torch.data.chaos import ChaosConfig, ChaosInjector


def _batches(n=13):
    rs = np.random.RandomState(1)
    return [{"client_ids": rs.choice(20, 6, replace=False).astype(np.int32),
             "y": rs.randint(0, 10, (6, 4)).astype(np.int32),
             "mask": np.ones((6, 4), np.float32)} for _ in range(n)]


def _sleeps(monkeypatch, injector, batches):
    """(the batches out, [(round, seconds)] of each sleep)."""
    seen, out = [], []
    monkeypatch.setattr(time, "sleep",
                        lambda s: seen.append((len(out) + 1, s)))
    for batch in injector.wrap(batches):
        out.append(batch)
    return out, seen


@pytest.mark.parametrize("kw", [
    dict(seed=2, straggler_every=3, straggler_delay_s=0.25),
    dict(seed=4, straggler_every=1, straggler_delay_s=0.5,
         attack="label_flip", byzantine_frac=0.3, num_classes=10,
         burst_start_prob=0.4),
    dict(seed=6, straggler_every=4, straggler_delay_s=0.0),
    dict(seed=6, straggler_every=0, straggler_delay_s=1.0),
], ids=["every-3", "every-1-with-faults", "no-delay", "off"])
def test_straggler_sleeps_fall_on_the_reference_rounds(monkeypatch, kw):
    batches = _batches()
    ours, our_sleeps = _sleeps(monkeypatch,
                               ChaosInjector(ChaosConfig(**kw), 20), batches)
    theirs, their_sleeps = _sleeps(
        monkeypatch, JaxInjector(JaxChaosConfig(**kw), 20), batches)
    assert our_sleeps == their_sleeps
    every, delay = kw["straggler_every"], kw["straggler_delay_s"]
    want = ([(r, delay) for r in range(1, len(batches) + 1)
             if r % every == 0] if every > 0 and delay > 0 else [])
    assert our_sleeps == want
    assert len(ours) == len(theirs) == len(batches)
    plain = "attack" not in kw
    for a, b, c in zip(ours, theirs, batches):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])
            if plain:
                np.testing.assert_array_equal(a[key], c[key])

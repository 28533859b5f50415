"""GPT-2 at ``--pipeline_depth`` > 1, and the sync-free support
compaction it needs, on the CPU.

- ``threshold_topk_indices`` (the threshold mask compacted by a prefix
  count and a ``searchsorted``, ``ops/topk.py compact_mask``) equals the
  reference's hierarchical extraction exactly: d on both sides of 2^20,
  heavy ties, all-zero input, k = 1 and k near d.
- The sparse re-sketch's scatter without ``index_put_``'s range check
  sums as ``index_put_(accumulate=True)`` does, bit for bit.
- The trainer at depth 3 (the tiny model, whose d is past the 90*r*k
  gate, so its server takes the sparse re-sketch branch) gives depth
  1's per-round losses, validation numbers and byte totals exactly.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops.topk import \
    threshold_topk_indices as jax_threshold_topk_indices
from commefficient_tpu_torch.data import fed_persona
from commefficient_tpu_torch.ops.sketch import CountSketch
from commefficient_tpu_torch.ops.topk import (compact_mask,
                                              threshold_topk_indices)
from commefficient_tpu_torch.train import gpt2_train


def _values(kind, d, rng):
    if kind == "normal":
        return rng.randn(d).astype(np.float32)
    if kind == "ties":  # four distinct magnitudes over all d
        return rng.randint(-2, 2, d).astype(np.float32)
    assert kind == "zeros"
    return np.zeros(d, np.float32)


@pytest.mark.parametrize("d,k,kind", [
    (1000, 37, "normal"),
    ((1 << 20) - 3, 5000, "ties"),
    ((1 << 20) + 7, 50_000, "normal"),
    ((1 << 20) + 7, 1, "ties"),
    ((1 << 20) + 7, (1 << 20) - 2, "ties"),
    ((1 << 20) + 5, 100, "zeros"),
])
def test_threshold_topk_indices_match_the_reference(d, k, kind):
    rng = np.random.RandomState(d % 97 + k)
    v = _values(kind, d, rng)
    sq = v * v
    want = np.asarray(jax.jit(jax_threshold_topk_indices,
                              static_argnums=1)(jnp.asarray(sq), k))
    got = threshold_topk_indices(torch.from_numpy(sq), k)
    assert got.dtype == torch.int64 and got.shape == (k,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d,k", [(1, 1), (9, 9), (4096, 1), (70_001, 513)])
def test_compact_mask_is_nonzero_of_an_exactly_k_mask(d, k):
    rng = np.random.RandomState(d)
    mask = torch.zeros(d, dtype=torch.bool)
    mask[torch.from_numpy(rng.choice(d, k, replace=False))] = True
    got = compact_mask(mask, k)
    assert got.shape == (k,)
    assert torch.equal(got, torch.nonzero(mask).flatten())


def test_sparse_resketch_sums_as_index_put_accumulate():
    # r * n = 10 000 updates stay below the CPU kernel's parallel grain,
    # where index_put_(accumulate=True) itself sums in a fixed order
    sketch = CountSketch(d=3_000_017, c=409, r=5, seed=7)
    rng = np.random.RandomState(0)
    idx = torch.from_numpy(np.sort(rng.choice(sketch.d, 2000,
                                              replace=False)))
    vals = torch.from_numpy(rng.randn(2000).astype(np.float32))
    buckets, signs = sketch.hashes(idx)
    want = torch.zeros((sketch.r, sketch.c))
    rows = torch.arange(sketch.r)[:, None].expand_as(buckets)
    want.index_put_((rows, buckets), signs * vals[None, :], accumulate=True)
    assert torch.equal(sketch.sketch_sparse(idx, vals), want)


ARGV = ["--dataset_name", "PERSONA", "--mode", "sketch", "--error_type",
        "virtual", "--local_momentum", "0", "--virtual_momentum", "0.9",
        "--num_workers", "2", "--local_batch_size", "2",
        "--valid_batch_size", "2", "--num_epochs", "2", "--seed", "5",
        "--k", "10", "--num_cols", "100", "--num_rows", "1"]


def test_pipelined_trainer_equals_depth_1(tmp_path, monkeypatch):
    # without --test the runs save their final models into ./runs
    monkeypatch.chdir(tmp_path)
    fed_persona.generate_synthetic_personachat(str(tmp_path / "data"))
    argv = ["--device", "cpu", "--dataset_dir", str(tmp_path / "data")] \
        + ARGV
    flushes = []
    base = gpt2_train.FedModel

    class Recording(base):
        def flush(self, force=True):
            out = super().flush(force)
            if out:
                flushes.append(len(out))
            return out

    monkeypatch.setattr(gpt2_train, "FedModel", Recording)
    one = gpt2_train.main(argv)
    assert not flushes
    three = gpt2_train.main(argv + ["--pipeline_depth", "3"])
    assert len(one) == len(three) == 2
    assert sum(flushes) == sum(len(r["round_losses"]) for r in three) > 4
    assert max(flushes) == 3
    for a, b in zip(one, three):
        assert a["round_losses"] == b["round_losses"]
        for key in ("train_loss", "val_nll", "val_acc", "up (MiB)",
                    "down (MiB)"):
            assert a[key] == b[key], key

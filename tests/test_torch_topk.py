"""The port's exact threshold select against the JAX package's, on the
CPU. The JAX side runs ``threshold_topk_mask_1d`` with ``force_xla``
and, where the Pallas kernel applies, ``interpret=True``; the port
runs the nibble search and the take-mask kernel's plain version.
Tolerance: none -- the same keys give the same threshold and the same
mask, bit for bit (exactly k set, the lowest index winning ties)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops.topk import _nibble_threshold_key as jax_nibble
from commefficient_tpu.ops.topk import threshold_topk_mask_1d as jax_mask
from commefficient_tpu.ops.topk import selection_may_duplicate as jax_dup
from commefficient_tpu.ops.topk import use_threshold_select as jax_gate
from commefficient_tpu.ops.topk_pallas import _CHUNK
from commefficient_tpu_torch.ops.topk import (_nibble_threshold_key,
                                              keys_of,
                                              selection_may_duplicate,
                                              threshold_topk_mask_1d,
                                              use_threshold_select)
from commefficient_tpu_torch.ops.topk_kernels import (take_mask_kernel,
                                                      take_mask_plain)


def _sq(d, seed, ties=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(d).astype(np.float32)
    if ties:
        x[rng.randint(0, d, 200)] = 1.5  # magnitude ties
        x[rng.randint(0, d, 200)] = 0.0
    return np.square(x)


def _port_mask(sq, k):
    return threshold_topk_mask_1d(torch.from_numpy(sq), k).numpy()


@pytest.mark.parametrize("d,k", [(_CHUNK, 100), (_CHUNK + 7, 513),
                                 (3 * _CHUNK + 11, 5000), (4096, 17),
                                 (100_000, 99_999)])
def test_mask_matches_xla(d, k):
    sq = _sq(d, d % 97)
    want = np.asarray(jax_mask(jnp.asarray(sq), k, force_xla=True))
    got = _port_mask(sq, k)
    assert got.sum() == k
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d,k", [(_CHUNK + 7, 513), (2 * _CHUNK + 3, 70)])
def test_mask_matches_pallas_interpret(d, k):
    sq = _sq(d, 3)
    want = np.asarray(jax_mask(jnp.asarray(sq), k, interpret=True))
    np.testing.assert_array_equal(_port_mask(sq, k), want)


def test_all_equal_takes_first_k():
    d, k = 2 * _CHUNK, _CHUNK + 17
    got = _port_mask(np.ones(d, np.float32), k)
    assert got.sum() == k
    assert got[:k].all() and not got[k:].any()


def test_zero_threshold_edge():
    """k exceeds the nonzero count: T == 0, and the first zeros in
    index order fill the rest."""
    d = _CHUNK + 100
    k = d - 3
    rng = np.random.RandomState(9)
    x = np.zeros(d, np.float32)
    x[rng.choice(d, 50, replace=False)] = rng.randn(50)
    sq = np.square(x)
    want = np.asarray(jax_mask(jnp.asarray(sq), k, force_xla=True))
    got = _port_mask(sq, k)
    assert got.sum() == k
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d,k", [(4096, 17), (100_000, 5000),
                                 (5000, 4999)])
def test_nibble_key_bit_exact(d, k):
    sq = _sq(d, d)
    keys = jax.lax.bitcast_convert_type(jnp.asarray(sq), jnp.uint32)
    want = int(jax_nibble(keys, k))
    got = int(_nibble_threshold_key(keys_of(torch.from_numpy(sq)), k))
    assert got == want


@pytest.mark.parametrize("need", [0, -3, 1, 40])
def test_take_mask_need_edges(need):
    sq = torch.from_numpy(_sq(3 * 2048 + 11, 1))
    keys = keys_of(sq)
    t = _nibble_threshold_key(keys, 513)
    got = take_mask_kernel(sq, t, torch.tensor(need))
    eq = (keys == t).numpy()
    gt = (keys > t).numpy()
    ranks = np.cumsum(eq)
    np.testing.assert_array_equal(got.numpy(),
                                  gt | (eq & (ranks <= need)))
    np.testing.assert_array_equal(
        got.numpy(), take_mask_plain(sq, t, torch.tensor(need)).numpy())


def test_gates_match_reference():
    for k, d, approx in ((50_000, 6_584_000, False), (10, 100, False),
                         (50_000, 6_584_000, True), (5, 5, False),
                         (5000, 1 << 20, False)):
        assert use_threshold_select(k, d, approx) == jax_gate(k, d, approx)
        assert selection_may_duplicate(d, approx) == jax_dup(d, approx)

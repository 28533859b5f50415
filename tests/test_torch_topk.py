"""The port's exact threshold select against the JAX package's, on the
CPU. The JAX side runs ``threshold_topk_mask_1d`` with ``force_xla``
and, where the Pallas kernel applies, ``interpret=True``; the port
runs the search and take-mask kernels' wrappers, which take their plain
versions (the nibble search, the cumsum take rule) for CPU tensors.
Tolerance: none -- the same keys give the same threshold and the same
mask, bit for bit (exactly k set, the lowest index winning ties)."""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.core.client import \
    stale_weight_download as jax_stale_download
from commefficient_tpu.ops.topk import _nibble_threshold_key as jax_nibble
from commefficient_tpu.ops.topk import topk as jax_topk
from commefficient_tpu.ops.topk import topk_with_support as jax_support
from commefficient_tpu.ops.topk import threshold_topk_mask_1d as jax_mask
from commefficient_tpu.ops.topk import selection_may_duplicate as jax_dup
from commefficient_tpu.ops.topk import use_threshold_select as jax_gate
from commefficient_tpu.ops.topk_pallas import _CHUNK
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.core.client import stale_weight_download
from commefficient_tpu_torch.ops.topk import (_blocked_cumsum,
                                              _nibble_threshold_key,
                                              _threshold_topk_mask,
                                              _threshold_topk_mask_plain,
                                              keys_of,
                                              selection_may_duplicate,
                                              threshold_topk_mask_1d,
                                              topk, topk_with_support,
                                              use_threshold_select)
from commefficient_tpu_torch.ops import topk_kernels as tk
from commefficient_tpu_torch.ops.topk_kernels import (take_mask_kernel,
                                                      take_mask_plain,
                                                      threshold_key_kernel)


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


# --- the modes' selections: topk, topk_with_support ----------------------


def _tie_rows(d, seed):
    """Three rows with ties: all equal, magnitude ties (+-1.5) among
    random values, and a few nonzeros among zeros."""
    rng = np.random.RandomState(seed)
    equal = np.full(d, -0.25, np.float32)
    ties = rng.randn(d).astype(np.float32)
    ties[rng.choice(d, d // 4, replace=False)] = 1.5
    ties[rng.choice(d, d // 8, replace=False)] = -1.5
    sparse = np.zeros(d, np.float32)
    sparse[rng.choice(d, 3, replace=False)] = rng.randn(3)
    return np.stack([equal, ties, sparse])


@pytest.mark.parametrize("d,k", [(33, 5), (4096, 700), (4096, 4096),
                                 ((1 << 20) + 3, 50_000)])
def test_topk_2d_rows_of_ties_match_jax(d, k):
    """Row-wise topk exact against the JAX package's (lax.top_k below
    2^20, its batched threshold mask at 2^20 + 3, one row there)."""
    rows = _tie_rows(d, d % 101)
    if d >= 1 << 20:
        rows = rows[1:2]
    want = np.asarray(jax_topk(jnp.asarray(rows), k))
    got = topk(torch.from_numpy(rows), k).numpy()
    assert got.tobytes() == want.tobytes()
    assert ((got != 0).sum(1) <= min(k, d)).all()
    for row, want_row in zip(rows, want):
        assert topk(torch.from_numpy(row), k).numpy().tobytes() == \
            want_row.tobytes()


def test_threshold_topk_mask_rows_equal_1d_selection():
    """The batched plain mask (what the card's row-by-row kernels are
    held to) picks each row's 1-D selection, and its blocked cumsum is
    the flat one."""
    rows = torch.from_numpy(np.square(_tie_rows(5000, 3)))
    got = _threshold_topk_mask_plain(rows, 777)
    assert torch.equal(got, _threshold_topk_mask(rows, 777))
    for row, mask in zip(rows, got):
        assert torch.equal(mask, threshold_topk_mask_1d(row, 777))
    x = torch.randint(0, 3, (3, 5000))
    assert torch.equal(_blocked_cumsum(x), torch.cumsum(x, -1))


@pytest.mark.parametrize("case", ["all-zero", "ties"])
def test_topk_with_support_matches_jax(case):
    """(dense, indices, values) exact, in lax.top_k's order; an
    all-zero vector (T = 0, every key ties) selects the first k."""
    d, k = 1000, 64
    vec = (np.zeros(d, np.float32) if case == "all-zero"
           else _tie_rows(d, 8)[1])
    want = [np.asarray(a) for a in jax_support(jnp.asarray(vec), k)]
    got = [t.numpy() for t in topk_with_support(torch.from_numpy(vec), k)]
    for g, w in zip(got, want):
        assert g.tobytes() == w.astype(g.dtype).tobytes()
    if case == "all-zero":
        np.testing.assert_array_equal(got[1], np.arange(k))


@pytest.mark.parametrize("case", ["all-zero-diff", "ties"])
def test_stale_weight_download_matches_jax(case):
    """--topk_down: the client applies the top-k of ps - its weights;
    at a zero diff (T = 0) it takes the first k of the zeros."""
    from test_modes import make_cfg
    d, k = 2000, 50
    rng = np.random.RandomState(11)
    client = rng.randn(d).astype(np.float32)
    ps = client.copy()
    if case == "ties":
        ps += _tie_rows(d, 12)[1]
    kw = dict(mode="uncompressed", do_topk_down=True, k=k, grad_size=d)
    want = np.asarray(jax_stale_download(
        make_cfg(**kw), jnp.asarray(ps), jnp.asarray(client)))
    got = stale_weight_download(Config(device="cpu", **kw),
                                torch.from_numpy(ps),
                                torch.from_numpy(client)).numpy()
    assert got.tobytes() == want.tobytes()
    if case == "all-zero-diff":
        assert got.tobytes() == client.tobytes()


# --- the k-th-key search (threshold_key_kernel) ---------------------------


def _search_case(name):
    """(sq, k) of one edge distribution, from a numpy seed."""
    rng = np.random.RandomState(len(name))
    if name == "ties-at-T":
        x = rng.randn(100_000).astype(np.float32)
        x[rng.choice(x.size, 300, replace=False)] = 1.5
        sq = np.square(x)
        return sq, int((sq > np.float32(2.25)).sum()) + 100
    if name == "zero-threshold":
        x = np.zeros(70_001, np.float32)
        x[rng.choice(x.size, 50, replace=False)] = rng.randn(50)
        return np.square(x), x.size - 3
    if name == "all-equal":
        return np.ones(70_001, np.float32), 30_000
    if name in ("k=1", "k=d-1"):
        sq = _sq(50_000, 6)
        return sq, 1 if name == "k=1" else sq.size - 1
    if name.startswith("+inf"):
        sq = _sq(60_000, 4)
        sq[rng.choice(sq.size, 40, replace=False)] = np.inf
        return sq, 25 if name == "+inf-T" else 1000
    if name == "top-24-bits":
        bits = np.uint32(0x3F800000) | rng.randint(0, 256, 100_000).astype(
            np.uint32)
        return bits.view(np.float32), 5000
    assert name == "gaussian-2^20+7"
    return np.square(rng.randn((1 << 20) + 7).astype(np.float32)), 50_000


SEARCH_CASES = ["ties-at-T", "zero-threshold", "all-equal", "k=1", "k=d-1",
                "+inf-T", "+inf-finite-T", "top-24-bits", "gaussian-2^20+7"]


@pytest.mark.parametrize("name", SEARCH_CASES)
def test_threshold_key_matches_jax_bit_exact(name):
    """T against the reference's _nibble_threshold_key and need against
    its k - sum(keys > t), as integers."""
    sq, k = _search_case(name)
    keys = jax.lax.bitcast_convert_type(jnp.asarray(sq), jnp.uint32)
    want_t = jax_nibble(keys, k)
    want_need = int(k - jnp.sum((keys > want_t).astype(jnp.int32)))
    t, need = threshold_key_kernel(torch.from_numpy(sq), k)
    assert (int(t), int(need)) == (int(want_t), want_need)


@pytest.mark.parametrize("name", ["+inf-T", "top-24-bits", "ties-at-T"])
def test_mask_edges_match_xla_and_pallas(name):
    sq, k = _search_case(name)
    got = _port_mask(sq, k)
    assert got.sum() == k
    for kw in ({"force_xla": True}, {"interpret": True}):
        np.testing.assert_array_equal(
            got, np.asarray(jax_mask(jnp.asarray(sq), k, **kw)))


@pytest.mark.parametrize("bad", ["f64", "2-D", "non-contiguous"])
def test_threshold_key_wrapper_refuses(bad):
    sq = torch.rand(4096)
    sq = {"f64": sq.double(), "2-D": sq.view(64, 64),
          "non-contiguous": sq[::2]}[bad]
    with pytest.raises(ValueError, match="contiguous 1-D f32"):
        threshold_key_kernel(sq, 17)


def _ties_input():
    # T = 1.0 with 633 of its 2732 ties taken
    sq = torch.ones(4099)
    sq[::3] = 2.0
    return sq, 2000


def test_card_smoke_selection_checks_pass_right_result():
    import chip_smoke as cs
    sq, k = _ties_input()
    t, need, err = cs.selection_checks(sq, k, "cpu")
    assert (int(t), int(need), err) == (0x3F800000, 633, 0.0)


@pytest.mark.parametrize("mutant", ["T one ulp up", "T one ulp down",
                                    "need + 1", "need - 1", "one tie moved"])
def test_card_smoke_selection_checks_reject_wrong_results(monkeypatch,
                                                          mutant):
    # chip_smoke.py holds the search and take-mask kernels exactly
    # against their plain versions on the card; here the kernels'
    # results are replaced by wrong ones and its checks must raise
    import chip_smoke as cs
    sq, k = _ties_input()
    search, mask = tk.threshold_key_kernel, tk.take_mask_kernel

    def wrong_search(s, kk, with_ties=False):
        t, need, *ties = search(s, kk, with_ties)
        dt, dn = {"T one ulp up": (1, 0), "T one ulp down": (-1, 0),
                  "need + 1": (0, 1), "need - 1": (0, -1)}[mutant]
        return (t + dt, need + dn, *ties)

    def tie_moved(s, t, need, ties=None):
        m = mask(s, t, need, ties).clone()
        eq = keys_of(s) == t
        m[torch.nonzero(m & eq)[0]] = False
        m[torch.nonzero(~m & eq)[-1]] = True
        return m

    if mutant == "one tie moved":
        monkeypatch.setattr(tk, "take_mask_kernel", tie_moved)
    else:
        monkeypatch.setattr(tk, "threshold_key_kernel", wrong_search)
    with pytest.raises(AssertionError):
        cs.selection_checks(sq, k, mutant)


# --- chip_smoke.py's per-client selection check (local_topk_path) --------


@pytest.fixture(scope="module")
def local_topk_model():
    """A --test local_topk model with local error and momentum, after
    one epoch on the CPU."""
    from commefficient_tpu_torch.runtime import fed_model
    from commefficient_tpu_torch.train import cv_train
    cv_train.main(["--device", "cpu", "--test", "--dataset_name",
                   "Synthetic", "--mode", "local_topk", "--error_type",
                   "local", "--local_momentum", "0.9", "--num_clients",
                   "10", "--num_workers", "2", "--num_epochs", "1"])
    return fed_model._CURRENT_MODEL


@pytest.mark.parametrize("slip", ["none", "one bit moved",
                                  "one bit dropped"])
def test_card_smoke_local_topk_selection_rejects_slips(monkeypatch, slip,
                                                       local_topk_model):
    # chip_smoke.py holds the row-by-row selection kernels exactly
    # against the plain batched mask on one round's rows and on
    # all-zero rows; here the kernels' masks slip and it must raise
    import chip_smoke as cs
    monkeypatch.setattr(cs, "time_ms", lambda fn, reps, flush: 0.0)
    right = cs._threshold_topk_mask

    def slipped(sq, k):
        m = right(sq, k).clone()
        m[0, torch.nonzero(m[0])[0]] = False
        if slip == "one bit moved":
            m[0, torch.nonzero(~m[0])[-1]] = True
        return m

    if slip == "none":
        cs.local_topk_selection_phase(local_topk_model, torch.device("cpu"))
        return
    monkeypatch.setattr(cs, "_threshold_topk_mask", slipped)
    with pytest.raises(AssertionError, match="local_topk selection"):
        cs.local_topk_selection_phase(local_topk_model, torch.device("cpu"))


# --- chip_smoke.py's take-mask checks (tie placement against the tiles) ---


@pytest.mark.parametrize("slip", [
    "none", "one tie too many at a tile boundary",
    "ties taken from the highest index",
    "the shortcut taken when need < #ties"])
def test_card_smoke_take_mask_checks_reject_slips(monkeypatch, slip):
    # chip_smoke.py holds the take-mask exactly against its plain version
    # with ties placed against its tiles; here the kernel's mask is the
    # plain one with one slip, and the checks must raise
    import chip_smoke as cs
    plain = tk.take_mask_plain
    tile = tk.TAKE_MASK_TILE

    def slipped(s, t, need, ties=None):
        m = plain(s, t, need).clone()
        eq = keys_of(s) == t
        n = int(need)
        if slip == "one tie too many at a tile boundary":
            left = torch.nonzero(eq & ~m).flatten()
            taken = torch.nonzero(eq & m).flatten()
            start = (int(taken[-1]) // tile + 1) * tile if taken.numel() \
                else 0
            left = left[left >= start]
            if left.numel():
                m[left[0]] = True
        elif slip == "ties taken from the highest index":
            from_end = torch.flip(torch.cumsum(torch.flip(eq, (0,)).long(),
                                               0), (0,))
            m = (keys_of(s) > t) | (eq & (from_end <= n))
        elif slip == "the shortcut taken when need < #ties" and n > 0:
            m = (keys_of(s) > t) | eq
        return m

    monkeypatch.setattr(tk, "take_mask_kernel", slipped)
    monkeypatch.setattr(cs, "time_ms", lambda fn, reps, flush: 0.0)
    if slip == "none":
        checked, _ = cs.take_mask_tie_checks(torch.device("cpu"), None)
        assert len(checked) == 5
    else:
        with pytest.raises(AssertionError):
            cs.take_mask_tie_checks(torch.device("cpu"), None)


@pytest.mark.parametrize("spill", [0, 8])
def test_card_smoke_ptxas_take_mask(spill):
    # chip_smoke.py's ptxas_take_mask line names both instantiations, and
    # its check refuses a spill
    import chip_smoke as cs
    log = "".join(
        f"ptxas info    : Function properties for _Z20cet_take_mask_kernel"
        f"ILb{a}EEvPKfxPKxS2_S2_PyPh\n    0 bytes stack frame, {spill} bytes "
        f"spill stores, {spill} bytes spill loads\nptxas info    : Used 48 "
        "registers, used 1 barriers\n" for a in (0, 1))
    report = cs.ptxas_report(log)
    assert set(report) == {"take_mask_aligned", "take_mask_unaligned"}
    if spill:
        with pytest.raises(AssertionError, match="spills"):
            cs.take_mask_ptxas_checks(report)
    else:
        cs.take_mask_ptxas_checks(report)


def test_kernel_ab_child_and_round_summary():
    # kernel_ab runs its child code in each tree and reads profile_round's
    # lines; the code must compile and the summary find its fields
    from commefficient_tpu_torch import kernel_ab
    compile(kernel_ab._KERNELS, "<kernel_ab child>", "exec")
    lines = [
        {"phase": "phases", "data_s": 0.01, "client_s": 0.02,
         "server_s": 0.03},
        {"phase": "host_syncs", "client": 1, "server": 4},
        {"phase": "round_wall", "median_s": 0.1, "peak_mem_GiB": 10.0},
        {"phase": "device", "busy_ms_per_round": 87.0, "busy_share": 0.7,
         "top": [{"name": "void cet_take_mask_kernel<true>(...)",
                  "ms_per_round": 0.3},
                 {"name": "cet_eq_count(float const*, ...)",
                  "ms_per_round": 0.4},
                 {"name": "void other_kernel(...)", "ms_per_round": 9.0}]}]
    out = kernel_ab._round_summary(lines)
    assert out["busy_ms_per_round"] == 87.0
    assert out["host_syncs"] == [1, 4]
    assert out["watched_ms_per_round"] == {
        "void cet_take_mask_kernel<true>(...)": 0.3,
        "cet_eq_count(float const*, ...)": 0.4}

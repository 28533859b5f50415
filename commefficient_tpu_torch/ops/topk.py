"""Exact magnitude top-k selection by threshold.

Port of ``commefficient_tpu/ops/topk.py``: the gates, the nibble radix
search for the k-th largest key (the plain version of the card's
radix-select kernel), the 1-D threshold mask and its ascending index
set (``threshold_topk_indices``), the mask batched over rows
(``_threshold_topk_mask``), and the selections the modes use:
``topk`` (1-D and row-wise 2-D), ``topk_values_indices`` and
``topk_with_support``, and the 2-D mesh's sharded selection
(``distributed_threshold_mask_1d``; ``sharded_threshold_masks``, the
same with every shard in one process). The selected set is exactly k coordinates, the
lowest index winning ties -- lax.top_k's set. The reference takes
lax.top_k below 2^20 coordinates and the threshold mask at or above;
both give that set, so the port selects through the threshold mask at
every d. ``torch.topk`` promises no tie order, so it is never used
here.

Keys are the uint32 bit patterns of non-negative f32 values (their
order is the value order), held in int64.
"""

from __future__ import annotations

from typing import Optional

import torch

from commefficient_tpu_torch.ops.sketch import _MASK32

_THRESHOLD_SELECT_MIN_D = 1 << 20


def use_threshold_select(k: int, d: int, approx: bool) -> bool:
    """The reference's gate for the exact threshold-select path:
    exact selection, a genuine one (k < d), and a row of at least
    2^20 coordinates."""
    return not approx and k < d and d >= _THRESHOLD_SELECT_MIN_D


def selection_may_duplicate(d: int, approx: bool) -> bool:
    """The reference's predicate for when a k-selection's index vector
    can carry duplicates: its big-d approx path, whose guard clamps
    tail picks to (d-1, 0). The port's selection is exact there and
    never duplicates, but keeps the scatter-ADD the predicate asks
    for (``CountSketch.unsketch``)."""
    return approx and d >= _THRESHOLD_SELECT_MIN_D


def keys_of(sq: torch.Tensor) -> torch.Tensor:
    """Non-negative f32 -> their uint32 bit patterns, in int64."""
    bits = sq.to(torch.float32).contiguous().view(torch.int32)
    return bits.to(torch.int64) & _MASK32


def _blocked_cumsum(x: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Inclusive cumsum along the last axis as intra-block scans plus a
    scan of the block offsets (reference ``_blocked_cumsum``,
    ops/topk.py:48); the same values as one flat cumsum."""
    *lead, d = x.shape
    pad = (-d) % block
    xp = torch.nn.functional.pad(x, (0, pad))
    xb = xp.reshape(tuple(lead) + (-1, block))
    intra = torch.cumsum(xb, dim=-1)
    offs = torch.cumsum(intra[..., -1], dim=-1)
    offs = torch.cat([torch.zeros_like(offs[..., :1]), offs[..., :-1]],
                     dim=-1)
    out = (intra + offs[..., None]).reshape(tuple(lead) + (d + pad,))
    return out[..., :d]


def _threshold_topk_mask_plain(sq: torch.Tensor, k: int) -> torch.Tensor:
    """Exact top-k mask of non-negative ``sq`` along the last axis,
    batched over the leading axes, by the reference's construction
    (``_threshold_topk_mask``, ops/topk.py:67): 32 single-bit passes
    find each row's k-th largest key T, then every key > T and the
    first k - #(keys > T) keys == T in index order. Exactly k set a
    row. Runs on any device without a host read; the row-by-row
    kernels' plain version."""
    shape = sq.shape
    keys = keys_of(sq).reshape(-1, shape[-1])
    t = torch.zeros(keys.shape[0], dtype=torch.int64, device=sq.device)
    for bit in range(31, -1, -1):
        cand = t | (1 << bit)
        cnt = torch.sum(keys >= cand[:, None], dim=-1)
        t = torch.where(cnt >= k, cand, t)
    gt = keys > t[:, None]
    eq = keys == t[:, None]
    need = k - torch.sum(gt, dim=-1, keepdim=True)
    take = gt | (eq & (_blocked_cumsum(eq.to(torch.int64)) <= need))
    return take.reshape(shape)


def _threshold_topk_mask(sq: torch.Tensor, k: int) -> torch.Tensor:
    """Exact top-k mask of non-negative ``sq`` along the last axis,
    batched over the leading axes. On the card each row runs the
    search and take-mask kernels (``threshold_topk_mask_1d``), with no
    host read; on the CPU the plain batched construction runs. The
    same set either way."""
    if sq.device.type == "cpu":
        return _threshold_topk_mask_plain(sq, k)
    rows = sq.reshape(-1, sq.shape[-1])
    return torch.stack([threshold_topk_mask_1d(row, k) for row in rows]
                       ).reshape(sq.shape)


def _nibble_threshold_key(keys: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest key of 1-D ``keys`` by an 8-pass 4-bit radix
    search: each pass histograms the current nibble among the keys
    whose higher nibbles match the prefix found so far; returns a 0-dim
    int64 tensor. The search kernel's plain version, run on the CPU
    (``topk_kernels.threshold_key_plain``). On a CUDA tensor it would
    stop the host 25 times: each ``torch.bincount`` reads its input's
    min and max back, each pass reads ``b`` to index ``suffix``, and
    ``remaining`` is copied up once; so the card runs the kernel."""
    assert keys.ndim == 1
    dev = keys.device
    t = torch.zeros((), dtype=torch.int64, device=dev)
    remaining = torch.tensor(k, dtype=torch.int64, device=dev)
    buckets = torch.arange(16, dtype=torch.int64, device=dev)
    for i in range(8):
        shift = 28 - 4 * i
        # prefix compare as two shifts: a single shift by shift + 4
        # would be a shift by 32 on pass 0 (the reference's form,
        # well-defined for uint32 too); pass 0's empty prefix matches
        # every key
        match = (((keys ^ t) >> shift) >> 4) == 0
        nib = (keys >> shift) & 15
        counts = torch.bincount(torch.where(match, nib, 16),
                                minlength=17)[:16]
        suffix = counts.flip(0).cumsum(0).flip(0)  # count(nib >= b)
        ge = suffix >= remaining
        b = torch.where(ge, buckets, 0).max()
        above = torch.where(b < 15, suffix[torch.clamp(b + 1, max=15)],
                            0)
        t = t | (b << shift)
        remaining = remaining - above
    return t


def _take_from_threshold_1d(keys: torch.Tensor, t_key: torch.Tensor,
                            need) -> torch.Tensor:
    """take = (keys > T) | (keys == T and tie rank <= need), the tie
    rank counted in index order: the reference's construction of the
    tie-broken mask, and the take-mask kernel's plain version."""
    gt = keys > t_key
    eq = keys == t_key
    return gt | (eq & (torch.cumsum(eq.to(torch.int64), 0) <= need))


def threshold_topk_mask_1d(sq: torch.Tensor, k: int) -> torch.Tensor:
    """(d,) bool mask of the k largest of non-negative ``sq``: the
    search for the k-th key T and ``need`` = k - #(keys > T), then
    every key > T plus the first ``need`` keys == T in index order --
    the search and take-mask kernels on CUDA (ops/topk_kernels.py),
    with no host read; their plain versions on the CPU."""
    from commefficient_tpu_torch.ops.topk_kernels import (
        take_mask_kernel, threshold_key_kernel)
    assert sq.ndim == 1
    sq = sq.to(torch.float32).contiguous()
    t, need, ties = threshold_key_kernel(sq, k, with_ties=True)
    return take_mask_kernel(sq, t, need, ties)


def compact_mask(mask: torch.Tensor, k: int) -> torch.Tensor:
    """The (k,) ascending int64 indices of a 1-D ``mask`` that has
    exactly k set bits, with no host read: the inclusive prefix count
    of the mask (int32 while d < 2^31) is non-decreasing, so the slot
    s's index is the first position whose count reaches s + 1, a
    ``searchsorted`` of the k slots. The reference's hierarchical
    extraction (``threshold_topk_indices``, ops/topk.py:264-289) finds
    each slot's block by a search over the blocks' totals, then its
    column in the gathered block row; one search over the whole count
    gives the same indices. The output's shape is fixed (k), so the
    caller's stream never waits for a count; ``torch.nonzero`` reads
    its count back to the host."""
    assert mask.ndim == 1, "1-D compaction"
    d = mask.shape[0]
    count = torch.cumsum(mask, 0,
                         dtype=torch.int32 if d < 2 ** 31 else torch.int64)
    slots = torch.arange(1, k + 1, dtype=count.dtype, device=mask.device)
    return torch.searchsorted(count, slots)


def threshold_topk_indices(sq: torch.Tensor, k: int) -> torch.Tensor:
    """Exact top-k indices, ascending, of non-negative 1-D ``sq``: the
    threshold mask's exactly-k set bits, compacted with no host read
    (``compact_mask``)."""
    assert sq.ndim == 1, "1-D selection"
    return compact_mask(threshold_topk_mask_1d(sq, k), k)


def _selection_mask(vec: torch.Tensor, k: int) -> torch.Tensor:
    """Mask of the ``k`` largest-magnitude entries along the last axis
    (all of them when k >= the row length)."""
    if k >= vec.shape[-1]:
        return torch.ones_like(vec, dtype=torch.bool)
    sq = vec.to(torch.float32) * vec.to(torch.float32)
    if vec.ndim == 1:
        return threshold_topk_mask_1d(sq, k)
    return _threshold_topk_mask(sq, k)


def topk(vec: torch.Tensor, k: int) -> torch.Tensor:
    """A copy of ``vec`` with all but its ``k`` largest-magnitude
    entries zeroed: 1-D, or row-wise along the last axis of a 2-D
    input (reference ``topk``, ops/topk.py:305). The reference's
    ``approx`` (``lax.approx_max_k`` below 2^20 coordinates) has no
    counterpart: the exact set meets any recall target."""
    if vec.ndim not in (1, 2):
        raise ValueError(
            f"topk supports 1-D/2-D inputs, got ndim={vec.ndim}")
    k = min(k, vec.shape[-1])
    return torch.where(_selection_mask(vec, k), vec,
                       torch.zeros_like(vec))


def topk_values_indices(vec: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest-magnitude entries of a
    1-D vector, in lax.top_k's order: by magnitude, descending, the
    lower index first among equals (reference ``topk_values_indices``,
    ops/topk.py:356). The set comes from the threshold mask, and only
    its k members are sorted (a stable sort of the ascending indices,
    ``compact_mask``: no host read)."""
    assert vec.ndim == 1, "1-D selection"
    k = min(k, vec.shape[-1])
    idx = compact_mask(_selection_mask(vec, k), k)
    vals = vec[idx]
    order = torch.sort(vals.to(torch.float32) * vals.to(torch.float32),
                       descending=True, stable=True).indices
    return vals[order], idx[order]


def topk_with_support(vec: torch.Tensor, k: int):
    """``(dense, indices, values)`` top-k of a 1-D vector: the zeroed
    dense form and its sparse support (reference ``topk_with_support``,
    ops/topk.py:365)."""
    vals, idx = topk_values_indices(vec, k)
    dense = torch.zeros_like(vec)
    dense[idx] = vals
    return dense, idx, vals


def _sharded_select(sqs, k: int, n_valids, reduce_counts, ties_before):
    """The exact top-k masks of a key vector cut into contiguous shards
    in ascending order (``sqs``: the shards this process holds). Four
    passes of the radix search, each two launches (``rs_hist_kernel``
    on every shard, ``reduce_counts`` summing the 256 counts over all
    shards in place, ``rs_digit_kernel``), leave every shard with the
    global T, need and tie count; shard p then takes its keys > T and
    its first ``need - ties_before[p]`` keys == T (kernel 3 with the
    shard's own tie count, so the no-scan shortcut holds where the
    local need takes every local tie). Only each shard's first
    ``n_valids[p]`` keys are in the population; the rest are never
    taken."""
    from commefficient_tpu_torch.ops.topk_kernels import (rs_digit_kernel,
                                                          rs_hist_kernel,
                                                          rs_state,
                                                          take_mask_kernel)
    sqs = [s.to(torch.float32).contiguous() for s in sqs]
    states = [rs_state(s.device) for s in sqs]
    local = None
    for rs_pass in range(4):
        for sq, n, (state, hist) in zip(sqs, n_valids, states):
            rs_hist_kernel(sq, n, state, hist, rs_pass)
        if rs_pass == 3:
            # bin T's digit of this pass's local counts: #(local keys == T)
            local = [hist.clone() for _, hist in states]
        reduce_counts([hist for _, hist in states])
        for state, hist in states:
            rs_digit_kernel(hist, state, k, rs_pass)
    ties = [loc[state[0] & 255].to(torch.int64)
            for loc, (state, _) in zip(local, states)]
    before = ties_before(ties)
    masks = []
    for sq, n, (state, _), tie, prior in zip(sqs, n_valids, states, ties,
                                             before):
        take = take_mask_kernel(sq[:n], state[0], state[1] - prior, tie,
                                shard=True)
        if n < sq.numel():
            take = torch.cat([take, take.new_zeros(sq.numel() - n)])
        masks.append(take)
    return masks


def sharded_threshold_masks(sqs, k: int, n_valids=None):
    """``_sharded_select`` with every shard in this process (``sqs``, in
    ascending order): the counts summed with torch between the passes,
    the tie offsets an exclusive prefix. The union of the masks is the
    one-card ``threshold_topk_mask_1d`` of the concatenated valid keys.
    The distributed selection's kernels, checked on one card."""
    n_valids = ([s.numel() for s in sqs] if n_valids is None
                else list(n_valids))

    def reduce_counts(hists):
        total = torch.stack(hists).sum(0, dtype=torch.int32)
        for h in hists:
            h.copy_(total)

    def ties_before(ties):
        out, acc = [], torch.zeros_like(ties[0])
        for t in ties:
            out.append(acc)
            acc = acc + t
        return out

    return _sharded_select(sqs, k, n_valids, reduce_counts, ties_before)


def distributed_threshold_mask_1d(sq: torch.Tensor, k: int, axis,
                                  n_valid: Optional[int] = None
                                  ) -> torch.Tensor:
    """Exact global top-k selection mask over non-negative keys sharded
    along a mesh axis (reference ``distributed_threshold_mask_1d``,
    ops/topk.py:166-202): ``sq`` is shard ``axis.index`` of ``axis.size``
    contiguous ascending slices, of which the first ``n_valid`` keys are
    in the population (a tail shard's padding is not). The 256 counts
    of each search pass are all-reduced over the axis (int32), the tie
    counts all-gathered once ((size,) int64). The union of the shards'
    masks has exactly min(k, #valid) bits and is the one-card selection,
    the lowest global index winning ties, across shard boundaries too."""
    n_valid = sq.numel() if n_valid is None else int(n_valid)

    def reduce_counts(hists):
        axis.psum(hists[0])

    def ties_before(ties):
        counts = axis.all_gather(ties[0].reshape(1)).reshape(-1)
        lower = torch.arange(axis.size, device=counts.device) < axis.index
        return [torch.sum(torch.where(lower, counts,
                                      torch.zeros_like(counts)))]

    return _sharded_select([sq], k, [n_valid], reduce_counts,
                           ties_before)[0]

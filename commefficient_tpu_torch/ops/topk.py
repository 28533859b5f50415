"""Exact magnitude top-k selection by threshold.

Port of the parts of ``commefficient_tpu/ops/topk.py`` that the
FetchSGD server step uses: the gates, the nibble radix search for the
k-th largest key (the plain version of the card's radix-select
kernel), the 1-D threshold mask and its ascending index set
(``threshold_topk_indices``). The selected set is
exactly k coordinates, the lowest index winning ties -- lax.top_k's
set. ``torch.topk`` promises no tie order, so it is never used here.

Keys are the uint32 bit patterns of non-negative f32 values (their
order is the value order), held in int64.
"""

from __future__ import annotations

import torch

from commefficient_tpu_torch.ops.sketch import _MASK32

_THRESHOLD_SELECT_MIN_D = 1 << 20


def use_threshold_select(k: int, d: int, approx: bool) -> bool:
    """The reference's gate for the exact threshold-select path:
    exact selection, a genuine one (k < d), and a row of at least
    2^20 coordinates."""
    return not approx and k < d and d >= _THRESHOLD_SELECT_MIN_D


def selection_may_duplicate(d: int, approx: bool) -> bool:
    """Whether a k-selection's index vector can carry duplicates
    (only the reference's big-d approx path, which is not ported)."""
    return approx and d >= _THRESHOLD_SELECT_MIN_D


def keys_of(sq: torch.Tensor) -> torch.Tensor:
    """Non-negative f32 -> their uint32 bit patterns, in int64."""
    bits = sq.to(torch.float32).contiguous().view(torch.int32)
    return bits.to(torch.int64) & _MASK32


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


def threshold_topk_indices(sq: torch.Tensor, k: int) -> torch.Tensor:
    """Exact top-k indices, ascending, of non-negative 1-D ``sq``: the
    threshold mask's exactly-k set bits, compacted. The reference
    compacts by a hierarchical extraction that avoids a d-sized
    scatter on the TPU; ``torch.nonzero`` compacts the mask in one
    stream-ordered pass on the card and returns the same ascending
    indices. It reads the count back to the host once (the round's
    metrics sync anyway); ``nonzero_static`` would avoid that read but
    is missing from some PyTorch builds' CUDA backends."""
    assert sq.ndim == 1, "1-D selection"
    return torch.nonzero(threshold_topk_mask_1d(sq, k)).flatten()

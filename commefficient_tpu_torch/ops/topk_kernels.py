"""The server's selection: Hopper kernels and their plain versions.

- ``take_mask_kernel`` replaces ``take_mask_pallas``
  (``commefficient_tpu/ops/topk_pallas.py:45``); its kernel lives in
  ``csrc/take_mask.cu``;
- ``threshold_key_kernel`` is the k-th-key search that feeds it: the
  reference's ``_nibble_threshold_key`` and ``need`` pass
  (``commefficient_tpu/ops/topk.py:106-152``, ``:219``), which are XLA
  code there, as a radix select in ``csrc/radix_select.cu``;
- ``rs_hist_kernel`` and ``rs_digit_kernel`` are that search's two
  launches of one pass, for keys cut into shards (the 2-D mesh's
  distributed selection, ``distributed_threshold_mask_1d``,
  ``commefficient_tpu/ops/topk.py:166-202``): the counts are summed
  over the shards between them.

Each source's header comment gives its design and bound. A wrapper
launches its kernel for a CUDA tensor (or raises) and takes the plain
version for a CPU tensor; it counts its launches in ``.launches``.
Kernel and plain version give the same threshold, ``need`` and mask,
bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from commefficient_tpu_torch import _build
from commefficient_tpu_torch.ops.topk import (_nibble_threshold_key,
                                              _take_from_threshold_1d,
                                              keys_of)

_P = ctypes.c_void_p
_RS_BINS = 256  # CET_RS_BINS in csrc/radix_select.cu
TAKE_MASK_TILE = 4096  # CET_TM_TILE in csrc/take_mask.cu: keys a block


def threshold_key_plain(sq, k: int, with_ties: bool = False):
    """The search kernel's plain version: ``keys_of``, the nibble
    search and ``need = k - #(keys > T)`` in torch; returns two 0-dim
    int64 tensors (T, need), and ``with_ties`` a third, #(keys == T)."""
    keys = keys_of(sq)
    t = _nibble_threshold_key(keys, k)
    out = (t, k - torch.sum(keys > t))
    return out + (torch.sum(keys == t),) if with_ties else out


def threshold_key_kernel(sq, k: int, with_ties: bool = False):
    """``sq`` (d,) contiguous f32 non-negative keys, ``k`` the count
    to select (1 <= k < d at the call sites) -> (T, need): the bit
    pattern of the k-th largest key and k - #(keys > T), two 0-dim
    int64 tensors on ``sq``'s device; ``with_ties`` adds #(keys == T),
    which lets ``take_mask_kernel`` skip its tie scan. Kernel on CUDA
    (csrc/radix_select.cu ``cet_threshold_key``: no host read), plain
    version on the CPU."""
    if sq.dtype != torch.float32 or sq.ndim != 1 or not sq.is_contiguous():
        raise ValueError("threshold_key_kernel wants a contiguous 1-D f32 "
                         f"tensor, got {sq.dtype} {tuple(sq.shape)} "
                         f"(contiguous: {sq.is_contiguous()})")
    if sq.device.type == "cpu":
        return threshold_key_plain(sq, k, with_ties)
    if sq.device.type != "cuda":
        raise ValueError(f"threshold_key_kernel: no kernel on {sq.device}")
    d = sq.numel()
    if d >= 2 ** 31:
        raise ValueError(f"threshold_key_kernel: d = {d} >= 2^31 overflows "
                         "its 32-bit counts")
    dev = sq.device
    fn = _build.bind("radix_select", "cet_threshold_key",
                     [_P, ctypes.c_longlong, ctypes.c_longlong, _P, _P, _P])
    state = torch.empty(3, dtype=torch.int64, device=dev)
    hist = torch.empty(_RS_BINS, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = fn(sq.data_ptr(), d, int(k), state.data_ptr(),
                  hist.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "cet_threshold_key")
    threshold_key_kernel.launches += 1
    return tuple(state) if with_ties else (state[0], state[1])


threshold_key_kernel.launches = 0


def rs_state(device) -> tuple:
    """A fresh (state, hist) pair for the per-pass search: state holds
    (T, need, ties) as 3 int64, hist the 256 int32 counts of one pass,
    zeroed (the digit step zeroes them again for the next pass)."""
    return (torch.zeros(3, dtype=torch.int64, device=device),
            torch.zeros(_RS_BINS, dtype=torch.int32, device=device))


def rs_hist_plain(sq, n_valid: int, state, hist, rs_pass: int) -> None:
    """Pass ``rs_pass``'s histogram, added into ``hist`` (int32, in
    place): digit ``rs_pass`` (8 bits, most significant first) of the
    keys of ``sq[:n_valid]`` whose higher digits equal the prefix in
    ``state[0]``."""
    keys = keys_of(sq[:n_valid])
    shift = 24 - 8 * rs_pass
    if rs_pass:
        match = (keys >> (shift + 8)) == (state[0] >> (shift + 8))
        keys = keys[match]
    hist += torch.bincount((keys >> shift) & (_RS_BINS - 1),
                           minlength=_RS_BINS).to(hist.dtype)


def rs_digit_plain(hist, state, k: int, rs_pass: int) -> None:
    """Pass ``rs_pass``'s digit step, in place: from the (global) counts
    in ``hist``, the largest digit b whose suffix count reaches what is
    left of k (0 if none); state[0] |= b << shift, state[1] = what is
    left past the keys above b, and after pass 3 state[2] = #(keys ==
    T); hist zeroed."""
    counts = hist.to(torch.int64)
    suf = torch.cat([counts.flip(0).cumsum(0).flip(0),
                     counts.new_zeros(1)])
    remaining = (torch.tensor(k, dtype=torch.int64, device=hist.device)
                 if rs_pass == 0 else state[1].clone())
    n_ge = torch.sum(suf[:_RS_BINS] >= remaining)
    digit = torch.clamp(n_ge - 1, min=0)
    prefix = state[0] if rs_pass else torch.zeros_like(state[0])
    state[0] = prefix | (digit << (24 - 8 * rs_pass))
    state[1] = remaining - suf[digit + 1]
    if rs_pass == 3:
        state[2] = suf[digit] - suf[digit + 1]
    hist.zero_()


def rs_hist_kernel(sq, n_valid: int, state, hist, rs_pass: int) -> None:
    """``sq`` contiguous 1-D f32 keys, of which the first ``n_valid``
    count; ``state``/``hist`` from ``rs_state``: pass ``rs_pass``'s
    histogram added into ``hist``. Kernel on CUDA (csrc/radix_select.cu
    ``cet_rs_pass_hist``: the search kernel's ``cet_rs_hist<P>``),
    ``rs_hist_plain`` on the CPU. The per-pass form of
    ``threshold_key_kernel`` for keys cut into shards (ops/topk.py
    ``sharded_threshold_masks``)."""
    if sq.dtype != torch.float32 or sq.ndim != 1 or not sq.is_contiguous():
        raise ValueError("rs_hist_kernel wants a contiguous 1-D f32 tensor,"
                         f" got {sq.dtype} {tuple(sq.shape)}")
    if not 0 <= n_valid <= sq.numel():
        raise ValueError(f"rs_hist_kernel: n_valid {n_valid} outside "
                         f"[0, {sq.numel()}]")
    if sq.device.type == "cpu":
        return rs_hist_plain(sq, n_valid, state, hist, rs_pass)
    if sq.device.type != "cuda":
        raise ValueError(f"rs_hist_kernel: no kernel on {sq.device}")
    dev = sq.device
    fn = _build.bind("radix_select", "cet_rs_pass_hist",
                     [ctypes.c_int, _P, ctypes.c_longlong, _P, _P, _P])
    with torch.cuda.device(dev):
        code = fn(rs_pass, sq.data_ptr(), n_valid, state.data_ptr(),
                  hist.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "cet_rs_pass_hist")
    rs_hist_kernel.launches += 1


rs_hist_kernel.launches = 0


def rs_digit_kernel(hist, state, k: int, rs_pass: int) -> None:
    """Pass ``rs_pass``'s digit step from the global counts in ``hist``
    (summed over the shards): state updated and hist zeroed, in place.
    Kernel on CUDA (``cet_rs_pass_digit``: ``cet_rs_digit<P>``),
    ``rs_digit_plain`` on the CPU."""
    if hist.device.type == "cpu":
        return rs_digit_plain(hist, state, k, rs_pass)
    if hist.device.type != "cuda":
        raise ValueError(f"rs_digit_kernel: no kernel on {hist.device}")
    dev = hist.device
    fn = _build.bind("radix_select", "cet_rs_pass_digit",
                     [ctypes.c_int, _P, _P, ctypes.c_longlong, _P])
    with torch.cuda.device(dev):
        code = fn(rs_pass, hist.data_ptr(), state.data_ptr(), int(k),
                  torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "cet_rs_pass_digit")
    rs_digit_kernel.launches += 1


rs_digit_kernel.launches = 0


def take_mask_plain(sq, t_key, need) -> torch.Tensor:
    """The kernel's plain version: ``_take_from_threshold_1d`` on the
    keys of ``sq``."""
    return _take_from_threshold_1d(keys_of(sq), t_key, need)


def take_mask_kernel(sq, t_key, need, ties=None,
                     shard: bool = False) -> torch.Tensor:
    """``sq`` (d,) f32 non-negative keys, ``t_key`` the k-th largest
    key's bit pattern and ``need`` = k - #(keys > T), both int64
    tensors of one element on ``sq``'s device -> (d,) bool mask with
    exactly k set. ``ties``, #(keys == T) as from
    ``threshold_key_kernel(..., with_ties=True)``, lets the kernel skip
    its tie scan where need takes every tie; it must be that count.
    Kernel on CUDA (csrc/take_mask.cu ``cet_take_mask``: one memset of
    its scratch and one launch, the keys read once), plain version on
    the CPU (which needs no ``ties``). ``shard``: the take of one shard
    of a distributed selection, with the shard's local need and tie
    count (counted in ``.shard_launches`` too)."""
    if sq.device.type == "cpu":
        return take_mask_plain(sq, t_key, need)
    if sq.device.type != "cuda" or sq.dtype != torch.float32 \
            or sq.ndim != 1 or not sq.is_contiguous():
        raise ValueError("take_mask_kernel wants a contiguous 1-D f32 "
                         f"CUDA tensor, got {sq.dtype} {tuple(sq.shape)} "
                         f"on {sq.device}")
    dev = sq.device
    t_key = t_key.to(dev, torch.int64).reshape(1).contiguous()
    need = need.to(dev, torch.int64).reshape(1).contiguous()
    if ties is not None:
        ties = ties.to(dev, torch.int64).reshape(1).contiguous()
    d = sq.numel()
    lib = _build.load("take_mask")
    n_scratch = lib.cet_take_mask_scratch
    n_scratch.argtypes = [ctypes.c_longlong]
    n_scratch.restype = ctypes.c_longlong
    fn = _build.bind("take_mask", "cet_take_mask",
                     [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P])
    scratch = torch.empty(max(1, n_scratch(d)), dtype=torch.int64,
                          device=dev)
    out = torch.empty(d, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        code = fn(sq.data_ptr(), d, t_key.data_ptr(), need.data_ptr(),
                  None if ties is None else ties.data_ptr(),
                  scratch.data_ptr(), out.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "cet_take_mask")
    take_mask_kernel.launches += 1
    take_mask_kernel.shard_launches += shard
    return out


take_mask_kernel.launches = 0
take_mask_kernel.shard_launches = 0

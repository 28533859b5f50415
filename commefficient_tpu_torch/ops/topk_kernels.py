"""The server's selection: Hopper kernels and their plain versions.

- ``take_mask_kernel`` replaces ``take_mask_pallas``
  (``commefficient_tpu/ops/topk_pallas.py:45``); its kernel lives in
  ``csrc/take_mask.cu``;
- ``threshold_key_kernel`` is the k-th-key search that feeds it: the
  reference's ``_nibble_threshold_key`` and ``need`` pass
  (``commefficient_tpu/ops/topk.py:106-152``, ``:219``), which are XLA
  code there, as a radix select in ``csrc/radix_select.cu``.

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


def take_mask_plain(sq, t_key, need) -> torch.Tensor:
    """The kernel's plain version: ``_take_from_threshold_1d`` on the
    keys of ``sq``."""
    return _take_from_threshold_1d(keys_of(sq), t_key, need)


def take_mask_kernel(sq, t_key, need, ties=None) -> torch.Tensor:
    """``sq`` (d,) f32 non-negative keys, ``t_key`` the k-th largest
    key's bit pattern and ``need`` = k - #(keys > T), both int64
    tensors of one element on ``sq``'s device -> (d,) bool mask with
    exactly k set. ``ties``, #(keys == T) as from
    ``threshold_key_kernel(..., with_ties=True)``, lets the kernel skip
    its tie scan where need takes every tie; it must be that count.
    Kernel on CUDA (csrc/take_mask.cu ``cet_take_mask``: one memset of
    its scratch and one launch, the keys read once), plain version on
    the CPU (which needs no ``ties``)."""
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
    return out


take_mask_kernel.launches = 0

"""Take-mask: the Hopper kernel and its plain version.

Port of ``commefficient_tpu/ops/topk_pallas.py``: ``take_mask_kernel``
replaces ``take_mask_pallas`` (topk_pallas.py:45). The kernel lives in
``csrc/take_mask.cu``, whose header comment gives its design and
bound. The wrapper launches it for a CUDA tensor (or raises) and takes
the plain version for a CPU tensor; it counts its launches in
``.launches``. Both compute the same exact mask, bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from commefficient_tpu_torch import _build
from commefficient_tpu_torch.ops.topk import _take_from_threshold_1d, keys_of

_P = ctypes.c_void_p


def take_mask_plain(sq, t_key, need) -> torch.Tensor:
    """The kernel's plain version: ``_take_from_threshold_1d`` on the
    keys of ``sq``."""
    return _take_from_threshold_1d(keys_of(sq), t_key, need)


def take_mask_kernel(sq, t_key, need) -> torch.Tensor:
    """``sq`` (d,) f32 non-negative keys, ``t_key`` the k-th largest
    key's bit pattern and ``need`` = k - #(keys > T), both int64
    tensors of one element on ``sq``'s device -> (d,) bool mask with
    exactly k set. Kernel on CUDA (csrc/take_mask.cu
    ``cet_take_mask``), plain version on the CPU."""
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
    d = sq.numel()
    lib = _build.load("take_mask")
    n_scratch = lib.cet_take_mask_scratch
    n_scratch.argtypes = [ctypes.c_longlong]
    n_scratch.restype = ctypes.c_longlong
    fn = _build.bind("take_mask", "cet_take_mask",
                     [_P, ctypes.c_longlong, _P, _P, _P, _P, _P])
    scratch = torch.empty(max(1, n_scratch(d)), dtype=torch.int64,
                          device=dev)
    out = torch.empty(d, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        code = fn(sq.data_ptr(), d, t_key.data_ptr(), need.data_ptr(),
                  scratch.data_ptr(), out.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "cet_take_mask")
    take_mask_kernel.launches += 1
    return out


take_mask_kernel.launches = 0

"""Causal flash attention: Hopper kernels and plain versions.

Port of the three ``pl.pallas_call`` kernels of JAX's library flash
attention (``jax/experimental/pallas/ops/tpu/flash_attention.py``,
jax 0.9.0) that ``commefficient_tpu/models/gpt2.py:115-135`` reaches
under ``--attn_impl flash``:

- ``attn_fwd_kernel`` replaces ``_flash_attention_impl`` (:589, call at
  :758);
- ``attn_bwd_dkv_kernel`` replaces ``_flash_attention_bwd_dkv`` (:941,
  call at :1121);
- ``attn_bwd_dq_kernel`` replaces ``_flash_attention_bwd_dq`` (:1287,
  call at :1456).

All three live in ``csrc/flash_attn.cu``, whose header comment gives
their design and bound. Two designs, fixed per template instantiation
(``kernel_design`` names them):

- ``wgmma``: the forward, dK/dV and dQ at bf16, hd in
  ``WGMMA_HEAD_DIMS`` (64, 128; GPT-2's heads are 64). One warpgroup a
  64-row tile, operand tiles copied by ``cp.async`` into
  128-byte-swizzled shared memory, q . k^T, do . v^T and the products
  with v, dO, q and k on the tensor cores (``wgmma``), the softmax and
  ds in the f32 accumulator registers and cast to bf16 as the next
  product's register operand. The forward makes one q . k^T pass where
  a reference K block fits in its registers (the single step at
  T <= 256, hd 64: GPT-2's round) and two where it does not (T 512's
  single step, the online update's 512-column blocks), casting p
  against the whole block's max either way. dQ is dK/dV's transpose: a
  block owns a q tile and walks the K/V tiles up to the diagonal.
  Registers (ptxas, sm_90a) at hd 64: 255 (single step) and 249
  (online) for the forward, 216 for dK/dV (two blocks an SM), 168 for
  dQ (three); no spill.
- ``fma``: f32 at every hd, bf16 at hd 16 and 32: 64-row tiles staged
  as f32 in shared memory, scalar f32 FMAs.

Each wrapper launches its kernel for a CUDA
tensor (or raises) and takes the plain PyTorch version, beside it here,
for a CPU tensor; it counts its launches in ``.launches``. The kernels
take f32 or bf16 (B, H, T, hd) operands with hd in
``SUPPORTED_HEAD_DIMS`` and T a multiple of 128, read through their
strides (the head dim unit-stride); outputs come back as (B, H, T, hd)
views of (B, T, H, hd) tensors, so that the model's
``transpose(1, 2).reshape(B, T, C)`` costs no copy.

The plain versions compute the library's function from the operands'
values, in f32: the forward with the repo's block size ``block_size(T)``
(one step where it equals T, the online update over K blocks of that
size otherwise, with the probabilities cast to the operands' type where
the library casts them); the backward's explicit formulas.
"""

from __future__ import annotations

import ctypes

import torch

from commefficient_tpu_torch import _build
from commefficient_tpu_torch.analysis import cost

_P = ctypes.c_void_p
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# the library's DEFAULT_MASK_VALUE: finite, added to causal positions
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
SUPPORTED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MIN_BLOCK = 128
# head dims at which bf16 operands take the tensor-core (wgmma) kernels
# of csrc/flash_attn.cu; f32, and bf16 at hd 16 and 32, take the FMA
# design
WGMMA_HEAD_DIMS = (64, 128)


def block_size(t: int) -> int:
    """The repo's flash block (models/gpt2.py:129): the first of 512,
    256, 128 that divides T."""
    for b in (512, 256, 128):
        if t % b == 0:
            return b
    raise ValueError(f"T = {t} is not a multiple of {MIN_BLOCK}")


def kernel_design(dtype, head_dim: int) -> dict:
    """{kernel: "wgmma" or "fma"}: the design each kernel runs for
    operands of this type and head dim, fixed per template
    instantiation (never a fallback at run time)."""
    tc = dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS
    design = "wgmma" if tc else "fma"
    return {"attn_fwd": design, "attn_bwd_dkv": design,
            "attn_bwd_dq": design}


def unsupported_reason(head_dim: int, dtype, t=None):
    """Why the kernels cannot take this head dim, element type or
    sequence length (None if they can): both are template parameters
    of csrc/flash_attn.cu, and the blocks tile T by 128."""
    if head_dim not in SUPPORTED_HEAD_DIMS:
        return (f"head dim {head_dim} is not one of {SUPPORTED_HEAD_DIMS} "
                "(the flash attention kernels' instantiations)")
    if dtype not in SUPPORTED_DTYPES:
        return (f"element type {dtype} is not float32 or bfloat16 (the "
                "flash attention kernels' instantiations)")
    if t is not None and (t <= 0 or t % MIN_BLOCK):
        return f"T = {t} is not a positive multiple of {MIN_BLOCK}"
    return None


def _scores(qf, kf, sm_scale, row0, col0):
    """The library's masked scores of f32 q rows from ``row0`` against
    f32 k rows from ``col0``: (q . k^T) * scale, + MASK where col > row."""
    s = (qf @ kf.transpose(-1, -2)) * sm_scale
    rows = torch.arange(row0, row0 + qf.shape[-2], device=qf.device)
    cols = torch.arange(col0, col0 + kf.shape[-2], device=qf.device)
    mask = torch.where(cols[None, :] <= rows[:, None], 0.0, MASK_VALUE)
    return s + mask


def attn_fwd_plain(q, k, v, sm_scale):
    """(B, H, T, hd) q, k, v -> (o in q's type, m, l f32 (B, H, T)):
    the library's causal forward at the repo's block size."""
    bsz, heads, t, hd = q.shape
    blk = block_size(t)
    dt = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.empty(q.shape, dtype=dt, device=q.device)
    m = torch.empty(bsz, heads, t, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    for j in range(t // blk):
        rows = slice(j * blk, (j + 1) * blk)
        if blk == t:
            # the single step (flash_attention.py:484-557)
            s = _scores(qf, kf, sm_scale, 0, 0)
            mm = s.amax(-1, keepdim=True)
            p = torch.exp(s - mm)
            ll = p.sum(-1, keepdim=True)
            p = p / ll
            acc = p.to(dt).float() @ vf
        else:
            # the online update over K blocks (flash_attention.py:387-477)
            mm = torch.full((bsz, heads, blk, 1), -torch.inf,
                            device=q.device)
            ll = torch.zeros_like(mm)
            acc = torch.zeros(bsz, heads, blk, hd, device=q.device)
            for i in range(j + 1):
                cols = slice(i * blk, (i + 1) * blk)
                s = _scores(qf[..., rows, :], kf[..., cols, :], sm_scale,
                            j * blk, i * blk)
                m_next = torch.maximum(mm, s.amax(-1, keepdim=True))
                p = torch.exp(s - m_next)
                l_corr = torch.exp(mm - m_next) * ll
                l_next = p.sum(-1, keepdim=True) + l_corr
                inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
                acc = acc * (l_corr * inv)
                acc = acc + (p.to(dt).float() @ vf[..., cols, :]) * inv
                mm, ll = m_next, l_next
        o[..., rows, :] = acc.to(dt)
        m[..., rows] = mm[..., 0]
        l[..., rows] = ll[..., 0]
    return o, m, l


def _p_ds(q, k, v, m, l, do, di, sm_scale):
    """The backward's f32 p and ds (flash_attention.py:870-932,
    1219-1256)."""
    s = _scores(q.float(), k.float(), sm_scale, 0, 0)
    p = torch.exp(s - m[..., None]) * (1.0 / l[..., None])
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = ((dp - di[..., None]) * p) * sm_scale
    return p, ds


def attn_bwd_dkv_plain(q, k, v, m, l, do, di, sm_scale):
    """-> (dK, dV) in k's and v's type: ``(ds cast)^T . q`` and
    ``(p cast)^T . do``, f32 sums."""
    dt = q.dtype
    p, ds = _p_ds(q, k, v, m, l, do, di, sm_scale)
    dv = p.to(dt).float().transpose(-1, -2) @ do.float()
    dk = ds.to(dt).float().transpose(-1, -2) @ q.float()
    return dk.to(k.dtype), dv.to(v.dtype)


def attn_bwd_dq_plain(q, k, v, m, l, do, di, sm_scale):
    """-> dQ in q's type: ``(ds cast) . k``, f32 sums."""
    _, ds = _p_ds(q, k, v, m, l, do, di, sm_scale)
    return (ds.to(k.dtype).float() @ k.float()).to(q.dtype)


def _check(name, named, stats=()):
    """Device, type, shape and layout of the (B, H, T, hd) operands
    ``named`` and the f32 (B, H, T) row statistics ``stats``. An
    operand the kernels cannot read through its strides (a head dim
    that is not unit-stride, an address or stride off 16 bytes) is
    copied; anything else they cannot take raises."""
    (_, q), *_ = named
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q is on {q.device}, not cuda")
    if q.ndim != 4:
        raise ValueError(f"{name}: q {tuple(q.shape)} is not (B, H, T, hd)")
    reason = unsupported_reason(int(q.shape[-1]), q.dtype, int(q.shape[2]))
    if reason is not None:
        raise ValueError(f"{name}: {reason}")
    vec = 16 // q.element_size()
    out = []
    for key, t in named:
        if t.device != q.device or t.dtype != q.dtype \
                or t.shape != q.shape:
            raise ValueError(f"{name}: {key} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; q is "
                             f"{q.dtype} {tuple(q.shape)} on {q.device}")
        if t.stride(-1) != 1 or t.data_ptr() % 16 \
                or any(s % vec for s in t.stride()[:3]):
            t = t.clone(memory_format=torch.contiguous_format)
        out.append(t)
    for key, t in stats:
        if t.device != q.device or t.dtype != torch.float32 \
                or t.shape != q.shape[:3] or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be contiguous f32 "
                             f"{tuple(q.shape[:3])} on {q.device}, "
                             "16-byte aligned")
    return out


def _empty_like_bthd(x):
    """An uninitialised (B, H, T, hd) view of a (B, T, H, hd) tensor."""
    b, h, t, d = x.shape
    return torch.empty(b, t, h, d, dtype=x.dtype,
                       device=x.device).transpose(1, 2)


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _fwd_launch(fn, q, k, v, sm_scale, stream):
    b, h, t, d = q.shape
    o = _empty_like_bthd(q)
    m = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              m.data_ptr(), l.data_ptr(), SUPPORTED_DTYPES[q.dtype], d, b,
              h, t, block_size(t), float(sm_scale), _strides(q, k, v, o),
              stream)
    _build.check(code, "cet_attn_fwd")
    return o, m, l


def _dkv_launch(fn, q, k, v, m, l, do, di, sm_scale, stream):
    b, h, t, d = q.shape
    dk, dv = _empty_like_bthd(k), _empty_like_bthd(v)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              m.data_ptr(), l.data_ptr(), di.data_ptr(), dk.data_ptr(),
              dv.data_ptr(), SUPPORTED_DTYPES[q.dtype], d, b, h, t,
              float(sm_scale), _strides(q, k, v, do, dk, dv), stream)
    _build.check(code, "cet_attn_bwd_dkv")
    return dk, dv


def _dq_launch(fn, q, k, v, m, l, do, di, sm_scale, stream):
    b, h, t, d = q.shape
    dq = _empty_like_bthd(q)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              m.data_ptr(), l.data_ptr(), di.data_ptr(), dq.data_ptr(),
              SUPPORTED_DTYPES[q.dtype], d, b, h, t, float(sm_scale),
              _strides(q, k, v, do, dq), stream)
    _build.check(code, "cet_attn_bwd_dq")
    return dq


_I, _F = ctypes.c_int, ctypes.c_float
ARGTYPES = {
    "cet_attn_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                     _STRIDES, _P],
    "cet_attn_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _F, _STRIDES, _P],
    "cet_attn_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _F, _STRIDES, _P],
}


def _bound(name):
    return _build.bind("flash_attn", name, ARGTYPES[name])


def attn_fwd_kernel(q, k, v, sm_scale):
    """(B, H, T, hd) q, k, v -> (o, m, l): the causal forward, o in q's
    type, m and l f32 (B, H, T). Kernel on CUDA (csrc/flash_attn.cu
    ``cet_attn_fwd``), plain version on the CPU."""
    if q.device.type == "cpu":
        return attn_fwd_plain(q, k, v, sm_scale)
    q, k, v = _check("attn_fwd_kernel", (("q", q), ("k", k), ("v", v)))
    with torch.cuda.device(q.device):
        out = _fwd_launch(_bound("cet_attn_fwd"), q, k, v, sm_scale,
                          _stream(q.device))
    attn_fwd_kernel.launches += 1
    cost.add_kernel_flops("attn_fwd",
                          cost.attn_flops(*q.shape)["attn_fwd"], q.dtype)
    return out


attn_fwd_kernel.launches = 0


def attn_bwd_dkv_kernel(q, k, v, m, l, do, di, sm_scale):
    """Operands of the forward, its m and l, the cotangent ``do`` of o
    and di = sum(o * do) over hd -> (dK, dV) in k's and v's type.
    Kernel on CUDA (csrc/flash_attn.cu ``cet_attn_bwd_dkv``), plain
    version on the CPU."""
    if q.device.type == "cpu":
        return attn_bwd_dkv_plain(q, k, v, m, l, do, di, sm_scale)
    q, k, v, do = _check("attn_bwd_dkv_kernel",
                         (("q", q), ("k", k), ("v", v), ("do", do)),
                         (("m", m), ("l", l), ("di", di)))
    with torch.cuda.device(q.device):
        out = _dkv_launch(_bound("cet_attn_bwd_dkv"), q, k, v, m, l, do,
                          di, sm_scale, _stream(q.device))
    attn_bwd_dkv_kernel.launches += 1
    cost.add_kernel_flops("attn_bwd_dkv",
                          cost.attn_flops(*q.shape)["attn_bwd_dkv"], q.dtype)
    return out


attn_bwd_dkv_kernel.launches = 0


def attn_bwd_dq_kernel(q, k, v, m, l, do, di, sm_scale):
    """As ``attn_bwd_dkv_kernel`` -> dQ in q's type. Kernel on CUDA
    (csrc/flash_attn.cu ``cet_attn_bwd_dq``), plain version on the
    CPU."""
    if q.device.type == "cpu":
        return attn_bwd_dq_plain(q, k, v, m, l, do, di, sm_scale)
    q, k, v, do = _check("attn_bwd_dq_kernel",
                         (("q", q), ("k", k), ("v", v), ("do", do)),
                         (("m", m), ("l", l), ("di", di)))
    with torch.cuda.device(q.device):
        out = _dq_launch(_bound("cet_attn_bwd_dq"), q, k, v, m, l, do, di,
                         sm_scale, _stream(q.device))
    attn_bwd_dq_kernel.launches += 1
    cost.add_kernel_flops("attn_bwd_dq",
                          cost.attn_flops(*q.shape)["attn_bwd_dq"], q.dtype)
    return out


attn_bwd_dq_kernel.launches = 0

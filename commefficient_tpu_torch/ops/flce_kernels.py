"""Fused tied-head cross-entropy: Hopper kernels and plain versions.

Port of ``commefficient_tpu/ops/flce_pallas.py``:

- ``flce_fwd_kernel`` replaces ``_fwd_kernel`` via ``_flce_fwd_impl``
  (flce_pallas.py:87, :200);
- ``flce_bwd_kernel`` replaces ``_bwd_kernel`` via ``_flce_vjp_bwd``
  (flce_pallas.py:128, :244).

Both kernels live in ``csrc/flce.cu``, whose header comment gives their
design and bound. Each wrapper launches its kernel for a CUDA tensor
(or raises) and takes the plain PyTorch version, beside it here, for a
CPU tensor; it counts its launches in ``.launches``. The kernels take
bf16 operands only (f32 on the card is refused with a TypeError) and
embedding widths ``C % 64 == 0``, ``64 <= C <= 768`` (``supported``).

The plain versions compute the same function in f32 from the operands'
values: logits ``x . W^T`` per token chunk, the forward's logsumexp
and label logit, and the backward's explicit gradient
``d = g_lse * softmax + g_tok * onehot(label)`` (the reference
kernel's formula, flce_pallas.py:148-150, not autograd), cast to the
operands' type before both products, as the kernel does.
"""

from __future__ import annotations

import ctypes

import torch

from commefficient_tpu_torch import _build
from commefficient_tpu_torch.analysis import cost

_P = ctypes.c_void_p
MIN_WIDTH, WIDTH_STEP, MAX_WIDTH = 64, 64, 768  # csrc/flce.cu MAX_NF
# token rows per chunk of the plain versions' (rows, V) f32 logits
PLAIN_CHUNK = 4096


def unsupported_reason(c: int):
    """Why the kernels cannot take embedding width ``c`` (None if they
    can): the backward keeps a (64, C) f32 accumulator in the registers
    of two warpgroups, C / 2 columns each, C a template parameter."""
    if c % WIDTH_STEP or not MIN_WIDTH <= c <= MAX_WIDTH:
        return (f"embedding width {c} is not a multiple of {WIDTH_STEP} "
                f"in [{MIN_WIDTH}, {MAX_WIDTH}] (the flce kernels' "
                "register-resident accumulator)")
    return None


def _onehot_add(d, labels, g_tok):
    """d[i, labels[i]] += g_tok[i] where 0 <= labels[i] < V."""
    valid = (labels >= 0) & (labels < d.shape[1])
    rows = torch.nonzero(valid).flatten()
    d[rows, labels[rows].long()] += g_tok[rows]
    return d


def flce_fwd_plain(x, w, labels):
    """(M, C) x, (V, C) W, (M,) int labels -> f32 (lse, tok): the
    logsumexp over the vocab of ``x . W^T`` and the label's logit (0
    where the label is outside [0, V))."""
    m, v = x.shape[0], w.shape[0]
    wf = w.float()
    lse = torch.empty(m, dtype=torch.float32, device=x.device)
    tok = torch.zeros(m, dtype=torch.float32, device=x.device)
    for i in range(0, m, PLAIN_CHUNK):
        lg = x[i:i + PLAIN_CHUNK].float() @ wf.t()
        lse[i:i + PLAIN_CHUNK] = torch.logsumexp(lg, dim=1)
        lab = labels[i:i + PLAIN_CHUNK]
        valid = (lab >= 0) & (lab < v)
        picked = lg.gather(1, torch.where(valid, lab, 0).long()[:, None])
        tok[i:i + PLAIN_CHUNK] = torch.where(valid, picked[:, 0], 0.0)
    return lse, tok


def flce_bwd_plain(x, w, labels, lse, g_lse, g_tok):
    """Gradients of ``g_lse . lse + g_tok . tok`` in x and W: dX in x's
    type, dW in W's type, both summed in f32."""
    wf = w.float()
    dx = torch.empty_like(x)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    for i in range(0, x.shape[0], PLAIN_CHUNK):
        sl = slice(i, i + PLAIN_CHUNK)
        xf = x[sl].float()
        d = g_lse[sl, None] * torch.exp(xf @ wf.t() - lse[sl, None])
        d = _onehot_add(d, labels[sl], g_tok[sl])
        dc = d.to(x.dtype).float()
        dx[sl] = (dc @ wf).to(x.dtype)
        dw += dc.t() @ xf
    return dx, dw.to(w.dtype)


def _check_operands(name, x, w, labels, vectors=()):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x is on {x.device}, not cuda")
    for key, t in (("x", x), ("w", w)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {key} is {t.dtype}; the flce kernels "
                            "take bfloat16 only (--bf16)")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (M, C) and (V, C)")
    if labels.dtype != torch.int32 or labels.shape != (x.shape[0],):
        raise ValueError(f"{name}: labels must be int32 ({x.shape[0]},), "
                         f"got {labels.dtype} {tuple(labels.shape)}")
    reason = unsupported_reason(int(x.shape[1]))
    if reason is not None:
        raise ValueError(f"{name}: {reason}")
    for key, t in (("x", x), ("w", w), ("labels", labels)) + tuple(vectors):
        if t.device != x.device:
            raise ValueError(f"{name}: {key} on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not contiguous and "
                             "16-byte aligned")
    for key, t in vectors:
        if t.dtype != torch.float32 or t.shape != (x.shape[0],):
            raise ValueError(f"{name}: {key} must be f32 ({x.shape[0]},)")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def flce_fwd_kernel(x, w, labels):
    """(M, C) x, (V, C) W, (M,) int32 labels -> f32 (lse, tok), each
    (M,). Kernel on CUDA (csrc/flce.cu ``cet_flce_fwd``), plain version
    on the CPU."""
    if x.device.type == "cpu":
        return flce_fwd_plain(x, w, labels)
    _check_operands("flce_fwd_kernel", x, w, labels)
    m, c = x.shape
    fn = _build.bind("flce", "cet_flce_fwd",
                     [_P, _P, _P, _P, _P, ctypes.c_longlong,
                      ctypes.c_longlong, ctypes.c_int, _P])
    lse = torch.empty(m, dtype=torch.float32, device=x.device)
    tok = torch.empty(m, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w.data_ptr(), labels.data_ptr(),
                  lse.data_ptr(), tok.data_ptr(), m, w.shape[0], c,
                  _stream(x.device))
    _build.check(code, "cet_flce_fwd")
    flce_fwd_kernel.launches += 1
    cost.add_kernel_flops("flce_fwd", cost.flce_fwd_flops(m, w.shape[0], c),
                          x.dtype)
    return lse, tok


flce_fwd_kernel.launches = 0


def flce_bwd_kernel(x, w, labels, lse, g_lse, g_tok):
    """Operands of the forward plus its lse and the f32 cotangents of
    (lse, tok) -> (dX (M, C) in x's type, dW (V, C) in W's type).
    Kernel on CUDA (csrc/flce.cu ``cet_flce_bwd``: one pass for dX, one
    for dW), plain version on the CPU."""
    if x.device.type == "cpu":
        return flce_bwd_plain(x, w, labels, lse, g_lse, g_tok)
    _check_operands("flce_bwd_kernel", x, w, labels,
                    (("lse", lse), ("g_lse", g_lse), ("g_tok", g_tok)))
    m, c = x.shape
    fn = _build.bind("flce", "cet_flce_bwd",
                     [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                      ctypes.c_longlong, ctypes.c_int, _P])
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w.data_ptr(), labels.data_ptr(),
                  lse.data_ptr(), g_lse.data_ptr(), g_tok.data_ptr(),
                  dx.data_ptr(), dw.data_ptr(), m, w.shape[0], c,
                  _stream(x.device))
    _build.check(code, "cet_flce_bwd")
    flce_bwd_kernel.launches += 1
    cost.add_kernel_flops("flce_bwd", cost.flce_bwd_flops(m, w.shape[0], c),
                          x.dtype)
    return dx, dw


flce_bwd_kernel.launches = 0

# widths of the one-tile product checks (an odd and an even number of
# 64-column panels)
PROBE_WIDTHS = (320, 768)
# the forward's tile: token rows a block, vocab ids a tile
FWD_TILE = (128, 256)


def wgmma_tile_products_plain(a, s, dm):
    """f32 ``(a . s^T, dm . s)`` of a (64, C), s (32, C), dm (64, 32)."""
    sf = s.float()
    return a.float() @ sf.t(), dm.float() @ sf


def wgmma_tile_products(a, s, dm):
    """One tile of each product shape of the flce backward, through its
    shared-memory layout and ``wgmma`` descriptors (csrc/flce.cu
    ``cet_wgmma_probe``): ``a . s^T`` with both operands K-major and
    ``dm . s`` with ``dm`` in registers and ``s`` MN-major, summed in
    f32. bf16 a (64, C), s (32, C), dm (64, 32), C in ``PROBE_WIDTHS``;
    plain version on the CPU."""
    if a.device.type == "cpu":
        return wgmma_tile_products_plain(a, s, dm)
    c = int(a.shape[1])
    if c not in PROBE_WIDTHS or tuple(a.shape) != (64, c) \
            or tuple(s.shape) != (32, c) or tuple(dm.shape) != (64, 32):
        raise ValueError(f"wgmma_tile_products: shapes {tuple(a.shape)}, "
                         f"{tuple(s.shape)}, {tuple(dm.shape)}; want (64, C), "
                         f"(32, C), (64, 32) with C in {PROBE_WIDTHS}")
    for t in (a, s, dm):
        if t.dtype != torch.bfloat16 or t.device != a.device \
                or not t.is_contiguous():
            raise ValueError("wgmma_tile_products: operands must be "
                             "contiguous bfloat16 on one device")
    fn = _build.bind("flce", "cet_wgmma_probe",
                     [_P, _P, _P, _P, _P, ctypes.c_int, _P])
    lg = torch.empty(64, 32, dtype=torch.float32, device=a.device)
    g = torch.empty(64, c, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        code = fn(a.data_ptr(), s.data_ptr(), dm.data_ptr(), lg.data_ptr(),
                  g.data_ptr(), c, _stream(a.device))
    _build.check(code, "cet_wgmma_probe")
    return lg, g


def wgmma_fwd_tile_plain(a, b):
    """f32 ``a . b^T`` of a (128, C) and b (256, C)."""
    return a.float() @ b.float().t()


def wgmma_fwd_tile(a, b):
    """One tile of the flce forward, through its cp.async ring, its
    shared-memory layout and its ``wgmma`` descriptors (csrc/flce.cu
    ``cet_wgmma_fwd_probe``): ``a . b^T`` with both operands K-major,
    summed in f32 over the whole width. bf16 a (128, C) and b (256, C),
    C a width the kernels take; plain version on the CPU."""
    if a.device.type == "cpu":
        return wgmma_fwd_tile_plain(a, b)
    c = int(a.shape[1])
    if unsupported_reason(c) is not None \
            or tuple(a.shape) != (FWD_TILE[0], c) \
            or tuple(b.shape) != (FWD_TILE[1], c):
        raise ValueError(f"wgmma_fwd_tile: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}; want (128, C), (256, C) with "
                         f"C % 64 == 0 in [64, 768]")
    for t in (a, b):
        if t.dtype != torch.bfloat16 or t.device != a.device \
                or not t.is_contiguous():
            raise ValueError("wgmma_fwd_tile: operands must be contiguous "
                             "bfloat16 on one device")
    fn = _build.bind("flce", "cet_wgmma_fwd_probe",
                     [_P, _P, _P, ctypes.c_int, _P])
    out = torch.empty(*FWD_TILE, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), c,
                  _stream(a.device))
    _build.check(code, "cet_wgmma_fwd_probe")
    return out

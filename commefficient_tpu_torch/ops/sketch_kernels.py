"""Sketch, sketch-and-quantize and estimates: Hopper kernels and their
plain versions.

Port of ``commefficient_tpu/ops/sketch_pallas.py``:

- ``sketch_kernel`` replaces ``sketch_pallas`` (sketch_pallas.py:216);
- ``sketch_quant_kernel`` replaces ``sketch_quant_pallas`` (:293), the
  fused emit + quantize of the ``--sketch_dtype int8|fp8`` wire;
- ``estimates_kernel`` replaces ``estimates_pallas`` (:414);
- ``sketch_window_kernel`` and ``estimates_window_kernel`` are kernels
  1 and 2 over a window [lo, hi) of the coordinates: one model peer's
  slice on the 2-D mesh (core/rounds.py, core/server.py).

The kernels live in ``csrc/sketch.cu``, whose header comment gives
their design and bounds. Each wrapper launches its kernel for a CUDA
tensor (or raises) and takes the plain PyTorch version, beside it
here, for a CPU tensor; it counts its launches in ``.launches``.

The plain sketch adds the chunks in the kernel's order (t = 0..m-1,
from zero), so the two agree bit for bit; against the JAX package the
tables agree to summation-order tolerance. The sketch takes its signs
hashed or, given ``signs``, from the packed-sign stream
(``CountSketch.packed_signs_on``: a byte a coordinate, the one-mix
bits of rows 0..7), which holds the same bits; so does the fused
sketch-and-quantize, and the estimates kernel hashes. Estimates from a
given table are exact everywhere: the sign flip is exact and the median
is an order statistic (or the mean of two, for even r). The fused
sketch-and-quantize's plain version is ``quantize_local``
(ops/quant.py) of the plain sketch; the kernel sums its table on the
sketch kernel's core, so the table is bit-equal, and rounds the same
way, so the two agree byte for byte. ``sketch_quant_route`` names the
kernel's route for a shape (``csrc/sketch.cu`` dispatches by
geometry).

A row chunk (``--overlap_depth``) is sketched from the chunk's rows of
the rotations and ``row_offset``, its first row: signs are keyed by the
absolute row, so a chunk equals those rows of the whole table.
"""

from __future__ import annotations

import ctypes

import torch

from commefficient_tpu_torch import _build
from commefficient_tpu_torch.accounting import wire_torch_dtype
from commefficient_tpu_torch.ops.sketch import _mix, sign_bits, signs_from_bits

_P = ctypes.c_void_p
MAX_ROWS = 32  # CET_MAX_ROWS in csrc/sketch.cu


def _row_signs(idx, h, row, sign_seed, one_mix):
    return signs_from_bits(sign_bits(idx, row, sign_seed, one_mix, h))


def _check_max_rows(name, r):
    if r > MAX_ROWS:
        raise ValueError(f"{name}: r={r} > {MAX_ROWS} rows")


def _check_rows(name, r, one_mix, row_offset):
    # the one-mix hash carries 16 sign bits: the absolute rows of a
    # chunk must stay inside them
    if row_offset < 0 or (one_mix and row_offset + r > 16):
        raise ValueError(f"{name}: rows {row_offset}..{row_offset + r - 1}"
                         f" out of range (one_mix={one_mix}: the one-mix "
                         "hash carries 16 sign bits)")


def _check_signs(name, signs, m, c, r, one_mix, row_offset):
    # the packed-sign stream: a byte a coordinate, bit `row` the one-mix
    # sign bit of row `row`, for the first 8 rows
    if signs.dtype != torch.uint8 or signs.numel() != m * c:
        raise ValueError(f"{name}: signs {signs.dtype} {tuple(signs.shape)}"
                         f" is not a ({m * c},) uint8 stream")
    if not one_mix or row_offset + r > 8:
        raise ValueError(f"{name}: the packed-sign stream holds the one-mix"
                         f" signs of rows 0..7, not rows {row_offset}.."
                         f"{row_offset + r - 1} (one_mix={one_mix})")


def sketch_plain(vp, rot, c: int, r: int, sign_seed: int,
                 one_mix: bool, row_offset: int = 0,
                 signs=None) -> torch.Tensor:
    """(m*c,) padded vector -> (r, c) table: for each row, the sum
    over chunks t (in order) of the signed chunk gathered back by its
    rotation: ``out[row, col] += s(g) * vp[g]``,
    ``g = t*c + (col - o[row, t]) mod c``, with the signs of row
    ``row_offset + row``: hashed, or read from the packed-sign stream
    ``signs`` (``CountSketch.packed_signs_on``), which holds the same
    bits."""
    _check_rows("sketch_plain", r, one_mix, row_offset)
    m = vp.numel() // c
    dev = vp.device
    if signs is not None:
        _check_signs("sketch_plain", signs, m, c, r, one_mix, row_offset)
    rots = rot.to("cpu", torch.int64).tolist()
    idx = torch.arange(m * c, dtype=torch.int64, device=dev)
    h = _mix(idx ^ sign_seed) if one_mix and signs is None else None
    cols = torch.arange(c, dtype=torch.int64, device=dev)
    out = torch.empty((r, c), dtype=torch.float32, device=dev)
    for row in range(r):
        if signs is not None:
            sgn = signs_from_bits((signs.to(torch.int64)
                                   >> (row_offset + row)) & 1)
        else:
            sgn = _row_signs(idx, h, row_offset + row, sign_seed, one_mix)
        signed = vp * sgn
        acc = torch.zeros(c, dtype=torch.float32, device=dev)
        for t in range(m):
            acc = acc + signed[t * c + (cols - rots[row][t]) % c]
        out[row] = acc
    return out


def sketch_quant_plain(vp, rot, c: int, r: int, sign_seed: int,
                       one_mix: bool, wire: str, row_offset: int = 0,
                       signs=None):
    """(m*c,) padded vector -> (q (r, c) in the wire dtype, rowmax
    (r, 1) f32): the plain sketch of rows ``row_offset..+r`` (signs
    hashed, or read from the packed-sign stream ``signs``, which holds
    the same bits), quantized per row at full range
    (``quant.quantize_local``)."""
    from commefficient_tpu_torch.ops.quant import QMAX, quantize_local
    assert wire in QMAX, wire
    return quantize_local(
        sketch_plain(vp, rot, c, r, sign_seed, one_mix, row_offset, signs),
        wire)


def median_network(vals):
    """Elementwise median of a list of same-shape tensors by the
    reference's network (sketch_pallas._median_network): a selection
    network for r = 3 and 5, an odd-even transposition sort
    otherwise, the mean of the two middles for even r."""
    v = list(vals)
    n = len(v)
    if n == 1:
        return v[0]

    def med3(x, y, z):
        return torch.maximum(torch.minimum(x, y),
                             torch.minimum(torch.maximum(x, y), z))

    if n == 3:
        return med3(v[0], v[1], v[2])
    if n == 5:
        f = torch.maximum(torch.minimum(v[0], v[1]),
                          torch.minimum(v[2], v[3]))
        g = torch.minimum(torch.maximum(v[0], v[1]),
                          torch.maximum(v[2], v[3]))
        return med3(v[4], f, g)
    for rnd in range(n):
        for i in range(rnd % 2, n - 1, 2):
            v[i], v[i + 1] = (torch.minimum(v[i], v[i + 1]),
                              torch.maximum(v[i], v[i + 1]))
    if n % 2 == 1:
        return v[n // 2]
    return 0.5 * (v[n // 2 - 1] + v[n // 2])


def estimates_plain(table, rot, c: int, r: int, sign_seed: int,
                    one_mix: bool, valid: int, window=None) -> torch.Tensor:
    """(r, c) table -> (m*c,) median-of-rows estimates, zero at
    positions >= ``valid``; ``window=(lo, hi)``: only the (hi - lo,)
    estimates of coordinates lo .. hi - 1, each the same value."""
    m = rot.shape[1]
    dev = table.device
    rot = rot.to(dev, torch.int64)
    lo, hi = window if window is not None else (0, m * c)
    idx = torch.arange(lo, hi, dtype=torch.int64, device=dev)
    t = idx // c
    j = idx - t * c
    h = _mix(idx ^ sign_seed) if one_mix else None
    vals = [table[row][(j + rot[row][t]) % c]
            * _row_signs(idx, h, row, sign_seed, one_mix)
            for row in range(r)]
    med = median_network(vals)
    if valid < hi:
        med = torch.where(idx < valid, med, torch.zeros_like(med))
    return med


def _check_cuda(name, **tensors):
    dev = None
    for key, (t, dtype) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, not cuda")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        dev = t.device
    return dev


def _check_index_range(name, m, c):
    # the kernels hash and index coordinates as uint32 and widths as int
    if m * c >= 2**32 or c >= 2**31:
        raise ValueError(f"{name}: m*c = {m * c} coordinates exceed the "
                         "kernels' 32-bit index range")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_sketch_args(name, vp, rot, c, r):
    dev = _check_cuda(name, vp=(vp, torch.float32), rot=(rot, torch.int32))
    m = rot.shape[1]
    if vp.numel() != m * c or rot.shape[0] != r:
        raise ValueError(f"{name}: vp {tuple(vp.shape)}, rot "
                         f"{tuple(rot.shape)} do not fit r={r}, c={c}")
    _check_index_range(name, m, c)
    return dev, m


def sketch_kernel(vp, rot, c: int, r: int, sign_seed: int,
                  one_mix: bool, row_offset: int = 0,
                  signs=None) -> torch.Tensor:
    """(m*c,) f32 padded vector, (r, m) int32 rotations -> (r, c)
    f32 table; with ``signs``, the (m*c,) packed-sign stream, the
    kernel reads the signs instead of hashing them. Kernel on CUDA
    (csrc/sketch.cu ``cet_sketch``), plain version on the CPU."""
    if vp.device.type == "cpu":
        return sketch_plain(vp, rot, c, r, sign_seed, one_mix, row_offset,
                            signs)
    _check_rows("sketch_kernel", r, one_mix, row_offset)
    dev, m = _check_sketch_args("sketch_kernel", vp, rot, c, r)
    if signs is not None:
        _check_signs("sketch_kernel", signs, m, c, r, one_mix, row_offset)
        _check_cuda("sketch_kernel", vp=(vp, torch.float32),
                    signs=(signs, torch.uint8))
    fn = _build.bind("sketch", "cet_sketch",
                     [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_uint, ctypes.c_int,
                      ctypes.c_int, _P, _P])
    out = torch.empty((r, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = fn(vp.data_ptr(), rot.data_ptr(), out.data_ptr(), m, c, r,
                  sign_seed, int(one_mix), row_offset,
                  None if signs is None else signs.data_ptr(), _stream(dev))
    _build.check(code, "cet_sketch")
    sketch_kernel.launches += 1
    return out


sketch_kernel.launches = 0


def _check_window(name, lo, hi, m, c):
    if not 0 <= lo <= hi <= m * c:
        raise ValueError(f"{name}: window [{lo}, {hi}) is not inside the "
                         f"{m * c} padded coordinates")


def sketch_window_plain(vp, rot, c: int, r: int, sign_seed: int,
                        one_mix: bool, lo: int, hi: int,
                        signs=None) -> torch.Tensor:
    """``sketch_plain`` of ``vp`` zeroed outside the coordinates [lo,
    hi): one model peer's partial table of the 2-D emission."""
    _check_window("sketch_window_plain", lo, hi, vp.numel() // c, c)
    win = torch.zeros_like(vp)
    win[lo:hi] = vp[lo:hi]
    return sketch_plain(win, rot, c, r, sign_seed, one_mix, 0, signs)


def sketch_window_kernel(vp, rot, c: int, r: int, sign_seed: int,
                         one_mix: bool, lo: int, hi: int,
                         signs=None) -> torch.Tensor:
    """(m*c,) f32 padded vector -> the (r, c) f32 table of its
    coordinates [lo, hi) alone (the 2-D mesh's partial sketch of one
    model peer's ceil(d/M) slice, which the reference makes with
    ``sketch_sparse`` over the slice, core/rounds.py:426-500). Kernel
    on CUDA (csrc/sketch.cu ``cet_sketch_window``: kernel 1 over the
    chunks that hold the window, its edges masked), bit-equal to
    ``sketch_window_plain``, the plain version, on the CPU."""
    if vp.device.type == "cpu":
        return sketch_window_plain(vp, rot, c, r, sign_seed, one_mix, lo,
                                   hi, signs)
    _check_rows("sketch_window_kernel", r, one_mix, 0)
    dev, m = _check_sketch_args("sketch_window_kernel", vp, rot, c, r)
    _check_window("sketch_window_kernel", lo, hi, m, c)
    if signs is not None:
        _check_signs("sketch_window_kernel", signs, m, c, r, one_mix, 0)
        _check_cuda("sketch_window_kernel", vp=(vp, torch.float32),
                    signs=(signs, torch.uint8))
    fn = _build.bind("sketch", "cet_sketch_window",
                     [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_uint, ctypes.c_int,
                      ctypes.c_int, _P, ctypes.c_longlong,
                      ctypes.c_longlong, _P])
    out = torch.empty((r, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = fn(vp.data_ptr(), rot.data_ptr(), out.data_ptr(), m, c, r,
                  sign_seed, int(one_mix), 0,
                  None if signs is None else signs.data_ptr(), lo, hi,
                  _stream(dev))
    _build.check(code, "cet_sketch_window")
    sketch_window_kernel.launches += 1
    return out


sketch_window_kernel.launches = 0


def _check_wire(name, wire):
    if wire not in ("int8", "fp8"):
        raise ValueError(f"{name}: wire {wire!r} is not int8 or fp8")


def sketch_quant_kernel(vp, rot, c: int, r: int, sign_seed: int,
                        one_mix: bool, wire: str, row_offset: int = 0,
                        signs=None):
    """(m*c,) f32 padded vector, (r, m) int32 rotations (the chunk's
    rows) -> (q (r, c) int8 or float8_e4m3fn, rowmax (r, 1) f32), the
    table of rows ``row_offset..+r`` quantized per row; with ``signs``,
    the (m*c,) packed-sign stream, the kernel reads the signs instead of
    hashing them. Kernel on CUDA (csrc/sketch.cu ``cet_sketch_quant``,
    one cooperative launch on the sketch kernel's core, or on its tile
    route where that grid cannot be co-resident), plain version on the
    CPU."""
    _check_wire("sketch_quant_kernel", wire)
    if vp.device.type == "cpu":
        return sketch_quant_plain(vp, rot, c, r, sign_seed, one_mix, wire,
                                  row_offset, signs)
    _check_rows("sketch_quant_kernel", r, one_mix, row_offset)
    _check_max_rows("sketch_quant_kernel", r)
    dev, m = _check_sketch_args("sketch_quant_kernel", vp, rot, c, r)
    if signs is not None:
        _check_signs("sketch_quant_kernel", signs, m, c, r, one_mix,
                     row_offset)
        _check_cuda("sketch_quant_kernel", vp=(vp, torch.float32),
                    signs=(signs, torch.uint8))
    fn = _build.bind("sketch", "cet_sketch_quant",
                     [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_uint, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, _P, _P])
    q = torch.empty((r, c), dtype=wire_torch_dtype(wire), device=dev)
    rowmax = torch.empty((r, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = fn(vp.data_ptr(), rot.data_ptr(), q.data_ptr(),
                  rowmax.data_ptr(), m, c, r, sign_seed, int(one_mix),
                  row_offset, int(wire == "fp8"),
                  None if signs is None else signs.data_ptr(), _stream(dev))
    _build.check(code, "cet_sketch_quant")
    sketch_quant_kernel.launches += 1
    return q, rowmax


sketch_quant_kernel.launches = 0


def sketch_quant_route(c: int, r: int, wire: str, one_mix: bool,
                       signs: bool, device) -> str:
    """The route ``sketch_quant_kernel`` takes for r rows of width c on
    ``device``: "all_rows" (the sketch kernel's core, one co-resident
    wave) or "tiles" (where that grid is not co-resident: one thread a
    bucket), as csrc/sketch.cu ``cet_sketch_quant_route`` decides it;
    "plain" on the CPU. ``signs``: whether the call passes the stream."""
    _check_wire("sketch_quant_route", wire)
    device = torch.device(device)
    if device.type == "cpu":
        return "plain"
    fn = _build.bind("sketch", "cet_sketch_quant_route",
                     [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, _P])
    route = ctypes.c_int(-1)
    with torch.cuda.device(device):
        code = fn(c, r, int(one_mix), int(signs), int(wire == "fp8"),
                  ctypes.addressof(route))
    _build.check(code, "cet_sketch_quant_route")
    return ("tiles", "all_rows")[route.value]


def estimates_kernel(table, rot, c: int, r: int, sign_seed: int,
                     one_mix: bool, valid: int) -> torch.Tensor:
    """(r, c) f32 table, (r, m) int32 rotations -> (m*c,) f32
    estimates, zero at positions >= ``valid``. Kernel on CUDA
    (csrc/sketch.cu ``cet_estimates``), plain version on the CPU."""
    if table.device.type == "cpu":
        return estimates_plain(table, rot, c, r, sign_seed, one_mix,
                               valid)
    dev = _check_cuda("estimates_kernel", table=(table, torch.float32),
                      rot=(rot, torch.int32))
    if tuple(table.shape) != (r, c) or rot.shape[0] != r:
        raise ValueError(f"estimates_kernel: table {tuple(table.shape)},"
                         f" rot {tuple(rot.shape)} do not fit r={r}, c={c}")
    _check_max_rows("estimates_kernel", r)
    m = rot.shape[1]
    _check_index_range("estimates_kernel", m, c)
    fn = _build.bind("sketch", "cet_estimates",
                     [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_uint, ctypes.c_int,
                      ctypes.c_longlong, _P])
    out = torch.empty(m * c, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = fn(table.data_ptr(), rot.data_ptr(), out.data_ptr(), m, c,
                  r, sign_seed, int(one_mix), valid, _stream(dev))
    _build.check(code, "cet_estimates")
    estimates_kernel.launches += 1
    return out


estimates_kernel.launches = 0


def estimates_window_kernel(table, rot, c: int, r: int, sign_seed: int,
                            one_mix: bool, valid: int, lo: int,
                            hi: int) -> torch.Tensor:
    """(r, c) f32 table -> the (hi - lo,) f32 estimates of coordinates
    lo .. hi - 1 alone, zero at positions >= ``valid``: one model
    peer's slice on the 2-D server (the reference's ``estimates_at``
    over a contiguous index range, ops/sketch.py:515). Kernel on CUDA
    (csrc/sketch.cu ``cet_estimates_window``), each output bit for bit
    the whole-range kernel's; ``estimates_plain`` over the window on
    the CPU."""
    m = rot.shape[1]
    if table.device.type == "cpu":
        _check_window("estimates_window_kernel", lo, hi, m, c)
        return estimates_plain(table, rot, c, r, sign_seed, one_mix,
                               valid, window=(lo, hi))
    dev = _check_cuda("estimates_window_kernel",
                      table=(table, torch.float32), rot=(rot, torch.int32))
    if tuple(table.shape) != (r, c) or rot.shape[0] != r:
        raise ValueError(f"estimates_window_kernel: table "
                         f"{tuple(table.shape)}, rot {tuple(rot.shape)} do "
                         f"not fit r={r}, c={c}")
    _check_max_rows("estimates_window_kernel", r)
    _check_index_range("estimates_window_kernel", m, c)
    _check_window("estimates_window_kernel", lo, hi, m, c)
    fn = _build.bind("sketch", "cet_estimates_window",
                     [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_uint, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_longlong, _P])
    out = torch.empty(hi - lo, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = fn(table.data_ptr(), rot.data_ptr(), out.data_ptr(), m, c,
                  r, sign_seed, int(one_mix), valid, lo, hi, _stream(dev))
    _build.check(code, "cet_estimates_window")
    estimates_window_kernel.launches += 1
    return out


estimates_window_kernel.launches = 0


def l2_read_rate(dev, mib: int = 16, passes: int = 32,
                 reps: int = 5) -> float:
    """Bytes/s at which the SMs read an L2-resident ``mib`` MiB buffer
    through L2, bypassing L1 (csrc/sketch.cu ``cet_l2_read_probe``,
    16-byte loads, 8 blocks of 256 threads an SM): the rate behind the
    sketch and estimates kernels' design floors. A measurement on the
    card, on no path of the port; the median of ``reps`` timed launches
    after one that warms L2."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        raise ValueError(f"l2_read_rate: {dev} is not a CUDA device")
    fn = _build.bind("sketch", "cet_l2_read_probe",
                     [_P, ctypes.c_longlong, ctypes.c_int, _P, ctypes.c_int,
                      _P])
    n4 = mib * 2**20 // 16
    buf = torch.ones(4 * n4, dtype=torch.float32, device=dev)
    blocks = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(blocks * 256, dtype=torch.float32, device=dev)
    times = []
    with torch.cuda.device(dev):
        for i in range(reps + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            code = fn(buf.data_ptr(), n4, passes, out.data_ptr(), blocks,
                      _stream(dev))
            end.record()
            _build.check(code, "cet_l2_read_probe")
            end.synchronize()
            if i:
                times.append(start.elapsed_time(end) * 1e-3)
    times.sort()
    return 16 * n4 * passes / times[len(times) // 2]

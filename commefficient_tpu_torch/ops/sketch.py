"""Count sketch (CSVec) -- the FetchSGD compression operator.

Port of ``commefficient_tpu/ops/sketch.py``: the same rotation
(circulant) count sketch, with identical hashes, so a table built by
either package is recovered identically by the other.

- An ``(r, c)`` table of buckets. The padded coordinate space is cut
  into ``m = ceil(d/c)`` chunks of width c; row r sends coordinate
  ``i`` (chunk ``t = i // c``, offset ``j = i % c``) to bucket
  ``(j + o[r, t]) mod c`` with sign ``s_r(i)``.
- Rotations ``o`` are host-side numpy (``_rotations``); signs are
  murmur mixes of the coordinate index (``_mix``), for r <= 8 also
  packed a byte a coordinate (``packed_signs_on``), which the sketch
  reads instead of hashing.
- Recovery ``v[i] ~ median_r(s_r(i) * table[r, h_r(i)])``.

The hash layer is bit-exact with the reference. torch has no full
uint32 arithmetic on the CPU, so the plain versions hold uint32
values in int64 and mask with ``& 0xFFFFFFFF``; a 32x32-bit product
can exceed 2^63, so ``_mul32`` splits one factor into 16-bit halves.
The CUDA kernels use ``uint32_t`` (csrc/hash.cuh).

Dispatch: ``sketch``, ``sketch_quantized`` and ``estimates`` call the
kernel wrappers of ``ops/sketch_kernels.py``, which launch the Hopper
kernels for CUDA tensors and take the plain versions for CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_ROW_SALT = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a constant
    ``c`` < 2^32, without int64 overflow: c = hi·2^16 + lo, and only
    the low 16 bits of x·hi survive the shift."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def _np_mix(x: np.ndarray) -> np.ndarray:
    """numpy twin of _mix (uint32 wraparound)."""
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(_M1)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(_M2)
        x = x ^ (x >> np.uint32(16))
    return x


def sign_bits(idx: torch.Tensor, row: int, sign_seed: int,
              one_mix: bool, h: torch.Tensor = None) -> torch.Tensor:
    """0/1 int64 sign bit of ``row`` for coordinate indices ``idx``
    (int64): bit 16+row of one mix per coordinate for r <= 16
    (``h = _mix(idx ^ sign_seed)`` may be passed in to share it
    across rows), else bit 16 of a per-row salted mix."""
    if one_mix:
        if h is None:
            h = _mix(idx ^ sign_seed)
        return (h >> (16 + row)) & 1
    salt = ((row * _ROW_SALT) & _MASK32) ^ sign_seed
    return (_mix(idx ^ salt) >> 16) & 1


def signs_from_bits(bits: torch.Tensor) -> torch.Tensor:
    return 1.0 - 2.0 * bits.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class CountSketch:
    """Static description of a sketch operator (d, c, r, seed), as
    the reference's ``CountSketch``. ``num_blocks`` is accepted for
    CLI parity and unused. The reference's ``backend`` field has no
    counterpart (the tensor's device picks kernel or plain version),
    and its ``packed_signs`` (on by default there) is always on: where
    eligible (``_packed_signs``) the sketch reads its signs from the
    stream of ``packed_signs_on``; the estimates and sketch-and-quantize
    kernels hash them in-register."""

    d: int
    c: int
    r: int
    num_blocks: int = 20
    seed: int = 42
    approx_topk: bool = False
    approx_recall: float = 0.95
    rot_lanes: int = 0

    def __post_init__(self):
        assert self.d > 0 and self.c > 0 and self.r > 0
        # (r, m) rotations and the packed-sign stream on each device
        # they were asked for
        object.__setattr__(self, "_rot_cache", {})
        object.__setattr__(self, "_sign_cache", {})

    # --- hashing ---------------------------------------------------------

    @property
    def _m(self) -> int:
        """number of coordinate chunks"""
        return -(-self.d // self.c)

    @property
    def _padded_d(self) -> int:
        return self._m * self.c

    def _seeds(self):
        base = np.uint64(self.seed & _MASK32)
        mask = np.uint64(_MASK32)
        rot = np.uint32((base * np.uint64(0x9E3779B9) + np.uint64(1)) & mask)
        sign = np.uint32((base * np.uint64(0x6C62272E) + np.uint64(2)) & mask)
        return rot, sign

    def _rotations(self) -> np.ndarray:
        """(r, m) rotations in [0, c), host-side numpy; with
        ``rot_lanes`` set, multiples of it drawn from c/rot_lanes."""
        rot_seed, _ = self._seeds()
        rows = np.arange(self.r, dtype=np.uint32)[:, None]
        chunks = np.arange(self._m, dtype=np.uint32)[None, :]
        with np.errstate(over="ignore"):
            h = _np_mix(rows * np.uint32(0x7FEB352D)
                        ^ chunks * np.uint32(0x846CA68B)
                        ^ rot_seed)
        if self.rot_lanes > 0:
            assert self.c % self.rot_lanes == 0, (self.c, self.rot_lanes)
            assert self.c // self.rot_lanes >= 8, \
                f"rot_lanes {self.rot_lanes} too coarse for c={self.c}"
            s = np.uint32(self.c // self.rot_lanes)
            return ((h % s) * np.uint32(self.rot_lanes)).astype(np.int64)
        return (h % np.uint32(self.c)).astype(np.int64)

    def rotations_on(self, device) -> torch.Tensor:
        """(r, m) int32 rotations on ``device`` (cached)."""
        device = torch.device(device)
        key = str(device)
        rot = self._rot_cache.get(key)
        if rot is None:
            rot = torch.from_numpy(self._rotations().astype(np.int32))
            if device.type == "cuda":
                # from pinned memory, so that the first round that asks
                # for them does not stop the host
                rot = rot.pin_memory().to(device, non_blocking=True)
            self._rot_cache[key] = rot
        return rot

    @property
    def _one_mix_signs(self) -> bool:
        """r <= 16: every row's sign is a distinct high bit of ONE
        murmur mix per coordinate; larger r mixes per (row, coord)."""
        return self.r <= 16

    @property
    def _packed_signs(self) -> bool:
        """One-mix signs of at most 8 rows fit a byte a coordinate: the
        sketch kernel then reads them (``packed_signs_on``)."""
        return self._one_mix_signs and self.r <= 8

    def packed_signs_on(self, device):
        """(padded_d,) uint8 packed-sign stream on ``device`` (cached),
        or None where ``_packed_signs`` is false: bit ``row`` is bit
        16+row of the coordinate's one mix, the sign bit that
        ``sign_bits`` reads, as the reference's
        ``_packed_signs_traced`` (ops/sketch.py:230). Made once, on the
        device, in slices of 2^20 coordinates, so that the int64 scratch
        of the uint32 math stays near 40 MB."""
        if not self._packed_signs:
            return None
        device = torch.device(device)
        key = str(device)
        out = self._sign_cache.get(key)
        if out is None:
            out = torch.empty(self._padded_d, dtype=torch.uint8,
                              device=device)
            mask = (1 << self.r) - 1
            step = 1 << 20
            for lo in range(0, self._padded_d, step):
                idx = torch.arange(lo, min(lo + step, self._padded_d),
                                   dtype=torch.int64, device=device)
                out[lo:lo + idx.numel()] = (
                    (_mix(idx ^ self.sign_seed) >> 16) & mask).to(torch.uint8)
            self._sign_cache[key] = out
        return out

    @property
    def sign_seed(self) -> int:
        return int(self._seeds()[1])

    def _signs_row(self, row: int, device="cpu") -> torch.Tensor:
        """(padded_d,) float32 signs of one row."""
        idx = torch.arange(self._padded_d, dtype=torch.int64,
                           device=device)
        return signs_from_bits(sign_bits(idx, row, self.sign_seed,
                                         self._one_mix_signs))

    def hashes(self, idx: torch.Tensor):
        """(buckets, signs) of int coordinate indices: buckets int64
        (r, n) in [0, c); signs float32 (r, n) in {+-1}."""
        i = idx.to(torch.int64)
        rot = self.rotations_on(i.device).to(torch.int64)
        t = i // self.c
        j = i % self.c
        buckets = (j[None, :] + rot[:, t]) % self.c
        h = _mix(i ^ self.sign_seed) if self._one_mix_signs else None
        signs = torch.stack([
            signs_from_bits(sign_bits(i, row, self.sign_seed,
                                      self._one_mix_signs, h))
            for row in range(self.r)])
        return buckets, signs

    # --- sketching -------------------------------------------------------

    def sketch(self, v: torch.Tensor) -> torch.Tensor:
        """Dense (d,) vector -> (r, c) table."""
        assert v.shape == (self.d,), v.shape
        vp = torch.nn.functional.pad(v.to(torch.float32),
                                     (0, self._padded_d - self.d))
        return self._sketch_padded(vp)

    def _sketch_padded(self, vp: torch.Tensor) -> torch.Tensor:
        from commefficient_tpu_torch.ops.sketch_kernels import \
            sketch_kernel
        assert vp.shape == (self._padded_d,), vp.shape
        return sketch_kernel(vp.contiguous(),
                             self.rotations_on(vp.device), self.c,
                             self.r, self.sign_seed, self._one_mix_signs,
                             signs=self.packed_signs_on(vp.device))

    def sketch_window(self, v: torch.Tensor, lo: int,
                      hi: int) -> torch.Tensor:
        """The (r, c) table of the coordinates [lo, hi) of the dense
        (d,) vector ``v`` alone: one model peer's partial table of the
        2-D emission, the slices' tables summing to ``sketch(v)``
        (reference ``_partial_table_emit``, core/rounds.py:426-500,
        which scatters the slice through ``sketch_sparse``). Kernel 1
        over the window on the card (``sketch_window_kernel``)."""
        from commefficient_tpu_torch.ops.sketch_kernels import \
            sketch_window_kernel
        assert v.shape == (self.d,), v.shape
        assert 0 <= lo <= hi <= self.d, (lo, hi, self.d)
        vp = torch.nn.functional.pad(v.to(torch.float32),
                                     (0, self._padded_d - self.d))
        return sketch_window_kernel(vp.contiguous(),
                                    self.rotations_on(vp.device), self.c,
                                    self.r, self.sign_seed,
                                    self._one_mix_signs, lo, hi,
                                    signs=self.packed_signs_on(vp.device))

    def sketch_quantized(self, v: torch.Tensor, wire: str, rows=None):
        """Dense (d,) vector -> (wire-dtype table, (rows, 1) f32 rowmax),
        quantized per row at full range (``quant.quantize_local``):
        int8/fp8 through the fused emit + quantize kernel, whose f32
        table never reaches device memory; bf16 is the f32 sketch cast,
        with rowmax None. Both read their signs from the packed-sign
        stream where the sketch has one (``packed_signs_on``), as
        ``sketch`` does. Callers harmonize onto the shared scale
        (core/rounds.py).

        ``rows=(offset, count)``: only those table rows (a row chunk of
        ``--overlap_depth``), with the chunk's rows of the rotations and
        signs keyed by the absolute row, so a chunk equals the same rows
        of a whole-table call (scales are per row). Reference
        ``CountSketch.sketch_quantized`` (ops/sketch.py:399)."""
        from commefficient_tpu_torch.ops.quant import quantize_local
        from commefficient_tpu_torch.ops.sketch_kernels import (
            sketch_kernel, sketch_quant_kernel)
        off, cnt = rows if rows is not None else (0, self.r)
        assert 0 <= off and 0 < cnt and off + cnt <= self.r, \
            (off, cnt, self.r)
        assert v.shape == (self.d,), v.shape
        vp = torch.nn.functional.pad(v.to(torch.float32),
                                     (0, self._padded_d - self.d))
        rot = self.rotations_on(vp.device)[off:off + cnt]
        args = (vp.contiguous(), rot, self.c, cnt, self.sign_seed,
                self._one_mix_signs)
        signs = self.packed_signs_on(vp.device)
        if wire == "bf16":
            # scale-free cast: nothing to fuse
            return quantize_local(sketch_kernel(
                *args, row_offset=off, signs=signs), wire)
        return sketch_quant_kernel(*args, wire, row_offset=off, signs=signs)

    # --- recovery --------------------------------------------------------

    def estimates(self, table: torch.Tensor,
                  padded: bool = False) -> torch.Tensor:
        """Median-of-rows estimates of all coordinates. ``padded=True``
        returns the (padded_d,) vector with the tail (>= d) zeroed;
        otherwise the (d,) prefix."""
        from commefficient_tpu_torch.ops.sketch_kernels import \
            estimates_kernel
        assert table.shape == (self.r, self.c), table.shape
        valid = self.d if padded else self._padded_d
        est = estimates_kernel(table.to(torch.float32).contiguous(),
                               self.rotations_on(table.device), self.c,
                               self.r, self.sign_seed,
                               self._one_mix_signs, valid)
        return est if padded else est[: self.d]

    def estimates_window(self, table: torch.Tensor, lo: int,
                         hi: int) -> torch.Tensor:
        """The (hi - lo,) estimates of coordinates lo .. hi - 1 (of the
        padded space), zero at and past d: one model peer's slice on the
        2-D server, ``estimates(table, padded=True)[lo:hi]`` bit for
        bit. Kernel 2 over the window on the card
        (``estimates_window_kernel``)."""
        from commefficient_tpu_torch.ops.sketch_kernels import \
            estimates_window_kernel
        assert table.shape == (self.r, self.c), table.shape
        assert 0 <= lo <= hi <= self._padded_d, (lo, hi, self._padded_d)
        return estimates_window_kernel(
            table.to(torch.float32).contiguous(),
            self.rotations_on(table.device), self.c, self.r,
            self.sign_seed, self._one_mix_signs, self.d, lo, hi)

    def estimates_at(self, table: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
        """Median-of-rows estimates at arbitrary coordinate indices in
        [0, padded_d) (reference ``estimates_at``, ops/sketch.py:515),
        by gathering each row's (bucket, sign) from ``hashes``: bit for
        bit ``estimates(table, padded=True)[idx]`` below d (the same
        products, the same median network); the padded tail reads
        whatever its buckets hold, so callers mask it. The reference's
        API, held by the tests: the 2-D server takes
        ``estimates_window``, its kernel form over a contiguous
        range."""
        from commefficient_tpu_torch.ops.sketch_kernels import \
            median_network
        assert table.shape == (self.r, self.c), table.shape
        buckets, signs = self.hashes(idx)
        t = table.to(torch.float32)
        return median_network([t[row][buckets[row]] * signs[row]
                               for row in range(self.r)])

    def unsketch(self, table: torch.Tensor, k: int,
                 with_support: bool = False, with_dense: bool = True):
        """(r, c) table -> dense (d,) vector keeping the k largest-
        magnitude estimates (reference ``unsketch``). The selected set
        is the threshold select's, which is lax.top_k's set (lowest
        index wins ties); the (k,) indices come back in ascending
        order rather than by magnitude. At d >= 2^20 the selection
        runs over the padded estimates with the tail zeroed (the same
        set, since k <= d). ``with_support`` also returns the indices
        and their values; ``with_dense=False`` (with ``with_support``)
        returns ``(None, idx, vals)`` without the dense vector.

        ``approx_topk`` takes the reference's approximate route: the
        indices first, then their values scattered into zeros. Where
        the reference asks ``lax.approx_max_k`` for a set at recall
        ``approx_recall``, the port selects the exact set, which meets
        any recall target (and is what approx_max_k returns on the
        CPU)."""
        from commefficient_tpu_torch.ops.topk import (
            _THRESHOLD_SELECT_MIN_D, compact_mask, threshold_topk_indices,
            threshold_topk_mask_1d)
        k = min(k, self.d)
        big_d = self.d >= _THRESHOLD_SELECT_MIN_D
        est = self.estimates(table, padded=big_d)
        if self.approx_topk or not with_dense:
            idx = (threshold_topk_indices(est * est, k) if k < self.d
                   else torch.arange(self.d, device=est.device))
            vals = est[idx]
            if self.approx_topk and big_d:
                # the reference's guard for approximate picks in the
                # zeroed tail: clamp them in range with value 0. An
                # exact selection never reaches the tail (lowest index
                # wins ties and k <= d), so here it changes nothing
                oob = idx >= self.d
                idx = torch.clamp(idx, max=self.d - 1)
                vals = torch.where(oob, torch.zeros_like(vals), vals)
            if not with_dense:
                assert with_support, "with_dense=False needs with_support"
                return None, idx, vals
            # scatter-ADD into zeros, as the reference: a guarded
            # (d-1, 0) duplicate is inert under add. Unchecked indices
            # (in range by construction): the public index_put_ reads
            # their range back to the host
            dense = torch.zeros(self.d, dtype=torch.float32,
                                device=est.device)
            torch.ops.aten._index_put_impl_(dense, (idx,), vals, True,
                                            True)
            return (dense, idx, vals) if with_support else dense
        if k >= self.d:
            mask = torch.ones_like(est, dtype=torch.bool)
        else:
            mask = threshold_topk_mask_1d(est * est, k)
        dense = torch.where(mask, est, torch.zeros_like(est))[: self.d]
        if not with_support:
            return dense
        idx = compact_mask(mask[: self.d], k)
        return dense, idx, est[idx]

    def unsketch_dense_mask(self, table: torch.Tensor, k: int):
        """Exact dense unsketch through the threshold-select mask:
        ``(dense, mask)``, the k largest-magnitude estimates kept."""
        from commefficient_tpu_torch.ops.topk import threshold_topk_mask_1d
        k = min(k, self.d)
        est = self.estimates(table)
        mask = threshold_topk_mask_1d(est * est, k)
        return torch.where(mask, est, torch.zeros_like(est)), mask

    def prefer_threshold_unsketch(self, k: int) -> bool:
        """Dense-regime exact recovery through the threshold mask:
        the reference's gate, same predicate (false under
        ``approx_topk``, which keeps the index route)."""
        from commefficient_tpu_torch.ops.topk import use_threshold_select
        return (use_threshold_select(k, self.d, self.approx_topk)
                and not self.prefer_sparse_resketch(k))

    def sketch_sparse(self, idx: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
        """(n,) indices + (n,) values -> (r, c) table, equal (to
        summation order) to ``sketch`` of the dense scatter of ``vals``
        at ``idx``: O(r*n) scatter-adds instead of an O(d) pass, the
        form that wins for re-sketching a k-sparse update once d >> r*k
        (``prefer_sparse_resketch``). Plain PyTorch, as the reference
        leaves it to XLA (sketch.py:636)."""
        buckets, signs = self.hashes(idx)
        rows = torch.arange(self.r, device=idx.device)[:, None]
        table = torch.zeros((self.r, self.c), dtype=torch.float32,
                            device=idx.device)
        # index_put_(accumulate=True) without its range check: on the
        # card the check reads the indices' max and min back to the
        # host (two syncs a round); rows and buckets are in range by
        # construction. The sums run in the same (sorted) order
        torch.ops.aten._index_put_impl_(
            table, (rows.expand_as(buckets), buckets),
            signs * vals.to(torch.float32)[None, :], True, True)
        return table

    def prefer_sparse_resketch(self, k: int) -> bool:
        """The reference's cost-model gate for re-sketching the
        k-sparse update by scatter (d > ~90*r*k); same predicate."""
        return self.d > 90 * self.r * k

    # --- norms -----------------------------------------------------------

    @staticmethod
    def l2estimate(table: torch.Tensor) -> torch.Tensor:
        """sqrt(median over rows of per-row sum of squares); the mean
        of the two middle rows for even r, as jnp.median. A (C, r, c)
        stack gives each table's estimate, (C,)."""
        sums = torch.sort(torch.sum(table * table, dim=-1), dim=-1).values
        n = sums.shape[-1]
        med = (sums[..., n // 2] if n % 2
               else (sums[..., n // 2 - 1] + sums[..., n // 2]) * 0.5)
        return torch.sqrt(med)

    def recovery_error(self, table: torch.Tensor, dense: torch.Tensor,
                       k: int) -> torch.Tensor:
        """Relative top-k recovery error ‖unsketch(table, k) − dense‖ /
        ‖dense‖ against the true dense vector (reference
        ``recovery_error``, ops/sketch.py:668; ``--probe_full``'s
        probe). It runs the recovery again: the estimates kernel, the
        threshold search and the take-mask. A zero vector reports 0."""
        assert dense.shape == (self.d,), dense.shape
        est = self.unsketch(table, k)
        dense = dense.to(torch.float32)
        num = torch.linalg.vector_norm(est - dense)
        den = torch.linalg.vector_norm(dense)
        return torch.where(den > 0, num / torch.clamp(den, min=1e-30),
                           torch.zeros_like(den))


def clip_record(record: torch.Tensor, clip: float, *,
                is_sketch: bool) -> torch.Tensor:
    """L2-clip a dense vector, or a sketch table by its l2estimate;
    only ever shrinks (reference ``clip_record``, ops/sketch.py:683).
    A (C, r, c) stack of tables is clipped table by table."""
    if not is_sketch:
        from commefficient_tpu_torch.ops.vec import clip_by_l2
        return clip_by_l2(record, clip)
    norm = CountSketch.l2estimate(record)
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    return record * scale[..., None, None]

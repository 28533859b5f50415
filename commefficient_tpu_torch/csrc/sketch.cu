// Rotation count sketch kernels for Hopper (sm_90a): the emit
// (sketch) and the median-of-rows recovery (estimates).
//
// Geometry (JAX package, ops/sketch.py): the padded coordinate space of
// m*c floats is cut into m chunks of width c; row `row` sends coordinate
// g = t*c + j (chunk t, offset j) to bucket (j + o[row, t]) mod c with
// sign s_row(g) from the murmur mix of g (hash.cuh).
//
// --- cet_sketch -- replaces sketch_pallas (commefficient_tpu/ops/
// sketch_pallas.py:216-290). The TPU kernel streams chunk t through a
// VMEM-resident table and rolls it into place, carrying the table across
// a sequential grid. Hopper blocks run in no order, so the scatter
// becomes a gather: bucket (row, col) sums s_row(g) * v[g] over the
// chunks t = 0..m-1 in order, from zero, with g = t*c + ((col - o[row,
// t]) mod c). No atomics, no split over t: one fixed summation order,
// the plain version's, so the two agree bit for bit (and so does
// kernel 4's table, which sums on the same core, or through cet_bucket
// in the same order).
// Any rotation and any c work (no 128-lane constraint).
//   HBM bound: one read of v (4*m*c) and one write of the table (4*r*c).
//   L2 floor: every row reads all of v at its own rotation, so r*4*m*c
// bytes (and r*m*c sign bytes, below) go from L2 to the SMs whatever
// the design. At GPT-2 shapes v is 499 MB, ten times the 50 MB L2: if
// the r rows' reads of chunk t fall far apart in time, each row reads v
// from HBM again (as a grid of one thread a bucket, whose blocks run
// row after row, does: 5 x 499 MB from HBM).
//   Design: a thread owns CET_SK_COLS columns (CET_SK_THREADS apart, so
// that each load of a warp is 32 consecutive floats) for all rows of a
// row group (up to 8 rows; r > 8 runs in groups, one a grid row), with
// rows x columns independent accumulators, and the grid (c / 1024
// blocks a row group) fits one wave on 132 SMs at 4 blocks an SM
// (__launch_bounds__): all blocks walk t together, the rows of chunk t
// read it close together in time, and L2 serves rows 2..r from a
// working set of a few 2 MB chunks. A block stages its rows'
// rotations in shared memory, CET_SK_TT chunks at a time.
//   Signs: the rows read different coordinates, so hashing costs one
// murmur mix per (row, element). Where the sign source is one mix of
// at most 8 rows (the main paths), the kernel reads the reference's
// packed-sign stream instead (commefficient_tpu/ops/sketch.py:224-238:
// a byte a coordinate, bit `row` the row's sign bit, made once per
// CountSketch on the device): 0.18 ms less at GPT-2 shapes on an H100
// 80GB HBM3 at 700 W (sketch_ablation: `hashed` against `base`), for
// one 125 MB buffer.
// Otherwise it hashes, the sign source a template argument.
//
// --- cet_estimates -- replaces estimates_pallas (commefficient_tpu/
// ops/sketch_pallas.py:414-485). Output g = t*c + j is the median over
// rows of s_row(g) * table[row, (j + o[row, t]) mod c], by the same
// network as _median_network (sketch_pallas.py:165-191): exact for odd
// r, the mean of the two middles for even r; 0 at g >= valid. The
// (r, m*c) intermediate never exists.
//   HBM bound: one write of the estimates (4*m*c; the 4*r*c table is
// L2-resident at 10.5 MB). L2 floor: each output reads r table entries
// at rotations that differ per chunk, so tiles cannot share them:
// r*4*m*c bytes from L2.
//   Design: the grid is (column tile, chunk t), so t and j come from
// the block indices with no 64-bit division; a block loads the r
// rotations of its chunk once into shared memory; a thread takes
// CET_ES_VEC consecutive outputs (one 16-byte store where c % 4 == 0),
// r*CET_ES_VEC independent table loads in flight; one-mix signs take
// one mix a coordinate for all rows (the sign source a template
// argument, as in the sketch); a tile wholly at or past `valid` writes
// zeros and loads nothing. Signs are hashed: reading the packed-sign
// stream instead was slower here, 0.71 against 0.49 ms on the same
// card (sketch_ablation `packed_signs`).
//
// --- cet_sketch_window, cet_estimates_window -- kernels 1 and 2 over
// a window [lo, hi) of the coordinates, for the 2-D mesh (one model
// peer's contiguous ceil(d/M) slice). The reference makes the peer's
// partial table with sketch_sparse of the slice (commefficient_tpu/core/
// rounds.py:426-500) and its estimates with estimates_at over the slice's
// indices (ops/sketch.py:515-533); here they are the same kernels with
// the chunk loop's bounds cut to the chunks that hold the window and the
// two edge chunks masked (sketch: a template flag of cet_sketch_sums, so
// the whole-range instantiations compile as before), or the grid cut to
// those chunks and the stores to the window (estimates, whose coordinates
// stay uint32). The windowed table is the plain sketch of the vector
// zeroed outside the window, bit for bit (skipped terms would add +-0 to
// an accumulator that is never -0); each windowed estimate is the
// whole-range kernel's. Bound: bytes, the window's read (and, for the
// sketch, its sign bytes) plus the table's write (sketch) or read
// (estimates), at 1/M of the whole-range kernel's reads.
//
// --- cet_sketch_quant -- replaces sketch_quant_pallas (commefficient_
// tpu/ops/sketch_pallas.py:293-411), the fused emit + quantize of the
// --sketch_dtype int8|fp8 wire: the table of r rows (a row chunk under
// --overlap_depth, signs keyed by the absolute row row_offset + row),
// then per row rm = max|row|, s = rm > 0 ? rm/qmax : 1, and
// q = clip(rint(x/s), -127, 127) (int8) or e4m3fn(f16(x/s)) (fp8); out
// come q (r, c) and rowmax (r, 1) f32. The TPU kernel keeps the f32
// table in a VMEM scratch across its sequential grid; here the table
// stays in registers across one grid barrier and never reaches device
// memory, in one cooperative launch (cudaLaunchCooperativeKernel).
//   HBM bound: one read of v (4*m*c) and of the rotations (4*r*m), one
// write of q (r*c) and rowmax (4*r). Design floor: kernel 1's L2 floor
// (r reads of v, and of the sign stream where it is read) plus the q
// write from HBM's side.
//   Design (the all-rows route, cet_sketch_quant_rows_kernel): kernel
// 1's core, cet_sketch_sums, unchanged -- a thread owns COLS columns of
// every row of a row group, one co-resident wave, the packed-sign stream
// where the sign source is one mix of at most 8 rows -- so the table is
// bit-equal to cet_sketch's by construction. In place of the table
// store:
//   1. the row max of |x| as uint32 bits (non-negative floats order as
//      uint32, and NaN's bits lie above inf's, so NaN propagates as in
//      jnp.max, where fmaxf would drop it): a warp max, one shared
//      atomicMax per warp and row, one global atomicMax per block and
//      row into the rowmax output, which the entry point zeroes first;
//   2. cg::this_grid().sync();
//   3. quantize the RG x COLS accumulators from registers and store q.
//   Dispatch by geometry, deterministic for a shape on a given card: the
// all-rows route where its grid (cet_sketch's, c / (256*COLS) x row
// groups) is co-resident at the kernel's occupancy, as on the main
// paths (r = 5 whole, r = 3 and 2 in --overlap_depth 2 chunks: 512
// blocks against 132 SMs x 4 at c = 524 288). Otherwise (many row groups
// of r > 8, or a much larger c) the tile route, cet_sketch_quant_kernel,
// the first design: one thread a bucket (cet_bucket, the same order, so
// the same table), 256-bucket tiles of one row dealt round-robin to a
// grid sized by occupancy, the first K (8, 16 or 32) tiles a thread kept
// in registers and the tiles past the 32nd recomputed after the barrier;
// it hashes the signs (the stream holds the same bits).
// cet_sketch_quant_route names the route a shape takes. At GPT-2 shapes
// (r = 5, c = 524 288, m = 238) the all-rows route took 0.52-0.58 ms
// against the tile route's 1.27-1.33, int8 and fp8 (H100 80GB HBM3 at
// 700 W, python -m commefficient_tpu_torch.kernel_ab).
//   Rounding matches ops/quant.py byte for byte: x/s and rm/qmax are
// IEEE divisions (the build has no --use_fast_math, -prec-div=false or
// -ftz=true), rintf rounds half to even as torch.round and jnp.round,
// and fp8 goes f32 -> f16 (__float2half_rn) -> e4m3fn
// (__nv_cvt_halfraw_to_fp8, round to nearest even) as quant._to_fp8
// does: a direct f32 -> e4m3 convert differs in near-tie cases.
// __NV_SATFINITE never engages: |x/s| <= 448 once rounded to f16.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

#define CET_MAX_ROWS 32
#define CET_SQ_THREADS 256
#define CET_SK_THREADS 256
#define CET_SK_TT 128
#define CET_ES_THREADS 256
#define CET_ES_VEC 4
// sign sources of the sketch kernel: a mix per (row, coordinate), one
// mix per coordinate, or the packed-sign stream
#define CET_SIGNS_ROW_MIX 0
#define CET_SIGNS_ONE_MIX 1
#define CET_SIGNS_STREAM 2
// rows a group and columns a thread of the sketch's core for r = 1..8;
// r > 8 runs in groups of 8 at 2 columns, the last group ragged
#define CET_SK_GEOMETRY(X) \
  X(1, 4) X(2, 4) X(3, 4) X(4, 4) X(5, 4) X(6, 2) X(7, 2) X(8, 2)

namespace cg = cooperative_groups;

// bucket `col` of the row whose rotations are `orow`, signs of absolute
// row `srow`: the chunks t = 0..m-1 added in order from zero
__device__ __forceinline__ float cet_bucket(const float* __restrict__ v,
                                            const int* __restrict__ orow,
                                            int m, int c, int col, int srow,
                                            uint32_t seed, int one_mix) {
  float acc = 0.f;
  for (int t = 0; t < m; ++t) {
    int j = col - __ldg(orow + t);
    if (j < 0) j += c;
    const uint32_t g = (uint32_t)t * (uint32_t)c + (uint32_t)j;
    acc += cet_apply_flip(__ldg(v + g),
                          cet_sign_flip(g, srow, seed, one_mix));
  }
  return acc;
}

// the sums of one block's buckets, t = 0..m-1 in order from zero, into
// acc: rows x columns of a row group of up to RG rows (exactly RG
// unless RAGGED), COLS columns a thread, CET_SK_THREADS apart. SIGNS
// (CET_SIGNS_*) is a template argument so that each element takes one
// sign source: with the choice made at run time the compiler computes
// both mixes and selects. The core of kernels 1 and 4.
// WIN: only the coordinates g in [lo, hi) count, from the chunks
// t_begin .. t_end - 1 that hold them (the 2-D emission's slice); the
// others add nothing, as zeros would (acc is never -0: it starts at
// +0, and +0 + -0 is +0), so the table is the plain sketch of the
// vector zeroed outside the window, bit for bit
template <int RG, int COLS, bool RAGGED, int SIGNS, bool WIN = false>
__device__ __forceinline__ void cet_sketch_sums(
    const float* __restrict__ v, const int* __restrict__ rot,
    const uint8_t* __restrict__ sgn, int m, int c, int r, uint32_t seed,
    int row_offset, float (&acc)[RG][COLS], int t_begin = 0, int t_end = 0,
    uint32_t lo = 0, uint32_t hi = 0) {
  __shared__ int srot[RG * CET_SK_TT];
  const int row0 = blockIdx.y * RG;
  const int nr = RAGGED ? min(RG, r - row0) : RG;
  const int base = blockIdx.x * (CET_SK_THREADS * COLS) + threadIdx.x;
  // a column past c recomputes the last one and is not stored, so the
  // chunk loop needs no bounds test
  int col[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    col[k] = min(base + k * CET_SK_THREADS, c - 1);
#pragma unroll
    for (int row = 0; row < RG; ++row) acc[row][k] = 0.f;
  }
  const int tb = WIN ? t_begin : 0;
  const int te = WIN ? t_end : m;
  for (int t0 = tb; t0 < te; t0 += CET_SK_TT) {
    const int nt = min(CET_SK_TT, te - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * nt; i += CET_SK_THREADS) {
      const int row = i / nt;
      const int tt = i - row * nt;
      srot[row * CET_SK_TT + tt] =
          __ldg(rot + (size_t)(row0 + row) * m + t0 + tt);
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const uint32_t tc = (uint32_t)(t0 + tt) * (uint32_t)c;
#pragma unroll
      for (int row = 0; row < RG; ++row) {
        if (!RAGGED || row < nr) {
          const int o = srot[row * CET_SK_TT + tt];
          const int srow = row_offset + row0 + row;
#pragma unroll
          for (int k = 0; k < COLS; ++k) {
            int j = col[k] - o;
            if (j < 0) j += c;
            const uint32_t g = tc + (uint32_t)j;
            if (WIN && (g < lo || g >= hi)) continue;
            const float x = __ldg(v + g);
            const uint32_t flip =
                SIGNS == CET_SIGNS_STREAM
                    ? cet_flip_from_byte(__ldg(sgn + g), srow)
                    : cet_sign_flip(g, srow, seed, SIGNS == CET_SIGNS_ONE_MIX);
            acc[row][k] += cet_apply_flip(x, flip);
          }
        }
      }
    }
  }
}

template <int RG, int COLS, bool RAGGED, int SIGNS>
__global__ void __launch_bounds__(CET_SK_THREADS, 4)
    cet_sketch_kernel(const float* __restrict__ v,
                      const int* __restrict__ rot,
                      const uint8_t* __restrict__ sgn,
                      float* __restrict__ table, int m, int c, int r,
                      uint32_t seed, int row_offset) {
  float acc[RG][COLS];
  cet_sketch_sums<RG, COLS, RAGGED, SIGNS>(v, rot, sgn, m, c, r, seed,
                                           row_offset, acc);
  const int row0 = blockIdx.y * RG;
  const int nr = RAGGED ? min(RG, r - row0) : RG;
  const int base = blockIdx.x * (CET_SK_THREADS * COLS) + threadIdx.x;
#pragma unroll
  for (int row = 0; row < RG; ++row) {
    if (!RAGGED || row < nr) {
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        const int cc = base + k * CET_SK_THREADS;
        if (cc < c) table[(size_t)(row0 + row) * c + cc] = acc[row][k];
      }
    }
  }
}

// kernel 1 over the window [lo, hi) of the coordinates (the 2-D mesh's
// partial table: one model peer's slice): the chunks outside it are not
// read, the two edge chunks are masked. The same store as cet_sketch_kernel
template <int RG, int COLS, bool RAGGED, int SIGNS>
__global__ void __launch_bounds__(CET_SK_THREADS, 4)
    cet_sketch_window_kernel(const float* __restrict__ v,
                             const int* __restrict__ rot,
                             const uint8_t* __restrict__ sgn,
                             float* __restrict__ table, int m, int c, int r,
                             uint32_t seed, int row_offset, int t_begin,
                             int t_end, uint32_t lo, uint32_t hi) {
  float acc[RG][COLS];
  cet_sketch_sums<RG, COLS, RAGGED, SIGNS, true>(
      v, rot, sgn, m, c, r, seed, row_offset, acc, t_begin, t_end, lo, hi);
  const int row0 = blockIdx.y * RG;
  const int nr = RAGGED ? min(RG, r - row0) : RG;
  const int base = blockIdx.x * (CET_SK_THREADS * COLS) + threadIdx.x;
#pragma unroll
  for (int row = 0; row < RG; ++row) {
    if (!RAGGED || row < nr) {
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        const int cc = base + k * CET_SK_THREADS;
        if (cc < c) table[(size_t)(row0 + row) * c + cc] = acc[row][k];
      }
    }
  }
}

__device__ __forceinline__ void cet_sort2(float& a, float& b) {
  const float lo = fminf(a, b);
  const float hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

__device__ __forceinline__ float cet_median3(float x, float y, float z) {
  return fmaxf(fminf(x, y), fminf(fmaxf(x, y), z));
}

// median of v[0..n), the network of sketch_pallas._median_network
template <int R>
__device__ __forceinline__ float cet_median(float* v, int n) {
  if (n == 1) return v[0];
  if (n == 3) return cet_median3(v[0], v[1], v[2]);
  if (n == 5) {
    const float f = fmaxf(fminf(v[0], v[1]), fminf(v[2], v[3]));
    const float g = fminf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
    return cet_median3(v[4], f, g);
  }
  // odd-even transposition sort, n rounds
  for (int rnd = 0; rnd < n; ++rnd) {
    for (int i = rnd & 1; i + 1 < n; i += 2) cet_sort2(v[i], v[i + 1]);
  }
  if (n & 1) return v[n / 2];
  return 0.5f * (v[n / 2 - 1] + v[n / 2]);
}

// median over the rows of output g = t*c + j (srot: the rotations of
// chunk t); R > 0: row count known at compile time (registers), R == 0:
// any r <= CET_MAX_ROWS read at run time; ONE_MIX: one mix for all rows
template <int R, bool ONE_MIX>
__device__ __forceinline__ float cet_estimate(const float* __restrict__ table,
                                              const int* srot, int r, int c,
                                              int j, uint32_t g,
                                              uint32_t seed) {
  const uint32_t h = ONE_MIX ? cet_mix32(g ^ seed) : 0u;
  float vals[R > 0 ? R : CET_MAX_ROWS];
#pragma unroll
  for (int row = 0; row < (R > 0 ? R : CET_MAX_ROWS); ++row) {
    if (row >= r) break;
    int col = j + srot[row];
    if (col >= c) col -= c;
    const float x = __ldg(table + (size_t)row * c + col);
    const uint32_t flip = ONE_MIX ? cet_flip_from_mix(h, row)
                                  : cet_sign_flip(g, row, seed, 0);
    vals[row] = cet_apply_flip(x, flip);
  }
  return cet_median<R>(vals, r);
}

template <int R, bool ONE_MIX>
__global__ void __launch_bounds__(CET_ES_THREADS)
    cet_estimates_kernel(const float* __restrict__ table,
                         const int* __restrict__ rot,
                         float* __restrict__ out, int m, int c, int r_rt,
                         uint32_t seed, long long valid) {
  __shared__ int srot[R > 0 ? R : CET_MAX_ROWS];
  const int r = R > 0 ? R : r_rt;
  const int tile = blockIdx.x * (CET_ES_THREADS * CET_ES_VEC);
  const int j0 = tile + threadIdx.x * CET_ES_VEC;
  const bool vec = (c & 3) == 0 && j0 + CET_ES_VEC <= c;
  for (int t = blockIdx.y; t < m; t += gridDim.y) {
    const long long gt = (long long)t * c;
    float res[CET_ES_VEC];
    if (gt + tile >= valid) {  // the whole tile: zeros, no loads
#pragma unroll
      for (int e = 0; e < CET_ES_VEC; ++e) res[e] = 0.f;
    } else {
      __syncthreads();
      if (threadIdx.x < r)
        srot[threadIdx.x] = __ldg(rot + (size_t)threadIdx.x * m + t);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < CET_ES_VEC; ++e) {
        const int j = min(j0 + e, c - 1);
        const long long g = gt + j0 + e;
        const float x = cet_estimate<R, ONE_MIX>(table, srot, r, c, j,
                                                 (uint32_t)g, seed);
        res[e] = g < valid ? x : 0.f;
      }
    }
    float* o = out + gt + j0;
    if (vec) {
#pragma unroll
      for (int e = 0; e < CET_ES_VEC; e += 4)
        *reinterpret_cast<float4*>(o + e) =
            make_float4(res[e], res[e + 1], res[e + 2], res[e + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < CET_ES_VEC; ++e)
        if (j0 + e < c) o[e] = res[e];
    }
  }
}

// kernel 2 over the window [lo, hi) of the coordinates, out[g - lo]:
// one model peer's slice of the estimates (the 2-D server's estimates_at
// of a contiguous index range). The grid walks only the chunks that
// hold the window; a tile wholly outside it does nothing, one wholly
// at or past `valid` writes zeros; each output is cet_estimate's, so
// bit for bit the whole-range kernel's at the same g
template <int R, bool ONE_MIX>
__global__ void __launch_bounds__(CET_ES_THREADS)
    cet_estimates_window_kernel(const float* __restrict__ table,
                                const int* __restrict__ rot,
                                float* __restrict__ out, int m, int c,
                                int r_rt, uint32_t seed, long long valid,
                                uint32_t lo, uint32_t hi, int t_begin,
                                int t_end) {
  // coordinates as uint32 (m*c < 2^32, checked by the wrapper), so the
  // window's bounds cost no 64-bit registers
  __shared__ int srot[R > 0 ? R : CET_MAX_ROWS];
  const int r = R > 0 ? R : r_rt;
  const int tile = blockIdx.x * (CET_ES_THREADS * CET_ES_VEC);
  const int tile_end = min(tile + CET_ES_THREADS * CET_ES_VEC, c);
  const int j0 = tile + threadIdx.x * CET_ES_VEC;
  const bool aligned = (c & 3) == 0 && (lo & 3) == 0;
  for (int t = t_begin + blockIdx.y; t < t_end; t += gridDim.y) {
    const uint32_t gt = (uint32_t)t * (uint32_t)c;
    if (gt + tile >= hi || gt + tile_end <= lo) continue;  // uniform
    const uint32_t g0 = gt + j0;
    float res[CET_ES_VEC];
    if ((long long)(gt + tile) >= valid) {  // the whole tile: zeros
#pragma unroll
      for (int e = 0; e < CET_ES_VEC; ++e) res[e] = 0.f;
    } else {
      __syncthreads();
      if (threadIdx.x < r)
        srot[threadIdx.x] = __ldg(rot + (size_t)threadIdx.x * m + t);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < CET_ES_VEC; ++e) {
        const int j = min(j0 + e, c - 1);
        const float x =
            cet_estimate<R, ONE_MIX>(table, srot, r, c, j, g0 + e, seed);
        res[e] = (long long)(g0 + e) < valid ? x : 0.f;
      }
    }
    if (aligned && j0 + CET_ES_VEC <= c && g0 >= lo &&
        g0 + CET_ES_VEC <= hi) {
#pragma unroll
      for (int e = 0; e < CET_ES_VEC; e += 4)
        *reinterpret_cast<float4*>(out + (g0 - lo) + e) =
            make_float4(res[e], res[e + 1], res[e + 2], res[e + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < CET_ES_VEC; ++e)
        if (j0 + e < c && g0 + e >= lo && g0 + e < hi)
          out[g0 + e - lo] = res[e];
    }
  }
}

// L2 -> SM read rate probe (a measurement, on no path): each thread
// reads its 16-byte words of an L2-resident buffer `passes` times,
// through L2 only (ld.global.cg), and writes one sum
__global__ void cet_l2_probe_kernel(const float4* __restrict__ buf,
                                    long long n4, int passes,
                                    float* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float s = 0.f;
  for (int p = 0; p < passes; ++p)
#pragma unroll 4
    for (long long i = tid; i < n4; i += stride) {
      const float4 x = __ldcg(buf + i);
      s += (x.x + x.y) + (x.z + x.w);
    }
  out[tid] = s;
}

// --- cet_sketch_quant ------------------------------------------------

// warp max of the |x| bits of one tile into the block's row max
__device__ __forceinline__ void cet_row_max(unsigned int* smax, int row,
                                            float x) {
  unsigned int b = __float_as_uint(x) & 0x7FFFFFFFu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    b = max(b, __shfl_xor_sync(0xFFFFFFFFu, b, off));
  if ((threadIdx.x & 31) == 0 && b) atomicMax(smax + row, b);
}

template <bool FP8>
__device__ __forceinline__ void cet_quant_store(void* q, size_t i, float x,
                                                float s) {
  const float y = x / s;
  if (FP8) {
    const __half_raw h = __float2half_rn(y);
    static_cast<__nv_fp8_storage_t*>(q)[i] =
        __nv_cvt_halfraw_to_fp8(h, __NV_SATFINITE, __NV_E4M3);
  } else {
    static_cast<int8_t*>(q)[i] =
        (int8_t)fminf(fmaxf(rintf(y), -127.f), 127.f);
  }
}

// the all-rows route: cet_sketch_kernel's sums, then the row max, the
// grid barrier and the quantize from the accumulators (cooperative
// launch only)
template <int RG, int COLS, bool RAGGED, int SIGNS, bool FP8>
__global__ void __launch_bounds__(CET_SK_THREADS, 4)
    cet_sketch_quant_rows_kernel(const float* __restrict__ v,
                                 const int* __restrict__ rot,
                                 const uint8_t* __restrict__ sgn, void* q,
                                 float* rowmax, int m, int c, int r,
                                 uint32_t seed, int row_offset) {
  __shared__ unsigned int smax[RG];
  if (threadIdx.x < RG) smax[threadIdx.x] = 0u;
  __syncthreads();
  float acc[RG][COLS];
  cet_sketch_sums<RG, COLS, RAGGED, SIGNS>(v, rot, sgn, m, c, r, seed,
                                           row_offset, acc);
  const int row0 = blockIdx.y * RG;
  const int nr = RAGGED ? min(RG, r - row0) : RG;
  const int base = blockIdx.x * (CET_SK_THREADS * COLS) + threadIdx.x;
  // a column past c holds column c - 1's sum again: the max is the same
#pragma unroll
  for (int row = 0; row < RG; ++row) {
    if (!RAGGED || row < nr) {
      unsigned int b = 0u;
#pragma unroll
      for (int k = 0; k < COLS; ++k)
        b = max(b, __float_as_uint(acc[row][k]) & 0x7FFFFFFFu);
      b = __reduce_max_sync(0xFFFFFFFFu, b);
      if ((threadIdx.x & 31) == 0 && b) atomicMax(smax + row, b);
    }
  }
  __syncthreads();
  if (threadIdx.x < nr && smax[threadIdx.x])
    atomicMax(reinterpret_cast<unsigned int*>(rowmax) + row0 + threadIdx.x,
              smax[threadIdx.x]);
  cg::this_grid().sync();

  const float qmax = FP8 ? 448.f : 127.f;
#pragma unroll
  for (int row = 0; row < RG; ++row) {
    if (!RAGGED || row < nr) {
      const float rm = __ldcg(rowmax + row0 + row);
      const float sc = rm > 0.f ? rm / qmax : 1.f;
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        const int cc = base + k * CET_SK_THREADS;
        if (cc < c)
          cet_quant_store<FP8>(q, (size_t)(row0 + row) * c + cc,
                               acc[row][k], sc);
      }
    }
  }
}

// the tile route: tile = 256 consecutive buckets of one row; block b
// takes tiles b, b + grid, b + 2*grid, ...: the first K in registers
template <int K, bool FP8>
__global__ void __launch_bounds__(CET_SQ_THREADS)
    cet_sketch_quant_kernel(const float* __restrict__ v,
                            const int* __restrict__ rot, void* q,
                            float* rowmax, int m, int c, int r,
                            int tiles_per_row, uint32_t seed, int one_mix,
                            int row_offset) {
  __shared__ unsigned int smax[CET_MAX_ROWS];
  for (int i = threadIdx.x; i < r; i += blockDim.x) smax[i] = 0u;
  __syncthreads();
  const long long ntiles = (long long)r * tiles_per_row;
  float held[K];

#pragma unroll
  for (int k = 0; k < K; ++k) {
    held[k] = 0.f;
    const long long tile = blockIdx.x + (long long)k * gridDim.x;
    if (tile < ntiles) {  // the same for the whole block
      const int row = (int)(tile / tiles_per_row);
      const int col = (int)(tile - (long long)row * tiles_per_row) *
                          CET_SQ_THREADS + threadIdx.x;
      if (col < c)
        held[k] = cet_bucket(v, rot + (size_t)row * m, m, c, col,
                             row_offset + row, seed, one_mix);
      cet_row_max(smax, row, held[k]);
    }
  }
  for (long long tile = blockIdx.x + (long long)K * gridDim.x;
       tile < ntiles; tile += gridDim.x) {
    const int row = (int)(tile / tiles_per_row);
    const int col = (int)(tile - (long long)row * tiles_per_row) *
                        CET_SQ_THREADS + threadIdx.x;
    const float x = col < c ? cet_bucket(v, rot + (size_t)row * m, m, c,
                                         col, row_offset + row, seed,
                                         one_mix)
                            : 0.f;
    cet_row_max(smax, row, x);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < r; i += blockDim.x)
    if (smax[i]) atomicMax(reinterpret_cast<unsigned int*>(rowmax) + i,
                           smax[i]);
  cg::this_grid().sync();

  const float qmax = FP8 ? 448.f : 127.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long tile = blockIdx.x + (long long)k * gridDim.x;
    if (tile < ntiles) {
      const int row = (int)(tile / tiles_per_row);
      const int col = (int)(tile - (long long)row * tiles_per_row) *
                          CET_SQ_THREADS + threadIdx.x;
      if (col < c) {
        const float rm = __ldcg(rowmax + row);
        cet_quant_store<FP8>(q, (size_t)row * c + col, held[k],
                             rm > 0.f ? rm / qmax : 1.f);
      }
    }
  }
  for (long long tile = blockIdx.x + (long long)K * gridDim.x;
       tile < ntiles; tile += gridDim.x) {
    const int row = (int)(tile / tiles_per_row);
    const int col = (int)(tile - (long long)row * tiles_per_row) *
                        CET_SQ_THREADS + threadIdx.x;
    if (col < c) {
      const float rm = __ldcg(rowmax + row);
      cet_quant_store<FP8>(
          q, (size_t)row * c + col,
          cet_bucket(v, rot + (size_t)row * m, m, c, col, row_offset + row,
                     seed, one_mix),
          rm > 0.f ? rm / qmax : 1.f);
    }
  }
}

// cooperative launch at register depth K; returns -1 (nothing
// launched) when the grid it needs is not co-resident and a deeper K
// may be tried
template <int K, bool FP8>
static int cet_sq_launch(bool last, const float* v, const int* rot, void* q,
                         float* rowmax, int m, int c, int r,
                         int tiles_per_row, uint32_t seed, int one_mix,
                         int row_offset, int sms, cudaStream_t stream) {
  void (*kern)(const float*, const int*, void*, float*, int, int, int, int,
               uint32_t, int, int) = cet_sketch_quant_kernel<K, FP8>;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, CET_SQ_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const long long cap = (long long)per_sm * sms;
  const long long ntiles = (long long)r * tiles_per_row;
  const long long want = (ntiles + K - 1) / K;
  if (want > cap && !last) return -1;
  if (cap <= 0) return (int)cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)(want < cap ? want : cap);
  void* args[] = {(void*)&v,    (void*)&rot,           (void*)&q,
                  (void*)&rowmax, (void*)&m,           (void*)&c,
                  (void*)&r,    (void*)&tiles_per_row, (void*)&seed,
                  (void*)&one_mix, (void*)&row_offset};
  return (int)cudaLaunchCooperativeKernel((void*)kern, dim3(grid),
                                          dim3(CET_SQ_THREADS), args, 0,
                                          stream);
}

template <bool FP8>
static int cet_sq_dispatch(const float* v, const int* rot, void* q,
                           float* rowmax, int m, int c, int r,
                           int tiles_per_row, uint32_t seed, int one_mix,
                           int row_offset, int sms, cudaStream_t s) {
  int rc = cet_sq_launch<8, FP8>(false, v, rot, q, rowmax, m, c, r,
                                 tiles_per_row, seed, one_mix, row_offset,
                                 sms, s);
  if (rc == -1)
    rc = cet_sq_launch<16, FP8>(false, v, rot, q, rowmax, m, c, r,
                                tiles_per_row, seed, one_mix, row_offset,
                                sms, s);
  if (rc == -1)
    rc = cet_sq_launch<32, FP8>(true, v, rot, q, rowmax, m, c, r,
                                tiles_per_row, seed, one_mix, row_offset,
                                sms, s);
  return rc;
}

template <int RG, int COLS, bool RAGGED>
static void cet_sketch_launch(const float* v, const int* rot,
                              const uint8_t* sgn, float* table, int m, int c,
                              int r, uint32_t seed, int one_mix,
                              int row_offset, cudaStream_t s) {
  const long long per_block = CET_SK_THREADS * COLS;
  dim3 grid((unsigned)((c + per_block - 1) / per_block),
            (unsigned)((r + RG - 1) / RG));
  if constexpr (!RAGGED) {  // the stream holds 8 rows
    if (sgn) {
      cet_sketch_kernel<RG, COLS, RAGGED, CET_SIGNS_STREAM>
          <<<grid, CET_SK_THREADS, 0, s>>>(v, rot, sgn, table, m, c, r, seed,
                                           row_offset);
      return;
    }
  }
  if (one_mix)
    cet_sketch_kernel<RG, COLS, RAGGED, CET_SIGNS_ONE_MIX>
        <<<grid, CET_SK_THREADS, 0, s>>>(v, rot, sgn, table, m, c, r, seed,
                                         row_offset);
  else
    cet_sketch_kernel<RG, COLS, RAGGED, CET_SIGNS_ROW_MIX>
        <<<grid, CET_SK_THREADS, 0, s>>>(v, rot, sgn, table, m, c, r, seed,
                                         row_offset);
}

// signs: the (m*c,) packed-sign bytes (one_mix, row_offset + r <= 8),
// or null to hash the signs in the kernel
extern "C" int cet_sketch(const float* v, const int* rot, float* table,
                          long long m, long long c, int r,
                          unsigned int seed, int one_mix, int row_offset,
                          const unsigned char* signs, void* stream) {
  if (signs && (!one_mix || row_offset < 0 || row_offset + r > 8))
    return (int)cudaErrorInvalidValue;
  if (m > 0 && c > 0 && r > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int mi = (int)m, ci = (int)c;
#define CET_SK_CASE(RG, COLS)                                              \
  case RG:                                                                 \
    cet_sketch_launch<RG, COLS, false>(v, rot, signs, table, mi, ci, r,    \
                                       seed, one_mix, row_offset, s);      \
    break;
    switch (r) {
      CET_SK_GEOMETRY(CET_SK_CASE)
      default:  // groups of 8 rows, the last one ragged
        cet_sketch_launch<8, 2, true>(v, rot, signs, table, mi, ci, r, seed,
                                      one_mix, row_offset, s);
    }
#undef CET_SK_CASE
  }
  return (int)cudaGetLastError();
}

template <int RG, int COLS, bool RAGGED>
static void cet_sketch_window_launch(const float* v, const int* rot,
                                     const uint8_t* sgn, float* table, int m,
                                     int c, int r, uint32_t seed, int one_mix,
                                     int row_offset, int t_begin, int t_end,
                                     uint32_t lo, uint32_t hi,
                                     cudaStream_t s) {
  const long long per_block = CET_SK_THREADS * COLS;
  dim3 grid((unsigned)((c + per_block - 1) / per_block),
            (unsigned)((r + RG - 1) / RG));
#define CET_SKW_GO(SIGNS)                                                  \
  cet_sketch_window_kernel<RG, COLS, RAGGED, SIGNS>                        \
      <<<grid, CET_SK_THREADS, 0, s>>>(v, rot, sgn, table, m, c, r, seed,  \
                                       row_offset, t_begin, t_end, lo, hi)
  if constexpr (!RAGGED) {  // the stream holds 8 rows
    if (sgn) {
      CET_SKW_GO(CET_SIGNS_STREAM);
      return;
    }
  }
  if (one_mix)
    CET_SKW_GO(CET_SIGNS_ONE_MIX);
  else
    CET_SKW_GO(CET_SIGNS_ROW_MIX);
#undef CET_SKW_GO
}

// cet_sketch over the coordinates [lo, hi) of v only (0 <= lo <= hi <=
// m*c): the table of v zeroed outside the window
extern "C" int cet_sketch_window(const float* v, const int* rot,
                                 float* table, long long m, long long c,
                                 int r, unsigned int seed, int one_mix,
                                 int row_offset, const unsigned char* signs,
                                 long long lo, long long hi, void* stream) {
  if (signs && (!one_mix || row_offset < 0 || row_offset + r > 8))
    return (int)cudaErrorInvalidValue;
  if (lo < 0 || hi < lo || hi > m * c) return (int)cudaErrorInvalidValue;
  if (m > 0 && c > 0 && r > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int mi = (int)m, ci = (int)c;
    // an empty window reads no chunk: the table is zeros
    const int tb = (int)(lo / c);
    const int te = hi > lo ? (int)((hi + c - 1) / c) : tb;
#define CET_SKW_CASE(RG, COLS)                                              \
  case RG:                                                                  \
    cet_sketch_window_launch<RG, COLS, false>(v, rot, signs, table, mi, ci, \
                                              r, seed, one_mix, row_offset, \
                                              tb, te, (uint32_t)lo,         \
                                              (uint32_t)hi, s);             \
    break;
    switch (r) {
      CET_SK_GEOMETRY(CET_SKW_CASE)
      default:
        cet_sketch_window_launch<8, 2, true>(v, rot, signs, table, mi, ci, r,
                                             seed, one_mix, row_offset, tb,
                                             te, (uint32_t)lo, (uint32_t)hi,
                                             s);
    }
#undef CET_SKW_CASE
  }
  return (int)cudaGetLastError();
}

typedef void (*cet_sqr_fn)(const float*, const int*, const uint8_t*, void*,
                           float*, int, int, int, uint32_t, int);

template <int RG, int COLS, bool RAGGED, bool FP8>
static cet_sqr_fn cet_sqr_pick(bool stream, int one_mix) {
  if constexpr (!RAGGED) {  // the stream holds 8 rows
    if (stream)
      return cet_sketch_quant_rows_kernel<RG, COLS, RAGGED, CET_SIGNS_STREAM,
                                          FP8>;
  }
  if (one_mix)
    return cet_sketch_quant_rows_kernel<RG, COLS, RAGGED, CET_SIGNS_ONE_MIX,
                                        FP8>;
  return cet_sketch_quant_rows_kernel<RG, COLS, RAGGED, CET_SIGNS_ROW_MIX,
                                      FP8>;
}

// the all-rows kernel of r rows and its grid: cet_sketch's geometry
template <bool FP8>
static cet_sqr_fn cet_sqr_select(int c, int r, bool stream, int one_mix,
                                 dim3* grid) {
  int rg = 8, cols = 2;
  cet_sqr_fn kern;
#define CET_SQR_CASE(RG, COLS)                                    \
  case RG:                                                        \
    rg = RG;                                                      \
    cols = COLS;                                                  \
    kern = cet_sqr_pick<RG, COLS, false, FP8>(stream, one_mix);   \
    break;
  switch (r) {
    CET_SK_GEOMETRY(CET_SQR_CASE)
    default:  // groups of 8 rows, the last one ragged
      kern = cet_sqr_pick<8, 2, true, FP8>(stream, one_mix);
  }
#undef CET_SQR_CASE
  const int per_block = CET_SK_THREADS * cols;
  *grid = dim3((unsigned)((c + per_block - 1) / per_block),
               (unsigned)((r + rg - 1) / rg));
  return kern;
}

// the route of a shape: *kern the all-rows kernel where its grid is
// co-resident at its occupancy on this card, else null (the tile route)
static cudaError_t cet_sq_plan(int c, int r, int one_mix, bool stream,
                               int fp8, int* sms, cet_sqr_fn* kern,
                               dim3* grid) {
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const cet_sqr_fn k = fp8 ? cet_sqr_select<true>(c, r, stream, one_mix, grid)
                           : cet_sqr_select<false>(c, r, stream, one_mix, grid);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k,
                                                      CET_SK_THREADS, 0);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)grid->x * grid->y;
  *kern = blocks <= (long long)per_sm * *sms ? k : nullptr;
  return cudaSuccess;
}

// q: (r, c) int8 (fp8 == 0) or e4m3fn bytes (fp8 == 1); rowmax: (r,) f32;
// signs: the (m*c,) packed-sign bytes (one_mix, row_offset + r <= 8), or
// null to hash the signs in the kernel
extern "C" int cet_sketch_quant(const float* v, const int* rot, void* q,
                                float* rowmax, long long m, long long c,
                                int r, unsigned int seed, int one_mix,
                                int row_offset, int fp8,
                                const unsigned char* signs, void* stream) {
  if (r < 0 || r > CET_MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (signs && (!one_mix || row_offset < 0 || row_offset + r > 8))
    return (int)cudaErrorInvalidValue;
  if (m <= 0 || c <= 0 || r == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(rowmax, 0, sizeof(float) * r, s);
  if (err != cudaSuccess) return (int)err;
  int mi = (int)m, ci = (int)c, sms = 0;
  cet_sqr_fn kern = nullptr;
  dim3 grid;
  err = cet_sq_plan(ci, r, one_mix, signs != nullptr, fp8, &sms, &kern,
                    &grid);
  if (err != cudaSuccess) return (int)err;
  if (kern) {
    const uint8_t* sgn = signs;
    void* args[] = {(void*)&v,    (void*)&rot, (void*)&sgn,  (void*)&q,
                    (void*)&rowmax, (void*)&mi, (void*)&ci,  (void*)&r,
                    (void*)&seed, (void*)&row_offset};
    err = cudaLaunchCooperativeKernel((void*)kern, grid,
                                      dim3(CET_SK_THREADS), args, 0, s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const int tiles_per_row = (ci + CET_SQ_THREADS - 1) / CET_SQ_THREADS;
  const int rc =
      fp8 ? cet_sq_dispatch<true>(v, rot, q, rowmax, mi, ci, r,
                                  tiles_per_row, seed, one_mix, row_offset,
                                  sms, s)
          : cet_sq_dispatch<false>(v, rot, q, rowmax, mi, ci, r,
                                   tiles_per_row, seed, one_mix, row_offset,
                                   sms, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// *route = 1 where cet_sketch_quant takes the all-rows route for this
// shape on the current device, 0 where it takes the tile route
extern "C" int cet_sketch_quant_route(long long c, int r, int one_mix,
                                      int stream, int fp8, int* route) {
  if (c <= 0 || r <= 0 || r > CET_MAX_ROWS) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cet_sqr_fn kern = nullptr;
  dim3 grid;
  const cudaError_t err =
      cet_sq_plan((int)c, r, one_mix, stream != 0, fp8, &sms, &kern, &grid);
  *route = kern ? 1 : 0;
  return (int)err;
}

extern "C" int cet_estimates(const float* table, const int* rot,
                             float* out, long long m, long long c, int r,
                             unsigned int seed, int one_mix,
                             long long valid, void* stream) {
  if (r > CET_MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (m > 0 && c > 0 && r > 0) {
    const long long per_block = CET_ES_THREADS * CET_ES_VEC;
    dim3 grid((unsigned)((c + per_block - 1) / per_block),
              (unsigned)(m < 65535 ? m : 65535));
    cudaStream_t s = (cudaStream_t)stream;
    const int mi = (int)m, ci = (int)c;
#define CET_ES_CASE(R)                                                     \
  if (one_mix)                                                             \
    cet_estimates_kernel<R, true><<<grid, CET_ES_THREADS, 0, s>>>(         \
        table, rot, out, mi, ci, r, seed, valid);                          \
  else                                                                     \
    cet_estimates_kernel<R, false><<<grid, CET_ES_THREADS, 0, s>>>(        \
        table, rot, out, mi, ci, r, seed, valid);
    if (r == 1) {
      CET_ES_CASE(1)
    } else if (r == 3) {
      CET_ES_CASE(3)
    } else if (r == 5) {
      CET_ES_CASE(5)
    } else {
      CET_ES_CASE(0)
    }
#undef CET_ES_CASE
  }
  return (int)cudaGetLastError();
}

// cet_estimates over the coordinates [lo, hi) only (0 <= lo <= hi <=
// m*c): out holds hi - lo floats, out[i] the estimate of lo + i (0 at
// lo + i >= valid)
extern "C" int cet_estimates_window(const float* table, const int* rot,
                                    float* out, long long m, long long c,
                                    int r, unsigned int seed, int one_mix,
                                    long long valid, long long lo,
                                    long long hi, void* stream) {
  if (r > CET_MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (lo < 0 || hi < lo || hi > m * c) return (int)cudaErrorInvalidValue;
  if (m > 0 && c > 0 && r > 0 && hi > lo) {
    const int tb = (int)(lo / c);
    const int te = (int)((hi + c - 1) / c);
    const long long per_block = CET_ES_THREADS * CET_ES_VEC;
    dim3 grid((unsigned)((c + per_block - 1) / per_block),
              (unsigned)(te - tb < 65535 ? te - tb : 65535));
    cudaStream_t s = (cudaStream_t)stream;
    const int mi = (int)m, ci = (int)c;
#define CET_ESW_CASE(R)                                                    \
  if (one_mix)                                                             \
    cet_estimates_window_kernel<R, true><<<grid, CET_ES_THREADS, 0, s>>>(  \
        table, rot, out, mi, ci, r, seed, valid, (uint32_t)lo,             \
        (uint32_t)hi, tb, te);                                             \
  else                                                                     \
    cet_estimates_window_kernel<R, false><<<grid, CET_ES_THREADS, 0, s>>>( \
        table, rot, out, mi, ci, r, seed, valid, (uint32_t)lo,             \
        (uint32_t)hi, tb, te);
    if (r == 1) {
      CET_ESW_CASE(1)
    } else if (r == 3) {
      CET_ESW_CASE(3)
    } else if (r == 5) {
      CET_ESW_CASE(5)
    } else {
      CET_ESW_CASE(0)
    }
#undef CET_ESW_CASE
  }
  return (int)cudaGetLastError();
}

// n4 16-byte words of buf read `passes` times by `blocks` blocks of
// 256 threads; out holds blocks * 256 floats
extern "C" int cet_l2_read_probe(const void* buf, long long n4, int passes,
                                 float* out, int blocks, void* stream) {
  cet_l2_probe_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const float4*>(buf), n4, passes, out);
  return (int)cudaGetLastError();
}

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
// becomes a gather: thread (row, col) walks the chunks t = 0..m-1 in
// order and sums s_row(g) * v[g] with g = t*c + ((col - o[row, t]) mod
// c). No atomics, one fixed summation order (repeated runs agree bit
// for bit, and so does the plain version, which adds in the same
// order). Any rotation works, so quantized rotations (rot_lanes) need
// no special path, and any c works (no 128-lane constraint). Signs are
// hashed in-kernel: uint32 multiplies are native here, so the TPU's
// packed-sign stream would only add a byte per element of traffic.
// Bound: bytes. The least traffic is one read of v (4*m*c bytes) and one
// write of the table (4*r*c); this kernel reads v once per row, the
// rows of one chunk close together in time so that L2 (50 MB, which
// holds the 27 MB ResNet9 vector) serves the repeats.
//
// --- cet_estimates -- replaces estimates_pallas (commefficient_tpu/
// ops/sketch_pallas.py:414-485). One thread per output coordinate g:
// it reads the r table entries its hashes name, flips their sign bits
// and takes the median by the same network as _median_network
// (sketch_pallas.py:165-191): exact for odd r, the mean of the two
// middles for even r. The (r, m*c) intermediate never exists. Entries
// at g >= valid are written as 0. Bound: bytes, one read of the table
// (4*r*c, L2-resident at 10.5 MB) and one write of the estimates
// (4*m*c).
//
// --- cet_sketch_quant -- replaces sketch_quant_pallas (commefficient_
// tpu/ops/sketch_pallas.py:293-411), the fused emit + quantize of the
// --sketch_dtype int8|fp8 wire: the table of r rows (a row chunk under
// --overlap_depth, signs keyed by the absolute row row_offset + row),
// then per row rm = max|row|, s = rm > 0 ? rm/qmax : 1, and
// q = clip(rint(x/s), -127, 127) (int8) or e4m3fn(f16(x/s)) (fp8); out
// come q (r, c) and rowmax (r, 1) f32. The TPU kernel keeps the f32
// table in a VMEM scratch across its sequential grid. Here:
//   1. gather: each thread sums its buckets exactly as cet_sketch does
//      (cet_bucket, t = 0..m-1 in order, no atomics), so the table is
//      bit-equal to kernel 1's, and keeps up to K of them in registers;
//   2. row max: a warp max of the |x| bits (non-negative floats order
//      as uint32, and NaN's bits lie above inf's, so NaN propagates as
//      in jnp.max, where fmaxf would drop it), a shared-memory atomicMax
//      per warp, one global atomicMax per row and block into the
//      rowmax output, which the entry point zeroes first;
//   3. grid barrier: a cooperative launch (cudaLaunchCooperativeKernel)
//      with the grid sized by occupancy, then cg::this_grid().sync();
//   4. quantize from registers and write q.
// The f32 table never reaches device memory. K (8, 16 or 32 tiles of
// 256 buckets a thread) is the smallest whose grid is co-resident; a
// table larger than 32 tiles a resident thread (r*c above ~4M at the
// occupancy of 256-thread blocks) recomputes the tiles past the 32nd
// in step 4 from the same sums, in the same order, so it stays one
// launch with no scratch buffer. Bound: bytes, one read of v (4*m*c),
// of the rotations (4*r*m), one write of q (r*c) and rowmax (4*r).
// Rounding matches ops/quant.py byte for byte: x/s and rm/qmax are IEEE
// divisions (the build has no --use_fast_math, -prec-div=false or
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

__global__ void cet_sketch_kernel(const float* __restrict__ v,
                                  const int* __restrict__ rot,
                                  float* __restrict__ table, int m, int c,
                                  uint32_t seed, int one_mix,
                                  int row_offset) {
  const int row = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= c) return;
  table[(size_t)row * c + col] =
      cet_bucket(v, rot + (size_t)row * m, m, c, col, row_offset + row,
                 seed, one_mix);
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

// R > 0: row count known at compile time (registers); R == 0: any
// r <= CET_MAX_ROWS read at run time
template <int R>
__global__ void cet_estimates_kernel(const float* __restrict__ table,
                                     const int* __restrict__ rot,
                                     float* __restrict__ out, int m, int c,
                                     int r_rt, uint32_t seed, int one_mix,
                                     long long valid) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long padded = (long long)m * c;
  if (g >= padded) return;
  if (g >= valid) {
    out[g] = 0.f;
    return;
  }
  const int r = R > 0 ? R : r_rt;
  const int t = (int)(g / c);
  const int j = (int)(g - (long long)t * c);
  float vals[R > 0 ? R : CET_MAX_ROWS];
#pragma unroll
  for (int row = 0; row < (R > 0 ? R : CET_MAX_ROWS); ++row) {
    if (row >= r) break;
    int col = j + __ldg(rot + (size_t)row * m + t);
    if (col >= c) col -= c;
    vals[row] = cet_apply_flip(
        __ldg(table + (size_t)row * c + col),
        cet_sign_flip((uint32_t)g, row, seed, one_mix));
  }
  out[g] = cet_median<R>(vals, r);
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

// tile = 256 consecutive buckets of one row; block b takes tiles
// b, b + grid, b + 2*grid, ...: the first K in registers
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

extern "C" int cet_sketch(const float* v, const int* rot, float* table,
                          long long m, long long c, int r,
                          unsigned int seed, int one_mix, int row_offset,
                          void* stream) {
  if (m > 0 && c > 0 && r > 0) {
    const int threads = 256;
    dim3 grid((unsigned)((c + threads - 1) / threads), (unsigned)r);
    cet_sketch_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        v, rot, table, (int)m, (int)c, seed, one_mix, row_offset);
  }
  return (int)cudaGetLastError();
}

// q: (r, c) int8 (fp8 == 0) or e4m3fn bytes (fp8 == 1); rowmax: (r,) f32
extern "C" int cet_sketch_quant(const float* v, const int* rot, void* q,
                                float* rowmax, long long m, long long c,
                                int r, unsigned int seed, int one_mix,
                                int row_offset, int fp8, void* stream) {
  if (r < 0 || r > CET_MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (m <= 0 || c <= 0 || r == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(rowmax, 0, sizeof(float) * r, s);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles_per_row = (int)((c + CET_SQ_THREADS - 1) / CET_SQ_THREADS);
  const int rc =
      fp8 ? cet_sq_dispatch<true>(v, rot, q, rowmax, (int)m, (int)c, r,
                                  tiles_per_row, seed, one_mix, row_offset,
                                  sms, s)
          : cet_sq_dispatch<false>(v, rot, q, rowmax, (int)m, (int)c, r,
                                   tiles_per_row, seed, one_mix, row_offset,
                                   sms, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" int cet_estimates(const float* table, const int* rot,
                             float* out, long long m, long long c, int r,
                             unsigned int seed, int one_mix,
                             long long valid, void* stream) {
  if (r > CET_MAX_ROWS) return (int)cudaErrorInvalidValue;
  const long long padded = m * c;
  if (padded > 0 && r > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((padded + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    switch (r) {
      case 1:
        cet_estimates_kernel<1><<<blocks, threads, 0, s>>>(
            table, rot, out, (int)m, (int)c, r, seed, one_mix, valid);
        break;
      case 3:
        cet_estimates_kernel<3><<<blocks, threads, 0, s>>>(
            table, rot, out, (int)m, (int)c, r, seed, one_mix, valid);
        break;
      case 5:
        cet_estimates_kernel<5><<<blocks, threads, 0, s>>>(
            table, rot, out, (int)m, (int)c, r, seed, one_mix, valid);
        break;
      default:
        cet_estimates_kernel<0><<<blocks, threads, 0, s>>>(
            table, rot, out, (int)m, (int)c, r, seed, one_mix, valid);
    }
  }
  return (int)cudaGetLastError();
}

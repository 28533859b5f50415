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

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

#define CET_MAX_ROWS 32

__global__ void cet_sketch_kernel(const float* __restrict__ v,
                                  const int* __restrict__ rot,
                                  float* __restrict__ table, int m, int c,
                                  uint32_t seed, int one_mix) {
  const int row = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= c) return;
  const int* orow = rot + (size_t)row * m;
  float acc = 0.f;
  for (int t = 0; t < m; ++t) {
    int j = col - __ldg(orow + t);
    if (j < 0) j += c;
    const uint32_t g = (uint32_t)t * (uint32_t)c + (uint32_t)j;
    acc += cet_apply_flip(__ldg(v + g),
                          cet_sign_flip(g, row, seed, one_mix));
  }
  table[(size_t)row * c + col] = acc;
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

extern "C" int cet_sketch(const float* v, const int* rot, float* table,
                          long long m, long long c, int r,
                          unsigned int seed, int one_mix, void* stream) {
  if (m > 0 && c > 0 && r > 0) {
    const int threads = 256;
    dim3 grid((unsigned)((c + threads - 1) / threads), (unsigned)r);
    cet_sketch_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        v, rot, table, (int)m, (int)c, seed, one_mix);
  }
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

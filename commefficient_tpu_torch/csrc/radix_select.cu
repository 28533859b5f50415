// k-th largest key by radix select, for Hopper (sm_90a) -- replaces the
// plain-torch nibble search that stands for _nibble_threshold_key
// (commefficient_tpu/ops/topk.py:106-152) together with threshold_topk_
// mask_1d's need = k - #(keys > T) (:219). In the reference both are XLA
// code, not a Pallas kernel; they feed take_mask_pallas (kernel 3,
// csrc/take_mask.cu), which reads T and need from device memory here.
//
// Keys are the uint32 bit patterns of the f32 values sq (non-negative:
// squared estimates), compared as bits, never as floats, as the
// reference does: +inf and NaN patterns are ordered by their bits.
// Output: state[0] = T, the k-th largest key; state[1] = need =
// k - #(keys > T); state[2] = #(keys == T), the count of the last digit
// step's bin, which lets the take-mask skip its tie scan where need
// takes every tie. All stay on the device.
//
// Four passes of 8-bit digits, most significant first. Each pass is two
// launches, so that the 2-D mesh's sharded form (cet_rs_pass_hist and
// cet_rs_pass_digit below, with an all-reduce of the 256 counts between
// them) takes the same steps:
//   cet_rs_hist<P>: the histogram of digit P among the keys whose higher
//     digits equal the prefix found so far; the others are skipped. A
//     grid of a few blocks an SM walks the keys with 16-byte loads.
//     Squared estimates put nearly every key of pass 0 into a few bins
//     (their exponents), so each lane of a warp counts into its own
//     shared sub-histogram (32 copies at a stride of 257 words): lanes
//     with the same digit never meet on one address or one bank. A
//     block adds its nonzero bins to the global 256 counts, one atomic
//     each.
//   cet_rs_digit<P>: one block forms the suffix counts, takes the
//     largest digit b with suffix(b) >= remaining (0 if none, as the
//     reference), sets prefix |= b << shift and remaining -=
//     suffix(b + 1), and zeroes the counts for the next pass.
// After pass 3, remaining *is* need: the subtracted suffixes add up to
// #(keys > T). The k-th largest key does not depend on the digit width,
// so T is the nibble search's bit for bit (for k outside [1, d] too:
// both walks then take all-low or all-high digits).
//
// Bound: bytes, one read of the keys, 4*d (0.149 ms at d = 124 780 544,
// 3.35 TB/s). Design floor: four reads, 16*d (0.596 ms there). At
// ResNet9's d (26 MB) passes 1-3 read the keys from the 50 MB L2.
// Counts are 32-bit (d < 2^31, checked by the wrapper); offsets 64-bit.
// The kernels allocate nothing; the wrapper passes the state and the
// counts.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#define CET_RS_THREADS 256
#define CET_RS_BINS 256
#define CET_RS_COPIES 32
#define CET_RS_STRIDE (CET_RS_BINS + 1)
#define CET_RS_UNROLL 4

// count one key into this lane's sub-histogram h if its digits above
// pass P equal `want`
template <int P>
__device__ __forceinline__ void cet_rs_count(uint32_t key, uint32_t want,
                                             unsigned* h) {
  if constexpr (P > 0) {
    if ((key >> (32 - 8 * P)) != want) return;
  }
  atomicAdd(h + ((key >> (24 - 8 * P)) & (CET_RS_BINS - 1)), 1u);
}

template <int P>
__device__ __forceinline__ void cet_rs_count4(uint4 v, uint32_t want,
                                              unsigned* h) {
  cet_rs_count<P>(v.x, want, h);
  cet_rs_count<P>(v.y, want, h);
  cet_rs_count<P>(v.z, want, h);
  cet_rs_count<P>(v.w, want, h);
}

template <int P>
__global__ void __launch_bounds__(CET_RS_THREADS)
    cet_rs_hist(const uint32_t* __restrict__ keys, long long d,
                const long long* __restrict__ state,
                unsigned* __restrict__ hist) {
  __shared__ unsigned sh[CET_RS_COPIES * CET_RS_STRIDE];
  for (int i = threadIdx.x; i < CET_RS_COPIES * CET_RS_STRIDE;
       i += CET_RS_THREADS)
    sh[i] = 0;
  uint32_t want = 0;
  if constexpr (P > 0)
    want = (uint32_t)(unsigned long long)state[0] >> (32 - 8 * P);
  __syncthreads();
  unsigned* h = sh + (threadIdx.x & 31) * CET_RS_STRIDE;

  // keys before the first 16-byte boundary and after the last one go
  // one a thread to the grid's first threads; the body as uint4
  const long long head =
      min(d, (long long)(((16 - ((uintptr_t)keys & 15)) & 15) >> 2));
  const long long n4 = (d - head) >> 2;
  const long long tail = head + 4 * n4;
  const long long tid = (long long)blockIdx.x * CET_RS_THREADS + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * CET_RS_THREADS;
  if (tid < head) cet_rs_count<P>(__ldg(keys + tid), want, h);
  if (tid < d - tail) cet_rs_count<P>(__ldg(keys + tail + tid), want, h);
  const uint4* body = reinterpret_cast<const uint4*>(keys + head);
  long long i = tid;
  for (; i + (CET_RS_UNROLL - 1) * nthreads < n4;
       i += CET_RS_UNROLL * nthreads) {
    uint4 v[CET_RS_UNROLL];
#pragma unroll
    for (int u = 0; u < CET_RS_UNROLL; ++u)
      v[u] = __ldg(body + i + u * nthreads);
#pragma unroll
    for (int u = 0; u < CET_RS_UNROLL; ++u) cet_rs_count4<P>(v[u], want, h);
  }
  for (; i < n4; i += nthreads) cet_rs_count4<P>(__ldg(body + i), want, h);
  __syncthreads();

  for (int b = threadIdx.x; b < CET_RS_BINS; b += CET_RS_THREADS) {
    unsigned s = 0;
#pragma unroll 8
    for (int c = 0; c < CET_RS_COPIES; ++c) s += sh[c * CET_RS_STRIDE + b];
    if (s) atomicAdd(hist + b, s);
  }
}

template <int P>
__global__ void __launch_bounds__(CET_RS_BINS)
    cet_rs_digit(unsigned* __restrict__ hist, long long* __restrict__ state,
                 long long k) {
  __shared__ long long suf[CET_RS_BINS + 1];  // suf[b] = #(digit >= b)
  const int b = threadIdx.x;
  suf[b] = hist[b];
  hist[b] = 0;  // zeroed for the next pass
  if (b == 0) suf[CET_RS_BINS] = 0;
  const long long remaining = P == 0 ? k : state[1];
  __syncthreads();
  for (int off = 1; off < CET_RS_BINS; off <<= 1) {
    const long long add = b + off < CET_RS_BINS ? suf[b + off] : 0;
    __syncthreads();
    suf[b] += add;
    __syncthreads();
  }
  // suf is non-increasing in b: the digits with suf >= remaining are
  // 0 .. n_ge - 1
  const int n_ge = __syncthreads_count(suf[b] >= remaining);
  if (b == 0) {
    const int digit = n_ge > 0 ? n_ge - 1 : 0;
    const long long prefix = P == 0 ? 0 : state[0];
    state[0] = prefix | ((long long)digit << (24 - 8 * P));
    state[1] = remaining - suf[digit + 1];
    if (P == 3) state[2] = suf[digit] - suf[digit + 1];
  }
}

template <int P>
static void cet_rs_pass(const uint32_t* keys, long long d, long long k,
                        long long* state, unsigned* hist, unsigned grid,
                        cudaStream_t s) {
  cet_rs_hist<P><<<grid, CET_RS_THREADS, 0, s>>>(keys, d, state, hist);
  cet_rs_digit<P><<<1, CET_RS_BINS, 0, s>>>(hist, state, k);
}

// blocks of cet_rs_hist that fill device dev: its SMs times the blocks
// one SM holds. Asked of the runtime once a device and kept, so that a
// call launches with no query (0 = not asked yet).
#define CET_RS_MAX_DEVICES 64
static std::atomic<long long> cet_rs_caps[CET_RS_MAX_DEVICES];

static cudaError_t cet_rs_grid_cap(long long* cap) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < CET_RS_MAX_DEVICES) {
    *cap = cet_rs_caps[dev].load(std::memory_order_relaxed);
    if (*cap > 0) return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cet_rs_hist<0>, CET_RS_THREADS, 0);
  if (err != cudaSuccess) return err;
  *cap = (long long)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  if (dev >= 0 && dev < CET_RS_MAX_DEVICES)
    cet_rs_caps[dev].store(*cap, std::memory_order_relaxed);
  return cudaSuccess;
}

static unsigned cet_rs_grid(long long d, long long cap) {
  const long long want = (d / 4 + CET_RS_THREADS - 1) / CET_RS_THREADS;
  return (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
}

// One pass of the search in two entry points, for a key vector cut into
// shards (the 2-D mesh's model peers): each peer histograms its shard
// (cet_rs_pass_hist: keys [0, n) only, so a tail shard's padding past
// n stays out of the population), the 256 counts are summed over the
// peers between the two launches, and each peer takes the same digit
// from the global counts (cet_rs_pass_digit), so every peer ends with
// the global T, need and tie count. hist must hold zeros before pass
// 0's histogram (cet_rs_zero); the digit step zeroes it again. One
// shard holding every key is cet_threshold_key, launch for launch.
extern "C" int cet_rs_zero(unsigned* hist, void* stream) {
  return (int)cudaMemsetAsync(hist, 0, sizeof(unsigned) * CET_RS_BINS,
                              (cudaStream_t)stream);
}

extern "C" int cet_rs_pass_hist(int pass, const float* sq, long long n,
                                const long long* state, unsigned* hist,
                                void* stream) {
  if (n < 0 || pass < 0 || pass > 3) return (int)cudaErrorInvalidValue;
  long long cap = 0;
  cudaError_t err = cet_rs_grid_cap(&cap);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = cet_rs_grid(n, cap);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* keys = reinterpret_cast<const uint32_t*>(sq);
  switch (pass) {
    case 0:
      cet_rs_hist<0><<<grid, CET_RS_THREADS, 0, s>>>(keys, n, state, hist);
      break;
    case 1:
      cet_rs_hist<1><<<grid, CET_RS_THREADS, 0, s>>>(keys, n, state, hist);
      break;
    case 2:
      cet_rs_hist<2><<<grid, CET_RS_THREADS, 0, s>>>(keys, n, state, hist);
      break;
    default:
      cet_rs_hist<3><<<grid, CET_RS_THREADS, 0, s>>>(keys, n, state, hist);
  }
  return (int)cudaGetLastError();
}

extern "C" int cet_rs_pass_digit(int pass, unsigned* hist, long long* state,
                                 long long k, void* stream) {
  if (pass < 0 || pass > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pass) {
    case 0:
      cet_rs_digit<0><<<1, CET_RS_BINS, 0, s>>>(hist, state, k);
      break;
    case 1:
      cet_rs_digit<1><<<1, CET_RS_BINS, 0, s>>>(hist, state, k);
      break;
    case 2:
      cet_rs_digit<2><<<1, CET_RS_BINS, 0, s>>>(hist, state, k);
      break;
    default:
      cet_rs_digit<3><<<1, CET_RS_BINS, 0, s>>>(hist, state, k);
  }
  return (int)cudaGetLastError();
}

// sq: (d,) f32 keys; state: 3 int64 (T, need, ties) written; hist: 256
// uint32 counts, any contents (zeroed here)
extern "C" int cet_threshold_key(const float* sq, long long d, long long k,
                                 long long* state, unsigned* hist,
                                 void* stream) {
  if (d < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long cap = 0;
  cudaError_t err = cet_rs_grid_cap(&cap);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(hist, 0, sizeof(unsigned) * CET_RS_BINS, s);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = cet_rs_grid(d, cap);
  const uint32_t* keys = reinterpret_cast<const uint32_t*>(sq);
  cet_rs_pass<0>(keys, d, k, state, hist, grid, s);
  cet_rs_pass<1>(keys, d, k, state, hist, grid, s);
  cet_rs_pass<2>(keys, d, k, state, hist, grid, s);
  cet_rs_pass<3>(keys, d, k, state, hist, grid, s);
  return (int)cudaGetLastError();
}

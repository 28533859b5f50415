// Exact-k take mask for Hopper (sm_90a) -- replaces take_mask_pallas
// (commefficient_tpu/ops/topk_pallas.py:45-115).
//
// Given the non-negative f32 keys sq (squared estimates), the bit
// pattern T of the k-th largest key and need = k - #(keys > T), the mask
// holds every key > T plus the first `need` keys == T in index order
// (the lowest index wins ties, as lax.top_k's selection does).
//
// The TPU kernel walks the vector in a sequential grid and carries the
// running tie count in SMEM. Hopper blocks run in no order, so the
// carry becomes three launches:
//   1. cet_eq_count: each block counts its keys == T;
//   2. cet_eq_scan: one block turns the block counts into exclusive
//      offsets (a few thousand entries);
//   3. cet_take_write: each block ranks its ties by warp ballots in
//      index order, adds its offset, and writes the mask.
// need <= 0 takes no tie; T == 0 is safe because there is no padding
// (the ragged last block is bounds-checked); d need not be a multiple
// of the block. Bound: bytes, one read of the keys (4*d) and one write
// of the mask (d). This first version reads the keys twice (passes 1
// and 3); the second read mostly hits L2 at the ResNet9 size (26 MB).

#include <cuda_runtime.h>
#include <stdint.h>

#define CET_TM_THREADS 256
#define CET_TM_ITEMS 8
#define CET_TM_TILE (CET_TM_THREADS * CET_TM_ITEMS)
#define CET_SCAN_THREADS 1024

__device__ __forceinline__ uint32_t cet_key(const float* sq, long long i) {
  return __float_as_uint(__ldg(sq + i));
}

__global__ void cet_eq_count(const float* __restrict__ sq, long long d,
                             const long long* __restrict__ tkey,
                             long long* __restrict__ counts) {
  __shared__ int warp_tot[CET_TM_THREADS / 32];
  const uint32_t T = (uint32_t)(*tkey);
  const long long base = (long long)blockIdx.x * CET_TM_TILE;
  int n = 0;
#pragma unroll
  for (int k = 0; k < CET_TM_ITEMS; ++k) {
    const long long i = base + (long long)k * CET_TM_THREADS + threadIdx.x;
    n += (i < d && cet_key(sq, i) == T) ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    n += __shfl_down_sync(0xffffffffu, n, off);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long tot = 0;
    for (int w = 0; w < CET_TM_THREADS / 32; ++w) tot += warp_tot[w];
    counts[blockIdx.x] = tot;
  }
}

// in place: counts[b] -> sum of counts[0..b)
__global__ void cet_eq_scan(long long* __restrict__ counts, long long nb) {
  __shared__ long long part[CET_SCAN_THREADS];
  const long long per = (nb + CET_SCAN_THREADS - 1) / CET_SCAN_THREADS;
  const long long lo = threadIdx.x * per;
  const long long hi = lo + per < nb ? lo + per : nb;
  long long s = 0;
  for (long long b = lo; b < hi; ++b) s += counts[b];
  part[threadIdx.x] = s;
  __syncthreads();
  // inclusive Hillis-Steele scan of the per-thread sums
  for (int off = 1; off < CET_SCAN_THREADS; off <<= 1) {
    const long long add =
        threadIdx.x >= (unsigned)off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += add;
    __syncthreads();
  }
  long long run = part[threadIdx.x] - s;  // exclusive
  for (long long b = lo; b < hi; ++b) {
    const long long cnt = counts[b];
    counts[b] = run;
    run += cnt;
  }
}

__global__ void cet_take_write(const float* __restrict__ sq, long long d,
                               const long long* __restrict__ tkey,
                               const long long* __restrict__ need_p,
                               const long long* __restrict__ offsets,
                               unsigned char* __restrict__ out) {
  __shared__ int warp_tot[CET_TM_THREADS / 32];
  const uint32_t T = (uint32_t)(*tkey);
  const long long need = *need_p;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * CET_TM_TILE;
  long long running = offsets[blockIdx.x];  // ties before this pass
  for (int k = 0; k < CET_TM_ITEMS; ++k) {
    const long long i = base + (long long)k * CET_TM_THREADS + threadIdx.x;
    const bool valid = i < d;
    const uint32_t key = valid ? cet_key(sq, i) : 0u;
    const bool eq = valid && key == T;
    const bool gt = valid && key > T;
    const unsigned ballot = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) warp_tot[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < CET_TM_THREADS / 32; ++w) {
      const int cnt = warp_tot[w];
      before += w < warp ? cnt : 0;
      total += cnt;
    }
    // 1-based rank of this tie among all ties in index order
    const long long rank = running + before + __popc(ballot & lt_mask) + 1;
    if (valid) out[i] = (gt || (eq && rank <= need)) ? 1 : 0;
    running += total;
    __syncthreads();
  }
}

extern "C" int cet_take_mask(const float* sq, long long d,
                             const long long* tkey, const long long* need,
                             long long* scratch, unsigned char* out,
                             void* stream) {
  if (d > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const long long nb = (d + CET_TM_TILE - 1) / CET_TM_TILE;
    cet_eq_count<<<(unsigned)nb, CET_TM_THREADS, 0, s>>>(sq, d, tkey,
                                                         scratch);
    cet_eq_scan<<<1, CET_SCAN_THREADS, 0, s>>>(scratch, nb);
    cet_take_write<<<(unsigned)nb, CET_TM_THREADS, 0, s>>>(
        sq, d, tkey, need, scratch, out);
  }
  return (int)cudaGetLastError();
}

extern "C" long long cet_take_mask_scratch(long long d) {
  return (d + CET_TM_TILE - 1) / CET_TM_TILE;
}

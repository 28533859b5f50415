// Exact-k take mask for Hopper (sm_90a) -- replaces take_mask_pallas
// (commefficient_tpu/ops/topk_pallas.py:45-115).
//
// Given the non-negative f32 keys sq (squared estimates), the bit
// pattern T of the k-th largest key and need = k - #(keys > T), the mask
// holds every key > T plus the first `need` keys == T in index order
// (the lowest index wins ties, as lax.top_k's selection does). Keys are
// compared as uint32 bit patterns, never as floats, so +inf and NaN
// order by their bits; need <= 0 takes no tie; T and need are read from
// device memory (the radix select, csrc/radix_select.cu, leaves them
// there), so the selection makes no host sync.
//
// The TPU kernel walks the vector in a sequential grid and carries the
// running tie count in SMEM. Hopper blocks run in no order, so the
// carry becomes a single-pass prefix scan of the tie counts with a
// decoupled look-back (Merrill and Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", NVIDIA, 2016):
//   1. a block claims the next tile of CET_TM_TILE keys from an atomic
//      counter (not blockIdx), so it waits only on tiles claimed by
//      blocks that already run: the wait cannot deadlock;
//   2. it loads its whole tile at once, CET_TM_VEC 16-byte loads in
//      flight a thread, into registers, and counts its keys == T;
//   3. it publishes that aggregate at once, then warp 0 looks back over
//      its predecessors' status words, 32 a round trip, summing
//      aggregates until it meets an inclusive prefix, and publishes its
//      own inclusive prefix (every tile does, so a look-back stays
//      short);
//   4. with E ties before the tile and A in it, the tile takes all its
//      ties (E + A <= need), none (E >= need), or, in the one tile that
//      straddles need, ranks them in index order by block scans of the
//      per-thread counts; it writes the mask from registers, 4 bytes a
//      store.
// A status word is 64 bits: the state in bits 62-63 (0 not ready, 1
// aggregate, 2 inclusive prefix), the count below; one aligned 64-bit
// store carries both, so a reader needs no fence. The counter and the
// status words live in the caller's scratch (1 + #tiles int64) and are
// zeroed by one cudaMemsetAsync before the launch: one memset and one
// launch a call, at any d.
//   All or none: where need <= 0, or where the caller passes the count
// of keys == T (the radix select's last digit step has it) and need >=
// that count, every tie is taken or none is, and no tile needs the
// ties before it: the blocks then take tile blockIdx.x, skip the count
// and the look-back, and write key > T (or key >= T) as one streaming
// pass. That is the main path: the squared estimates are medians of
// continuous values, so #(keys == T) is almost always 1 = need. A tile
// that waits on its look-back holds its SM slot for a few L2 round
// trips: at GPT-2's 30 464 tiles the scan took 0.45 ms against 0.27
// without it (H100 80GB HBM3 at 700 W, python -m
// commefficient_tpu_torch.kernel_ab).
//   On the 2-D mesh each model peer calls it on its shard's valid keys
// with its local need, need less the ties on lower-ranked shards (an
// all-gather of the shards' tie counts, ops/topk.py), and its own tie
// count, so the all-or-none shortcut holds on every shard but the one
// where the global need falls.
//   Bound: bytes, one read of the keys (4*d) and one write of the mask
// (d): 0.186 ms at d = 124 780 544 on 3.35 TB/s. Design floor: the
// same one read and one write (plus, on the scan's path, 16 bytes of
// status a tile: 0.08% at CET_TM_TILE = 4096).
//   Registers: a thread holds its 16 keys through the look-back; at 4
// blocks an SM (__launch_bounds__, 64 registers) 8 loads a thread
// spilled, 4 do not.
//   Geometry: a grid of ceil(d / CET_TM_TILE) blocks; a ragged last tile
// is bounds-checked per key (T == 0 is safe: no padding is read), and
// where sq is not 16-byte aligned (a view a few keys into a tensor) the
// kernel instantiated with ALIGNED = false loads the same groups of 4
// keys one at a time. The mask `out` comes from the caller's allocator,
// so its 4-byte stores are aligned.

#include <cuda_runtime.h>
#include <stdint.h>

#define CET_TM_THREADS 256
#define CET_TM_VEC 4
#define CET_TM_TILE (CET_TM_THREADS * CET_TM_VEC * 4)
#define CET_TM_AGGREGATE (1ull << 62)
#define CET_TM_PREFIX (2ull << 62)
#define CET_TM_COUNT ((1ull << 62) - 1)
#define CET_TM_FULL 0xffffffffu

__device__ __forceinline__ void cet_tm_publish(unsigned long long* p,
                                               unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long cet_tm_read(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(w)
               : "l"(p)
               : "memory");
  return w;
}

// exclusive block scan of one count a thread, and the block's total
// (uniform control flow)
__device__ __forceinline__ int cet_tm_exclusive_scan(int x, int* warp_sum,
                                                     int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(CET_TM_FULL, inc, off);
    if (lane >= off) inc += y;
  }
  __syncthreads();  // warp_sum free from its last use
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < CET_TM_THREADS / 32; ++w) {
    before += w < warp ? warp_sum[w] : 0;
    all += warp_sum[w];
  }
  *total = all;
  return before + inc - x;
}

// the exclusive prefix of tile `tile` (warp 0, all lanes): publish its
// aggregate, sum the predecessors' counts back to the nearest inclusive
// prefix, publish its own; lane l reads the status of tile
// pred - l, 32 predecessors a round trip
__device__ __forceinline__ long long cet_tm_look_back(
    unsigned long long* status, long long tile, long long agg, int lane) {
  if (tile == 0) {
    if (lane == 0) cet_tm_publish(status, CET_TM_PREFIX | agg);
    return 0;
  }
  if (lane == 0) cet_tm_publish(status + tile, CET_TM_AGGREGATE | agg);
  long long before = 0;
  for (long long pred = tile - 1;; pred -= 32) {
    const long long idx = pred - lane;
    unsigned long long w = CET_TM_PREFIX;  // before tile 0: prefix 0
    if (idx >= 0) {
      do {
        w = cet_tm_read(status + idx);
      } while ((w >> 62) == 0);
    }
    const unsigned prefix = __ballot_sync(CET_TM_FULL, (w >> 62) == 2);
    // the nearest predecessor with a prefix ends the sum
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    long long x = lane <= stop ? (long long)(w & CET_TM_COUNT) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(CET_TM_FULL, x, off);
    before += x;
    if (prefix) break;
  }
  if (lane == 0) cet_tm_publish(status + tile, CET_TM_PREFIX | (before + agg));
  return before;
}

template <bool ALIGNED>
__global__ void __launch_bounds__(CET_TM_THREADS, 4)
    cet_take_mask_kernel(const float* __restrict__ sq, long long d,
                         const long long* __restrict__ tkey,
                         const long long* __restrict__ need_p,
                         const long long* __restrict__ ties_p,
                         unsigned long long* __restrict__ scratch,
                         unsigned char* __restrict__ out) {
  __shared__ long long s_tile, s_before;
  __shared__ int warp_sum[CET_TM_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t T = (uint32_t)__ldg(tkey);
  const long long need = __ldg(need_p);
  // every tie taken or none: no tile needs the ties before it
  const bool all_or_none = need <= 0 || (ties_p && need >= __ldg(ties_p));
  if (!all_or_none && threadIdx.x == 0)
    s_tile = (long long)atomicAdd(scratch, 1ull);
  __syncthreads();
  const long long tile = all_or_none ? (long long)blockIdx.x : s_tile;
  const long long base = tile * CET_TM_TILE;
  // keys of this tile, and tile-relative 32-bit offsets from here on
  const int n = (int)min((long long)CET_TM_TILE, d - base);
  const float* tq = sq + base;
  unsigned char* tout = out + base;

  // group j of this thread: keys i0 .. i0 + 3, i0 = 4*(j*256 + t)
  uint32_t key[CET_TM_VEC][4];
#pragma unroll
  for (int j = 0; j < CET_TM_VEC; ++j) {
    const int i0 = 4 * (j * CET_TM_THREADS + threadIdx.x);
    if (ALIGNED && i0 + 4 <= n) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(tq + i0));
      key[j][0] = w.x;
      key[j][1] = w.y;
      key[j][2] = w.z;
      key[j][3] = w.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        key[j][e] = i0 + e < n ? __float_as_uint(__ldg(tq + i0 + e)) : 0u;
    }
  }

  // this tile takes its first `take` ties (all: take >= agg; none:
  // take <= 0)
  long long take = need, agg = 0;
  if (!all_or_none) {  // uniform over the grid
    int mine = 0;  // ties (keys past d are not keys)
#pragma unroll
    for (int j = 0; j < CET_TM_VEC; ++j) {
      const int i0 = 4 * (j * CET_TM_THREADS + threadIdx.x);
#pragma unroll
      for (int e = 0; e < 4; ++e) mine += (i0 + e < n && key[j][e] == T);
    }
    const int wsum = __reduce_add_sync(CET_TM_FULL, mine);
    if (lane == 0) warp_sum[warp] = wsum;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < CET_TM_THREADS / 32; ++w) agg += warp_sum[w];
    if (warp == 0) {
      const long long before = cet_tm_look_back(scratch + 1, tile, agg, lane);
      if (lane == 0) s_before = before;
    }
    __syncthreads();
    take = need - s_before;
  }
  const bool ranked = take > 0 && take < agg;  // uniform over the block
  int rank = 0;  // ties of the tile in the groups before this one
#pragma unroll
  for (int j = 0; j < CET_TM_VEC; ++j) {
    const int i0 = 4 * (j * CET_TM_THREADS + threadIdx.x);
    uint32_t bytes = 0;
    if (!ranked) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        bytes |= (uint32_t)(key[j][e] > T || (key[j][e] == T && take > 0))
                 << (8 * e);
    } else {
      int ties = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) ties += (i0 + e < n && key[j][e] == T);
      int group_ties;
      int r = rank + cet_tm_exclusive_scan(ties, warp_sum, &group_ties);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool eq = i0 + e < n && key[j][e] == T;
        bytes |= (uint32_t)(key[j][e] > T || (eq && r < take)) << (8 * e);
        r += eq;
      }
      rank += group_ties;
    }
    if (i0 + 4 <= n) {
      *reinterpret_cast<uint32_t*>(tout + i0) = bytes;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i0 + e < n) tout[i0 + e] = (unsigned char)(bytes >> (8 * e));
    }
  }
}

// ties: #(keys == T) as one int64 on the device, or null where the
// caller does not have it
extern "C" int cet_take_mask(const float* sq, long long d,
                             const long long* tkey, const long long* need,
                             const long long* ties, long long* scratch,
                             unsigned char* out, void* stream) {
  if (d > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const long long tiles = (d + CET_TM_TILE - 1) / CET_TM_TILE;
    const cudaError_t err = cudaMemsetAsync(
        scratch, 0, sizeof(long long) * (size_t)(tiles + 1), s);
    if (err != cudaSuccess) return (int)err;
    unsigned long long* st = reinterpret_cast<unsigned long long*>(scratch);
    if (((uintptr_t)sq & 15) == 0)
      cet_take_mask_kernel<true><<<(unsigned)tiles, CET_TM_THREADS, 0, s>>>(
          sq, d, tkey, need, ties, st, out);
    else
      cet_take_mask_kernel<false><<<(unsigned)tiles, CET_TM_THREADS, 0, s>>>(
          sq, d, tkey, need, ties, st, out);
  }
  return (int)cudaGetLastError();
}

// int64 words of scratch: the tile counter and one status word a tile
extern "C" long long cet_take_mask_scratch(long long d) {
  return 1 + (d + CET_TM_TILE - 1) / CET_TM_TILE;
}

// Fused tied-head cross-entropy (fused-linear-CE) for Hopper (sm_90a).
//
// Replaces the Pallas kernels of commefficient_tpu/ops/flce_pallas.py:
//   cet_flce_fwd  <- _fwd_kernel via _flce_fwd_impl / flce_lse_tok (:87, :189)
//   cet_flce_bwd  <- _bwd_kernel via _flce_vjp_bwd (:128, :244)
//
// For x (M, C) bf16 hidden states, the tied embedding W (V, C) bf16 and
// int32 labels (M,), the forward returns per token
//   lse[m] = logsumexp_v(x[m] . W[v]),   tok[m] = x[m] . W[labels[m]]
// and the backward, given lse and the cotangents g_lse, g_tok (f32),
//   d[m, v] = g_lse[m] * softmax[m, v] + g_tok[m] * (v == labels[m])
//   dX = bf16(d) . W   and   dW = bf16(d)^T . x,
// both accumulated in f32 and cast to bf16 once at the end. The
// (M, V) logits never reach device memory: each block recomputes its
// logits tiles in shared memory.
//
// Bound. At the GPT-2 round (M = 16 320, V = 50 262, C = 768) the work
// is 2*M*V*C = 1.26 TFLOP forward and 6*M*V*C = 3.78 TFLOP backward
// (the recompute plus the two products of the reference design): 1.27
// and 3.82 ms at 989 TFLOP/s of bf16 tensor-core work. The bytes (x 25
// MB, W 77 MB, dW 77 MB) take 0.03-0.06 ms at 3.35 TB/s, so both
// kernels are bound by operations.
//
// Forward. A block of two warpgroups (256 threads, one block an SM)
// owns 128 token rows, warpgroup g rows [64 g, 64 g + 64), and walks the
// vocab in tiles of 256 ids, always in the same order. Each tile is a K
// loop over 64-deep chunks: the x chunk (128 x 64 bf16) and the W chunk
// (256 x 64) come as SW128 panels through a four-stage cp.async ring
// (48 KB a stage), the copies of the next three (tile, chunk) steps in
// flight while one is multiplied. Each warpgroup multiplies its 64 rows
// by the W chunk with four wgmma m64n256k16 (A and B from shared memory,
// K-major), so that after the last chunk the 64 x 256 logits tile sits
// in 128 accumulator registers a thread. There it is folded into the
// thread's running (max, sum of exp) for each of its two rows, over its
// own 64 columns of the tile (ex2.approx, ids >= V left out), and the
// label's logit is picked by an unrolled compare-and-select; the logits
// never reach shared or device memory. At the end the four threads of a
// row merge their (max, sum) in a fixed order: no atomics, two launches
// give the same bits. At the GPT-2 round's shapes the blocks together
// read W once a block (128 x 77.2 MB) and x once a vocab tile (197 x
// 25.1 MB), 14.8 GB through L2, against 1.27 ms of tensor-core work: the
// L2 reads, ~2.6 ms at ~5.8 TB/s, set the design's pace. Measured: 2.756
// ms, 46% of the 1.274 ms bound (255 registers, 0 spills), on an NVIDIA
// H100 80GB HBM3 at 700 W.
//
// Backward. The TPU kernel carries dW across a sequential grid and
// writes per-vocab-block dX partials; blocks on Hopper run in no order,
// so one template runs twice: owning 64 token rows of x with W streamed
// (rows of dX), then owning 64 vocab rows of W with x streamed (rows of
// dW). Each pass recomputes its logits, so the work is 8*M*V*C (5.09 ms
// of tensor-core time at the GPT-2 shapes) against the bound's 6*M*V*C;
// in exchange every sum is taken in a fixed order with no atomics and
// no scratch, and two launches give the same bits. A block is two
// warpgroups (256 threads, one block an SM: ~210 KB of shared memory):
// - the owned tile (64 x C bf16, 96 KB at C = 768) is loaded once; the
//   streamed tiles (32 x C, 48 KB) come through a two-stage cp.async
//   ring, tile t + 1 in flight while tile t is multiplied. Both are
//   stored as SW128 panels (wgmma.cuh), which the same descriptors read
//   K-major for the logits and MN-major for the gradient product;
// - logits: warpgroup g computes the 64 x 32 tile over its half of K
//   (wgmma m64n32k16, A and B from shared memory); the warpgroups swap
//   partial sums through shared memory so that warpgroup g holds the
//   whole logits of columns [16 g, 16 g + 16), the gradient product's
//   k step g;
// - there it forms d = g_lse * exp(logit - lse) + g_tok * onehot in
//   registers and packs it to bf16 as that k step's A operand (the
//   m64n16 accumulator layout is wgmma's register A layout); the two
//   warpgroups swap these fragments (4 registers a thread), so neither
//   logits nor d ever reach memory;
// - out[:, panels of g] += d . str: warpgroup g owns half the output
//   columns ((NF + 1) / 2 panels of 64; for odd NF both compute the
//   middle one) in a 64 x C/2 f32 accumulator, 192 registers a thread at
//   C = 768, so C is a template parameter (widths 64..768 in steps of
//   64); pieces of n <= 256. Both warpgroups issue the same wgmma
//   sequence (a divergent one is serialized by ptxas);
// - the accumulator is cast to bf16, staged in shared memory and
//   written out 16 bytes a thread.
// Each pass re-reads the streamed operand through L2 once per owned
// tile: 255 x W (77.2 MB) for dX, 786 x x (25.1 MB) for dW, ~19.7 GB
// each. Left for later: clusters with TMA multicast to halve those
// re-reads, a producer warp with deeper rings, and overlapping one
// tile's logits with the previous tile's gradient product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
#include "wgmma.cuh"

namespace {

constexpr int THREADS = 256;   // 8 warps, two warpgroups
constexpr int FWD_BM = 128;    // token rows per forward block
constexpr int FWD_BN = 256;    // vocab ids per forward tile
constexpr int FWD_STAGES = 4;  // (x chunk, W chunk) pairs in the cp.async ring
constexpr int FWD_X_BYTES = FWD_BM * 128;  // one 64-column SW128 panel
constexpr int FWD_STAGE_BYTES = FWD_X_BYTES + FWD_BN * 128;
constexpr int BWD_OWN = 64;    // owned rows per backward block
constexpr int BWD_STR = 32;    // streamed rows per backward tile
constexpr int BWD_STAGES = 2;  // streamed tiles in the cp.async ring
static_assert(BWD_STAGES == 2, "the backward's ring alternates two stages");
constexpr int MAX_NF = 12;     // C <= 64 * MAX_NF

// 2^x, flushing results below 2^-126 to zero (one MUFU.EX2)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the first 1024-byte boundary at or after `raw` (shared memory)
__device__ __forceinline__ unsigned char* sw128_align(unsigned char* raw) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  return raw + ((CET_SW128_ATOM - (a & (CET_SW128_ATOM - 1))) &
                (CET_SW128_ATOM - 1));
}

// Folds one 64 x 256 logits tile (this thread's 128 accumulator
// registers) into the running max m and sum of exp s of the thread's two
// rows, h = 0 and 1 (accumulator register i holds row h = (i / 2) % 2 and
// tile column 8 (i / 4) + q2 + i % 2); tile columns >= vlim (ids >= V)
// are left out when RAGGED. Every sum is taken in one fixed order.
template <bool RAGGED>
__device__ __forceinline__ void fwd_fold_tile(const float* acc, int q2,
                                              int vlim, float* m, float* s) {
  constexpr float LOG2E = 1.4426950408889634f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int col = 8 * (j >> 1) + q2 + (j & 1);
      const float a = acc[4 * (j >> 1) + 2 * h + (j & 1)];
      mx = fmaxf(mx, (!RAGGED || col < vlim) ? a : -INFINITY);
    }
    const float m_new = fmaxf(m[h], mx);
    // a thread whose columns so far are all ids >= V keeps m = -inf
    const float m_ref = m_new == -INFINITY ? 0.0f : m_new;
    const float mL = m_ref * LOG2E;
    float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int col = 8 * (j >> 1) + q2 + (j & 1);
      const float e =
          ex2_ftz(fmaf(acc[4 * (j >> 1) + 2 * h + (j & 1)], LOG2E, -mL));
      p[j & 3] += (!RAGGED || col < vlim) ? e : 0.0f;
    }
    // first tile: m = -inf, s = 0 carries nothing
    s[h] = s[h] * ex2_ftz((m[h] - m_ref) * LOG2E) +
           ((p[0] + p[1]) + (p[2] + p[3]));
    m[h] = m_new;
  }
}

// The logit of tile column lc (< 256) of row h, which this thread holds:
// lc % 8 / 2 == q2 / 2. Compare-and-select over the thread's registers,
// never a register indexed at run time.
__device__ __forceinline__ float fwd_pick(const float* acc, unsigned lc,
                                          int h) {
  const int want = (int)(lc >> 3);
  const bool odd = lc & 1;
  float p = 0.0f;
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    const float a = odd ? acc[4 * jj + 2 * h + 1] : acc[4 * jj + 2 * h];
    p = jj == want ? a : p;
  }
  return p;
}

// One forward block: tokens [m0, m0 + 128) of x (M, C) against every
// vocab tile of W (V, C). PROBE: a single tile (M = 128, V = 256), whose
// logits are written to `probe` (128 x 256 f32) in place of the softmax.
template <bool PROBE>
__device__ __forceinline__ void fwd_block(unsigned char* smem_raw,
                                          const bf16* __restrict__ x,
                                          const bf16* __restrict__ w,
                                          const int* __restrict__ labels,
                                          float* __restrict__ lse,
                                          float* __restrict__ tok,
                                          float* __restrict__ probe,
                                          long long M, long long V, int C) {
  unsigned char* ring = sw128_align(smem_raw);
  const uint32_t ring_a = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const int tid = threadIdx.x, t = tid & 127;
  // warp-uniform to the compiler, so descriptors live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const long long m0 = (long long)blockIdx.x * FWD_BM;
  const int nk = C >> 6;  // 64-deep chunks a tile
  const int steps = (int)((V + FWD_BN - 1) / FWD_BN) * nk;

  // (tile, chunk) steps in order, step j into stage j % FWD_STAGES
  int ld_step = 0, ld_kc = 0;
  long long ld_v0 = 0;
  auto load_next = [&]() {
    if (ld_step < steps) {
      unsigned char* st = ring + (ld_step % FWD_STAGES) * FWD_STAGE_BYTES;
      cet_load_chunk_sw128<FWD_BM, THREADS>(st, x, m0, M, C, 64 * ld_kc, tid);
      cet_load_chunk_sw128<FWD_BN, THREADS>(st + FWD_X_BYTES, w, ld_v0, V, C,
                                            64 * ld_kc, tid);
      ++ld_step;
      if (++ld_kc == nk) {
        ld_kc = 0;
        ld_v0 += FWD_BN;
      }
    }
    cp_async_commit();  // an empty group past the last step keeps the count
  };
#pragma unroll
  for (int j = 0; j < FWD_STAGES - 1; ++j) load_next();

  // this thread's rows (of the warpgroup's 64) and column pair (of each 8)
  const int rA = 16 * (t >> 5) + ((t & 31) >> 2), q2 = 2 * (t & 3);
  long long row[2];
  int lab[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = m0 + 64 * wg + rA + 8 * h;
    const int l = (!PROBE && row[h] < M) ? labels[row[h]] : -1;
    lab[h] = (l >= 0 && l < V) ? l : -1;  // outside [0, V): picks nothing
  }
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY}, s_run[2] = {0.0f, 0.0f};
  float t_run[2] = {0.0f, 0.0f};

  int kc = 0;
  long long v0 = 0;
  for (int i = 0; i < steps; ++i) {
    // step i has landed (every thread's copies), and every wgmma of step
    // i - 1 has retired, so its stage may be refilled
    cp_async_wait_group<FWD_STAGES - 2>();
    cet_fence_proxy_async();
    __syncthreads();
    load_next();  // step i + FWD_STAGES - 1

    const uint32_t st = ring_a + (i % FWD_STAGES) * FWD_STAGE_BYTES;
    const uint64_t da = cet_sw128_desc(st + wg * 64 * 128, 16, CET_SW128_ATOM);
    const uint64_t db = cet_sw128_desc(st + FWD_X_BYTES, 16, CET_SW128_ATOM);
    cet_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      cet_wgmma_ss<256>(acc, cet_desc_add(da, 32 * kk),
                        cet_desc_add(db, 32 * kk), kc > 0 || kk > 0);
    cet_wgmma_commit();
    cet_wgmma_wait_all();
#pragma unroll
    for (int r = 0; r < 128; ++r) cet_fence_operand(acc[r]);
    if (++kc < nk) continue;

    // the tile's logits are complete
    kc = 0;
    if constexpr (PROBE) {
#pragma unroll
      for (int i2 = 0; i2 < 128; i2 += 2)
        *reinterpret_cast<float2*>(
            probe + (64 * wg + rA + 8 * ((i2 >> 1) & 1)) * FWD_BN +
            8 * (i2 >> 2) + q2) = make_float2(acc[i2], acc[i2 + 1]);
    } else {
      const int vlim = (int)min((long long)FWD_BN, V - v0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the label's tile column, wrapping mod 2^32 (ids fit in 31 bits)
        const unsigned lc = (unsigned)lab[h] - (unsigned)v0;
        if (lc < (unsigned)FWD_BN && (int)(lc & 6) == q2)
          t_run[h] = fwd_pick(acc, lc, h);
      }
      if (vlim < FWD_BN)
        fwd_fold_tile<true>(acc, q2, vlim, m_run, s_run);
      else
        fwd_fold_tile<false>(acc, q2, vlim, m_run, s_run);
      v0 += FWD_BN;
    }
  }

  if constexpr (!PROBE) {
    constexpr float LOG2E = 1.4426950408889634f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the quad's four (max, sum) pairs, then its one picked logit
      // (the others hold 0), in a fixed order
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m_run[h], off);
        const float so = __shfl_xor_sync(0xffffffffu, s_run[h], off);
        const float mn = fmaxf(m_run[h], mo);
        const float mr = mn == -INFINITY ? 0.0f : mn;
        s_run[h] = s_run[h] * ex2_ftz((m_run[h] - mr) * LOG2E) +
                   so * ex2_ftz((mo - mr) * LOG2E);
        m_run[h] = mn;
        t_run[h] += __shfl_xor_sync(0xffffffffu, t_run[h], off);
      }
      if (q2 == 0 && row[h] < M) {
        lse[row[h]] = m_run[h] + logf(s_run[h]);
        tok[row[h]] = t_run[h];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    flce_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ lse,
                    float* __restrict__ tok, long long M, long long V,
                    int C) {
  extern __shared__ unsigned char smem_raw[];
  fwd_block<false>(smem_raw, x, w, labels, lse, tok, nullptr, M, V, C);
}

// One forward tile through the forward's ring and descriptors, for
// checking them against a plain matrix product: probe = a . b^T in f32,
// a (128, C) and b (256, C) bf16 row-major.
__global__ void __launch_bounds__(THREADS, 1)
    fwd_probe_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                     float* __restrict__ probe, int C) {
  extern __shared__ unsigned char smem_raw[];
  fwd_block<true>(smem_raw, a, b, nullptr, nullptr, nullptr, probe, FWD_BM,
                  FWD_BN, C);
}

// ---- backward -----------------------------------------------------

// One warpgroup's half of the logits of the owned rows (64, the A
// operand) against the streamed rows (32, B), both SW128-panel tiles
// used K-major: lg = own[:, K_wg] . str[:, K_wg]^T, K_wg the warpgroup's
// half of the 4 * NF sixteen-deep k steps.
template <int NF>
__device__ __forceinline__ void bwd_logits_half(float* lg, uint64_t own_desc,
                                                uint64_t str_desc, int wg) {
  cet_wgmma_fence();
#pragma unroll
  for (int k = 0; k < 2 * NF; ++k) {
    const uint32_t kk = wg * 2 * NF + k;
    cet_wgmma_ss<32>(
        lg, cet_desc_add(own_desc, (kk >> 2) * BWD_OWN * 128 + (kk & 3) * 32),
        cet_desc_add(str_desc, (kk >> 2) * BWD_STR * 128 + (kk & 3) * 32),
        k > 0);
  }
  cet_wgmma_commit();
  cet_wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < 16; ++i) cet_fence_operand(lg[i]);
}

// Warpgroup g finishes k step g of the gradient product, the logits
// columns [16 g, 16 g + 16): it posts its partial sums of the other
// warpgroup's 16 columns to `xbuf` and adds the other's partial sums of
// its own, into h (h[j] is the accumulator entry 8 g + j of the 64 x 32
// tile). Thread t of one warpgroup holds the same (row, column) entries
// as thread t of the other.
__device__ __forceinline__ void bwd_exchange_half(const float* lg, float* h,
                                                  float* xbuf, int wg, int t) {
  float* mine = xbuf + wg * 8 * 128;
  const float* other = xbuf + (wg ^ 1) * 8 * 128;
#pragma unroll
  for (int j = 0; j < 8; ++j) mine[j * 128 + t] = wg ? lg[j] : lg[8 + j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j)
    h[j] = (wg ? lg[8 + j] : lg[j]) + other[j * 128 + t];
}

// The A fragments of both k steps: this warpgroup's (k step wg) and the
// other's, swapped through `abuf`
__device__ __forceinline__ void bwd_exchange_afr(const uint32_t* a,
                                                 uint32_t (*afr)[4],
                                                 uint32_t* abuf, int wg,
                                                 int t) {
  uint32_t* mine = abuf + wg * 4 * 128;
  const uint32_t* other = abuf + (wg ^ 1) * 4 * 128;
#pragma unroll
  for (int j = 0; j < 4; ++j) mine[j * 128 + t] = a[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t b = other[j * 128 + t];
    afr[0][j] = wg ? b : a[j];
    afr[1][j] = wg ? a[j] : b;
  }
}

// bf16 pair, low column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// out[:, P panels] += d . str[:, P panels]: A = d (64 x 32) from
// registers as two 16-deep k steps, B = the streamed tile used MN-major
// from its panel at `desc` on. Pieces of at most 4 panels (n <= 256).
template <int P>
__device__ __forceinline__ void bwd_grad_panels(float* acc,
                                                uint32_t (*afr)[4],
                                                uint64_t desc) {
  constexpr int PA = P <= 4 ? P : (P + 1) / 2;
  constexpr int PB = P - PA;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    cet_wgmma_rs_tb<64 * PA>(acc, afr[kk], cet_desc_add(desc, kk * 16 * 128));
    if constexpr (PB > 0)
      cet_wgmma_rs_tb<64 * PB>(
          acc + 32 * PA, afr[kk],
          cet_desc_add(desc, PA * BWD_STR * 128 + kk * 16 * 128));
  }
}

// Each warpgroup takes P = (NF + 1) / 2 panels of the output columns:
// warpgroup 0 the first P, warpgroup 1 the last P (for odd NF both
// compute the middle panel, and warpgroup 0 writes it). Both issue the
// same wgmma sequence, only the descriptors differ: a wgmma on a path
// that diverges between warpgroups makes ptxas serialize every wgmma of
// the kernel.
template <int NF>
__device__ __forceinline__ int bwd_first_panel(int wg) {
  return wg * (NF - (NF + 1) / 2);
}

template <int NF>
__device__ __forceinline__ void bwd_grad(float* acc, uint32_t (*afr)[4],
                                         uint64_t str_mn_desc, int wg) {
  constexpr int P = (NF + 1) / 2;
  cet_wgmma_fence();
  bwd_grad_panels<P>(
      acc, afr,
      cet_desc_add(str_mn_desc, bwd_first_panel<NF>(wg) * BWD_STR * 128));
  cet_wgmma_commit();
  cet_wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < 32 * P; ++i) cet_fence_operand(acc[i]);
}

struct BwdSmem {
  unsigned char* own;  // (BWD_OWN, C) SW128 panels
  unsigned char* str;  // BWD_STAGES x (BWD_STR, C) SW128 panels
  float* xbuf;         // 2 x 8 x 128 f32 partial logits
  uint32_t* abuf;      // 2 x 4 x 128 bf16 pairs of d
  float* toks;         // label, lse, g_lse, g_tok per token
};

template <int NF>
__device__ __forceinline__ BwdSmem bwd_carve(unsigned char* raw) {
  constexpr int C = 64 * NF;
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  unsigned char* base = raw + ((CET_SW128_ATOM - (a & (CET_SW128_ATOM - 1))) &
                               (CET_SW128_ATOM - 1));
  BwdSmem s;
  s.own = base;
  s.str = base + BWD_OWN * C * 2;
  s.xbuf = reinterpret_cast<float*>(s.str + BWD_STAGES * BWD_STR * C * 2);
  s.abuf = reinterpret_cast<uint32_t*>(s.xbuf + 2 * 8 * 128);
  s.toks = s.xbuf + 2 * 16 * 128;
  return s;
}

// OWN_TOK: own rows are tokens (x) and the output is dX; otherwise own
// rows are vocab ids (W) and the output is dW. C = 64 * NF.
template <bool OWN_TOK, int NF>
__global__ void __launch_bounds__(THREADS, 1)
    flce_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const int* __restrict__ labels,
                    const float* __restrict__ lse,
                    const float* __restrict__ g_lse,
                    const float* __restrict__ g_tok, bf16* __restrict__ out,
                    long long M, long long V) {
  constexpr int C = 64 * NF;
  constexpr int P = (NF + 1) / 2;  // output panels a warpgroup
  constexpr int STR_BYTES = BWD_STR * C * 2;
  extern __shared__ unsigned char smem_raw[];
  const BwdSmem sm = bwd_carve<NF>(smem_raw);

  const int tid = threadIdx.x, t = tid & 127;
  // warp-uniform to the compiler, so descriptors live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const bf16* own = OWN_TOK ? x : w;
  const bf16* str = OWN_TOK ? w : x;
  const long long n_own = OWN_TOK ? M : V;
  const long long n_str = OWN_TOK ? V : M;
  const long long o0 = (long long)blockIdx.x * BWD_OWN;
  const long long n_tiles = (n_str + BWD_STR - 1) / BWD_STR;

  // label, lse, g_lse, g_tok of tokens [t0, t0 + n) as four arrays of n;
  // tokens past M read as zero, which makes their d zero
  auto load_tokens = [&](float* dst, long long t0, int n) {
    for (int i = tid; i < 4 * n; i += THREADS) {
      const int a = i / n, k = i - a * n;
      const bool ok = t0 + k < M;
      const long long tk = ok ? t0 + k : 0;
      const void* src = a == 0   ? (const void*)(labels + tk)
                        : a == 1 ? (const void*)(lse + tk)
                        : a == 2 ? (const void*)(g_lse + tk)
                                 : (const void*)(g_tok + tk);
      cp_async4(dst + i, src, ok);
    }
  };

  cet_load_tile_sw128<BWD_OWN, C>(sm.own, own, o0, n_own, tid, THREADS);
  if (OWN_TOK) load_tokens(sm.toks, o0, BWD_OWN);
  cet_load_tile_sw128<BWD_STR, C>(sm.str, str, 0, n_str, tid, THREADS);
  if (!OWN_TOK) load_tokens(sm.toks, 0, BWD_STR);
  cp_async_commit();

  const uint32_t own_a = static_cast<uint32_t>(__cvta_generic_to_shared(sm.own));
  const uint32_t str_a = static_cast<uint32_t>(__cvta_generic_to_shared(sm.str));
  const uint64_t own_desc = cet_sw128_desc(own_a, 16, CET_SW128_ATOM);
  // this thread's accumulator rows (of 64) and column pair (of each 8)
  const int rA = 16 * (t >> 5) + ((t & 31) >> 2), q2 = 2 * (t & 3);

  float acc[32 * P];
#pragma unroll
  for (int i = 0; i < 32 * P; ++i) acc[i] = 0.0f;

  for (long long it = 0; it < n_tiles; ++it) {
    const int s = (int)(it & 1);
    // tile `it` has landed in stage s (every thread's copies, and the
    // last tile's readers are done with stage s ^ 1)
    cp_async_wait_group0();
    cet_fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_tiles) {
      cet_load_tile_sw128<BWD_STR, C>(sm.str + (s ^ 1) * STR_BYTES, str,
                                      (it + 1) * BWD_STR, n_str, tid, THREADS);
      if (!OWN_TOK)
        load_tokens(sm.toks + (s ^ 1) * 4 * BWD_STR, (it + 1) * BWD_STR,
                    BWD_STR);
    }
    cp_async_commit();

    const uint32_t stage_a = str_a + s * STR_BYTES;
    float lg[16] = {};
    bwd_logits_half<NF>(lg, own_desc,
                        cet_sw128_desc(stage_a, 16, CET_SW128_ATOM), wg);
    float h[8];
    bwd_exchange_half(lg, h, sm.xbuf, wg, t);

    // d = g_lse * softmax + g_tok * onehot of this warpgroup's 16
    // columns, vocab ids >= V left out, branch-free: exp as
    // ex2.approx.ftz (a few f32 ulps, far below d's bf16 rounding).
    // Vocab id = vbase + j for tile column j (dX) or owned row j (dW),
    // valid for j < vlim. Ids fit in 31 bits (W, V x C bf16 with C >= 64,
    // fits in device memory); a label compares as its offset from vbase,
    // wrapping mod 2^32, so only an exact match lands in [0, 64)
    const float* tk = OWN_TOK ? sm.toks : sm.toks + s * 4 * BWD_STR;
    constexpr int NT = OWN_TOK ? BWD_OWN : BWD_STR;
    const long long vbase = OWN_TOK ? it * BWD_STR : o0;
    const int vlim = (int)min((long long)(OWN_TOK ? BWD_STR : BWD_OWN),
                              V - vbase);
    const unsigned vb = (unsigned)vbase;
    constexpr float LOG2E = 1.4426950408889634f;
    uint32_t a[4];
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      float dv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = rA + 8 * (((j + e) >> 1) & 1);
        const int sc = 16 * wg + 8 * ((j + e) >> 2) + q2 + ((j + e) & 1);
        const int ti = OWN_TOK ? o : sc;
        const int vj = OWN_TOK ? sc : o;
        const float lse_t = tk[NT + ti], gl = tk[2 * NT + ti];
        const float gt = tk[3 * NT + ti];
        const int lr = (int)((unsigned)__float_as_int(tk[ti]) - vb);
        const float p = ex2_ftz((h[j + e] - lse_t) * LOG2E);
        const float d = gl * p + (vj == lr ? gt : 0.0f);
        dv[e] = vj < vlim ? d : 0.0f;
      }
      a[j >> 1] = pack_bf16(dv[0], dv[1]);
    }
    uint32_t afr[2][4];
    bwd_exchange_afr(a, afr, sm.abuf, wg, t);

    bwd_grad<NF>(acc, afr,
                 cet_sw128_desc(stage_a, BWD_STR * 128, CET_SW128_ATOM), wg);
  }

  // bf16 rows staged in shared memory (row stride C + 8), then written
  // out 16 bytes a thread
  __syncthreads();
  bf16* st = reinterpret_cast<bf16*>(sm.own);
  constexpr int LDS = C + 8;
  // warpgroup 1 leaves the panel it shares with warpgroup 0 (odd NF)
  const int col0 = 64 * bwd_first_panel<NF>(wg);
  const int skip = wg * 32 * (2 * P - NF);
#pragma unroll
  for (int i = 0; i < 32 * P; i += 2) {
    if (i >= skip) {
      const int r = rA + 8 * ((i >> 1) & 1);
      const int c = col0 + 8 * (i >> 2) + q2;
      *reinterpret_cast<__nv_bfloat162*>(st + r * LDS + c) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
  __syncthreads();
  for (int i = tid; i < BWD_OWN * (C / 8); i += THREADS) {
    const int r = i / (C / 8), ch = i - r * (C / 8);
    if (o0 + r < n_own)
      *reinterpret_cast<uint4*>(out + (o0 + r) * (long long)C + ch * 8) =
          *reinterpret_cast<const uint4*>(st + r * LDS + ch * 8);
  }
}

// One tile of each product shape of the backward, for checking the
// shared-memory layout and the descriptors against a plain matrix
// product: l = a . s^T through bwd_logits_half + bwd_exchange_half (K-major
// A and B), g = dm . s through bwd_grad (A from registers, B MN-major),
// both in f32. a (64, C), s (32, C), dm (64, 32) bf16, row-major.
template <int NF>
__global__ void __launch_bounds__(THREADS, 1)
    wgmma_probe_kernel(const bf16* __restrict__ a, const bf16* __restrict__ s,
                       const bf16* __restrict__ dm, float* __restrict__ l,
                       float* __restrict__ g) {
  constexpr int C = 64 * NF;
  constexpr int P = (NF + 1) / 2;
  extern __shared__ unsigned char smem_raw[];
  const BwdSmem sm = bwd_carve<NF>(smem_raw);
  const int tid = threadIdx.x, t = tid & 127;
  // warp-uniform to the compiler, so descriptors live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  cet_load_tile_sw128<BWD_OWN, C>(sm.own, a, 0, BWD_OWN, tid, THREADS);
  cet_load_tile_sw128<BWD_STR, C>(sm.str, s, 0, BWD_STR, tid, THREADS);
  cp_async_commit();
  cp_async_wait_group0();
  cet_fence_proxy_async();
  __syncthreads();
  const uint32_t own_a = static_cast<uint32_t>(__cvta_generic_to_shared(sm.own));
  const uint32_t str_a = static_cast<uint32_t>(__cvta_generic_to_shared(sm.str));
  const int rA = 16 * (t >> 5) + ((t & 31) >> 2), q2 = 2 * (t & 3);

  float lg[16] = {}, h[8];
  bwd_logits_half<NF>(lg, cet_sw128_desc(own_a, 16, CET_SW128_ATOM),
                      cet_sw128_desc(str_a, 16, CET_SW128_ATOM), wg);
  bwd_exchange_half(lg, h, sm.xbuf, wg, t);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    l[(rA + 8 * ((j >> 1) & 1)) * BWD_STR + 16 * wg + 8 * (j >> 2) + q2 +
      (j & 1)] = h[j];

  const uint32_t* dm32 = reinterpret_cast<const uint32_t*>(dm);
  uint32_t afr[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      afr[kk][j] = dm32[((rA + 8 * (j & 1)) * BWD_STR + 16 * kk + 8 * (j >> 1) +
                         q2) >> 1];
  float acc[32 * P];
#pragma unroll
  for (int i = 0; i < 32 * P; ++i) acc[i] = 0.0f;
  bwd_grad<NF>(acc, afr, cet_sw128_desc(str_a, BWD_STR * 128, CET_SW128_ATOM),
               wg);
  const int col0 = 64 * bwd_first_panel<NF>(wg);
  const int skip = wg * 32 * (2 * P - NF);
#pragma unroll
  for (int i = 0; i < 32 * P; ++i)
    if (i >= skip)
      g[(rA + 8 * ((i >> 1) & 1)) * C + col0 + 8 * (i >> 2) + q2 + (i & 1)] =
          acc[i];
}

constexpr size_t FWD_SMEM =
    CET_SW128_ATOM + (size_t)FWD_STAGES * FWD_STAGE_BYTES;  // + alignment slack

size_t bwd_smem(int C) {
  return (size_t)CET_SW128_ATOM  // slack to align the panels
         + (size_t)(BWD_OWN + BWD_STAGES * BWD_STR) * C * sizeof(bf16) +
         2 * 16 * 128 * sizeof(float)                 // xbuf
         + (size_t)BWD_STAGES * 4 * BWD_STR * 4;      // tokens (>= 4 * 64)
}

template <bool OWN_TOK, int NF>
cudaError_t launch_bwd(const bf16* x, const bf16* w, const int* labels,
                       const float* lse, const float* g_lse,
                       const float* g_tok, bf16* out, long long M,
                       long long V, cudaStream_t stream) {
  const size_t smem = bwd_smem(64 * NF);
  cudaError_t err = cudaFuncSetAttribute(
      flce_bwd_kernel<OWN_TOK, NF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_own = OWN_TOK ? M : V;
  const unsigned grid = (unsigned)((n_own + BWD_OWN - 1) / BWD_OWN);
  flce_bwd_kernel<OWN_TOK, NF><<<grid, THREADS, smem, stream>>>(
      x, w, labels, lse, g_lse, g_tok, out, M, V);
  return cudaGetLastError();
}

template <int NF>
cudaError_t bwd_both(const bf16* x, const bf16* w, const int* labels,
                     const float* lse, const float* g_lse, const float* g_tok,
                     bf16* dx, bf16* dw, long long M, long long V,
                     cudaStream_t stream) {
  cudaError_t err =
      launch_bwd<true, NF>(x, w, labels, lse, g_lse, g_tok, dx, M, V, stream);
  if (err != cudaSuccess) return err;
  return launch_bwd<false, NF>(x, w, labels, lse, g_lse, g_tok, dw, M, V,
                               stream);
}

template <int NF>
cudaError_t launch_probe(const bf16* a, const bf16* s, const bf16* dm,
                         float* l, float* g, cudaStream_t stream) {
  const size_t smem = bwd_smem(64 * NF);
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_probe_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  wgmma_probe_kernel<NF><<<1, THREADS, smem, stream>>>(a, s, dm, l, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// widths the kernels take: C % 64 == 0 and 64 <= C <= 768
int cet_flce_max_width() { return 64 * MAX_NF; }

int cet_flce_fwd(const void* x, const void* w, const int* labels, float* lse,
                 float* tok, long long M, long long V, int C, void* stream) {
  if (C % 64 != 0 || C < 64 || C > 64 * MAX_NF || M <= 0 || V <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((M + FWD_BM - 1) / FWD_BM);
  flce_fwd_kernel<<<grid, THREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), labels, lse,
      tok, M, V, C);
  return (int)cudaGetLastError();
}

int cet_flce_bwd(const void* x, const void* w, const int* labels,
                 const float* lse, const float* g_lse, const float* g_tok,
                 void* dx, void* dw, long long M, long long V, int C,
                 void* stream) {
  if (C % 64 != 0 || C < 64 || C > 64 * MAX_NF || M <= 0 || V <= 0)
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* dxb = static_cast<bf16*>(dx);
  bf16* dwb = static_cast<bf16*>(dw);
  cudaStream_t s = (cudaStream_t)stream;
  switch (C / 64) {
#define CET_FLCE_CASE(NF) \
  case NF:                \
    return (int)bwd_both<NF>(xb, wb, labels, lse, g_lse, g_tok, dxb, dwb, M, V, s);
    CET_FLCE_CASE(1)
    CET_FLCE_CASE(2)
    CET_FLCE_CASE(3)
    CET_FLCE_CASE(4)
    CET_FLCE_CASE(5)
    CET_FLCE_CASE(6)
    CET_FLCE_CASE(7)
    CET_FLCE_CASE(8)
    CET_FLCE_CASE(9)
    CET_FLCE_CASE(10)
    CET_FLCE_CASE(11)
    CET_FLCE_CASE(12)
#undef CET_FLCE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// one tile of each backward product shape (wgmma_probe_kernel); widths
// 320 and 768 (an odd and an even number of 64-column panels)
int cet_wgmma_probe(const void* a, const void* s, const void* dm, float* l,
                    float* g, int C, void* stream) {
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* sb = static_cast<const bf16*>(s);
  const bf16* db = static_cast<const bf16*>(dm);
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 320) return (int)launch_probe<5>(ab, sb, db, l, g, st);
  if (C == 768) return (int)launch_probe<12>(ab, sb, db, l, g, st);
  return (int)cudaErrorInvalidValue;
}

// one forward tile (fwd_probe_kernel): probe (128, 256) = a (128, C) .
// b (256, C)^T in f32, any width the forward takes
int cet_wgmma_fwd_probe(const void* a, const void* b, float* probe, int C,
                        void* stream) {
  if (C % 64 != 0 || C < 64 || C > 64 * MAX_NF)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  fwd_probe_kernel<<<1, THREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), probe, C);
  return (int)cudaGetLastError();
}

}  // extern "C"

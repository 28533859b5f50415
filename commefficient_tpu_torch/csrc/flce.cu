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
// Forward. nvcuda::wmma (mma.sync, 16x16x16 bf16 -> f32) tile
// products: a block of 8 warps owns 64 token rows of x (resident in
// shared memory) and streams 64-row vocab tiles of W, always in the
// same order. Each 64 x 64 logits tile is folded into a running max and
// sum-of-exp per token (online softmax) and the label logit is picked;
// vocab ids >= V count as -inf. One tile buffer: loads do not overlap
// the products (12.22 ms against the 1.274 ms bound on an NVIDIA H100
// 80GB HBM3 at 700 W; its redesign is the next kernel of PERF.md).
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
#include <mma.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
#include "wgmma.cuh"

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;   // 8 warps
constexpr int BS = 64;         // streamed rows per tile
constexpr int PAD = 8;         // bf16 padding per shared row (16 bytes)
constexpr int LDL = BS + 4;    // f32 logits tile row stride
constexpr int FWD_OWN = 64;    // token rows per forward block
constexpr int BWD_OWN = 64;    // owned rows per backward block
constexpr int BWD_STR = 32;    // streamed rows per backward tile
constexpr int BWD_STAGES = 2;  // streamed tiles in the cp.async ring
static_assert(BWD_STAGES == 2, "the backward's ring alternates two stages");
constexpr int MAX_NF = 12;     // C <= 64 * MAX_NF

// rows [row0, row0 + ROWS) of a row-major (nrows, C) bf16 matrix into
// shared memory with row stride C + PAD; rows past nrows read as zero
template <int ROWS>
__device__ __forceinline__ void load_rows(bf16* sm, const bf16* g,
                                          long long row0, long long nrows,
                                          int C) {
  const int cpr = C >> 3;  // 16-byte chunks per row
  const int ld = C + PAD;
  for (int i = threadIdx.x; i < ROWS * cpr; i += THREADS) {
    const int r = i / cpr, ch = i - r * cpr;
    const long long gr = row0 + r;
    const bool ok = gr < nrows;
    cp_async16(sm + r * ld + ch * 8, g + (ok ? gr : 0) * (long long)C + ch * 8,
               ok);
  }
}

// L[OWN][BS] (row stride LDL) = own (OWN x C) . str (BS x C)^T. Warp w
// takes the column block w % 4 and the row blocks w / 4, w / 4 + 2, ...;
// two accumulator chains per fragment (even and odd k steps).
template <int OWN>
__device__ __forceinline__ void tile_logits(const bf16* own, const bf16* str,
                                            int C, float* L) {
  constexpr int FM = OWN / 16;          // row blocks
  constexpr int PER = FM / 2;           // row blocks per warp
  static_assert(BS / 16 == 4 && FM % 2 == 0, "tile shape");
  const int warp = threadIdx.x >> 5;
  const int fn = warp & 3;
  const int ld = C + PAD;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[PER][2];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    wmma::fill_fragment(acc[i][0], 0.0f);
    wmma::fill_fragment(acc[i][1], 0.0f);
  }
  for (int k = 0; k < C; k += 32) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, str + fn * 16 * ld + k + h * 16, ld);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int fm = (warp >> 2) + 2 * i;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, own + fm * 16 * ld + k + h * 16, ld);
        wmma::mma_sync(acc[i][h], a, b, acc[i][h]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int fm = (warp >> 2) + 2 * i;
#pragma unroll
    for (int t = 0; t < acc[i][0].num_elements; ++t)
      acc[i][0].x[t] += acc[i][1].x[t];
    wmma::store_matrix_sync(L + fm * 16 * LDL + fn * 16, acc[i][0], LDL,
                            wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    flce_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ lse,
                    float* __restrict__ tok, long long M, long long V,
                    int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = C + PAD;
  bf16* sx = reinterpret_cast<bf16*>(smem);
  bf16* sw = sx + FWD_OWN * ld;
  float* L = reinterpret_cast<float*>(sw + BS * ld);

  const long long m0 = (long long)blockIdx.x * FWD_OWN;
  load_rows<FWD_OWN>(sx, x, m0, M, C);
  // four threads per token row, 16 logits columns each
  const int row = threadIdx.x >> 2, q = threadIdx.x & 3;
  const long long gm = m0 + row;
  const int lab = gm < M ? labels[gm] : -1;
  float m_run = -INFINITY, s_run = 0.0f, t_run = 0.0f;

  for (long long v0 = 0; v0 < V; v0 += BS) {
    load_rows<BS>(sw, w, v0, V, C);
    cp_async_wait_all();
    __syncthreads();
    tile_logits<FWD_OWN>(sx, sw, C, L);
    __syncthreads();
    const float* Lr = L + row * LDL + q * 16;
    float vals[16];
    float bmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const long long vid = v0 + q * 16 + j;
      const float v = vid < V ? Lr[j] : -INFINITY;
      vals[j] = v;
      bmax = fmaxf(bmax, v);
      if (vid == lab && vid < V) t_run += v;  // labels outside [0, V): 0
    }
    bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, 1));
    bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, 2));
    const float m_new = fmaxf(m_run, bmax);
    float se = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) se += expf(vals[j] - m_new);
    se += __shfl_xor_sync(0xffffffffu, se, 1);
    se += __shfl_xor_sync(0xffffffffu, se, 2);
    // first tile: exp(-inf - finite) == 0 folds the empty carry in
    s_run = s_run * expf(m_run - m_new) + se;
    m_run = m_new;
    __syncthreads();  // the next tile overwrites sw and L
  }
  t_run += __shfl_xor_sync(0xffffffffu, t_run, 1);
  t_run += __shfl_xor_sync(0xffffffffu, t_run, 2);
  if (q == 0 && gm < M) {
    lse[gm] = m_run + logf(s_run);
    tok[gm] = t_run;
  }
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
    cet_wgmma_ss_n32(
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

// 2^x, flushing results below 2^-126 to zero (one MUFU.EX2)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

size_t fwd_smem(int C) {
  return (size_t)(FWD_OWN + BS) * (C + PAD) * sizeof(bf16) +
         (size_t)FWD_OWN * LDL * sizeof(float);
}

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
  const size_t smem = fwd_smem(C);
  cudaError_t err = cudaFuncSetAttribute(
      flce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((M + FWD_OWN - 1) / FWD_OWN);
  flce_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
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

}  // extern "C"

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
// Design. Tile products run on the tensor cores through nvcuda::wmma
// (mma.sync, 16x16x16 bf16 -> f32). A block of 8 warps owns a tile of
// rows of one operand ("own", resident in shared memory) and streams
// 64-row tiles of the other, always in the same order, so every sum is
// taken in a fixed order: no float atomics, the same bits every run.
// - Forward: own = 64 token rows of x, streamed = vocab tiles of W.
//   Each 64 x 64 logits tile is folded into a running max and
//   sum-of-exp per token (online softmax) and the label logit is
//   picked; vocab ids >= V count as -inf.
// - Backward: the TPU kernel carries dW across a sequential grid and
//   writes per-vocab-block dX partials; blocks on Hopper run in no
//   order, so the port runs the same template twice. With own = 32
//   token rows of x and W streamed it accumulates those rows of dX;
//   with own = 32 vocab rows of W and x streamed, those rows of dW.
//   Each recomputes its logits tiles (4*M*V*C per pass, 8*M*V*C in
//   all against the bound's 6), builds the bf16 d tile in shared
//   memory and multiplies it into a (32, C) f32 accumulator held in
//   registers (C / 64 fragments per warp, so C is a template
//   parameter: widths 64..768 in steps of 64).
// What the design leaves on the table (later work): loads are not
// overlapped with the tile products (one 64-row tile buffer), warps
// issue mma.sync rather than wgmma, and W (77 MB, above the 50 MB L2)
// is streamed once per token tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BS = 64;         // streamed rows per tile
constexpr int PAD = 8;         // bf16 padding per shared row (16 bytes)
constexpr int LDL = BS + 4;    // f32 logits tile row stride
constexpr int LDD = BS + 8;    // bf16 d tile row stride
constexpr int FWD_OWN = 64;    // token rows per forward block
constexpr int BWD_OWN = 32;    // owned rows per backward block
constexpr int MAX_NF = 12;     // C <= 64 * MAX_NF

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

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
  constexpr int ld = C + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* so = reinterpret_cast<bf16*>(smem);
  bf16* ss = so + BWD_OWN * ld;
  float* L = reinterpret_cast<float*>(ss + BS * ld);
  bf16* D = reinterpret_cast<bf16*>(L + BWD_OWN * LDL);
  // per-token label, lse, g_lse, g_tok of the owned (OWN_TOK) or the
  // current streamed tile's tokens; tokens past M: label -1, zeros
  int* t_lab = reinterpret_cast<int*>(D + BWD_OWN * LDD);
  float* t_lse = reinterpret_cast<float*>(t_lab + BS);
  float* t_gl = t_lse + BS;
  float* t_gt = t_gl + BS;

  const bf16* own = OWN_TOK ? x : w;
  const bf16* str = OWN_TOK ? w : x;
  const long long n_own = OWN_TOK ? M : V;
  const long long n_str = OWN_TOK ? V : M;
  const long long o0 = (long long)blockIdx.x * BWD_OWN;

  auto load_tokens = [&](long long t0, int n) {
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const long long t = t0 + i;
      const bool ok = t < M;
      t_lab[i] = ok ? labels[t] : -1;
      t_lse[i] = ok ? lse[t] : 0.0f;
      t_gl[i] = ok ? g_lse[t] : 0.0f;
      t_gt[i] = ok ? g_tok[t] : 0.0f;
    }
  };

  load_rows<BWD_OWN>(so, own, o0, n_own, C);
  if (OWN_TOK) load_tokens(o0, BWD_OWN);

  const int warp = threadIdx.x >> 5;
  const int rb = warp >> 2;  // 16-row block of the accumulator
  const int cb = warp & 3;   // C / 4 columns of the accumulator
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.0f);

  for (long long s0 = 0; s0 < n_str; s0 += BS) {
    load_rows<BS>(ss, str, s0, n_str, C);
    if (!OWN_TOK) load_tokens(s0, BS);
    cp_async_wait_all();
    __syncthreads();
    tile_logits<BWD_OWN>(so, ss, C, L);
    __syncthreads();
    for (int e = threadIdx.x; e < BWD_OWN * BS; e += THREADS) {
      const int o = e / BS, s = e - o * BS;
      const int ti = OWN_TOK ? o : s;
      const long long vid = OWN_TOK ? s0 + s : o0 + o;
      // padded vocab rows are zero, so their logits are 0, not -inf:
      // keep them out of the softmax
      const float p = vid < V ? expf(L[o * LDL + s] - t_lse[ti]) : 0.0f;
      float d = t_gl[ti] * p;
      if (vid == t_lab[ti]) d += t_gt[ti];
      D[o * LDD + s] = __float2bfloat16(d);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BS / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, D + rb * 16 * LDD + kk * 16, LDD);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, ss + kk * 16 * ld + (cb * NF + f) * 16,
                               ld);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
    __syncthreads();  // the next tile overwrites ss, L, D and the tokens
  }

  // f32 accumulator -> shared staging (the streamed buffer holds
  // 64 * (C + 8) bf16 >= 32 * C f32) -> bf16 rows of the output
  float* st = reinterpret_cast<float*>(ss);
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(st + rb * 16 * C + (cb * NF + f) * 16, acc[f], C,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BWD_OWN * C; i += THREADS) {
    const int r = i / C;
    if (o0 + r < n_own)
      out[(o0 + r) * (long long)C + (i - r * C)] = __float2bfloat16(st[i]);
  }
}

size_t fwd_smem(int C) {
  return (size_t)(FWD_OWN + BS) * (C + PAD) * sizeof(bf16) +
         (size_t)FWD_OWN * LDL * sizeof(float);
}

size_t bwd_smem(int C) {
  return (size_t)(BWD_OWN + BS) * (C + PAD) * sizeof(bf16) +
         (size_t)BWD_OWN * LDL * sizeof(float) +
         (size_t)BWD_OWN * LDD * sizeof(bf16) + (size_t)BS * 4 * 4;
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

}  // extern "C"

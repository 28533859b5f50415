// Causal flash attention for Hopper (sm_90a): forward, dK/dV backward and
// dQ backward -- replaces the three pl.pallas_call kernels of JAX's
// library flash attention (jax/experimental/pallas/ops/tpu/
// flash_attention.py in jax 0.9.0) that commefficient_tpu/models/gpt2.py:
// 115-135 reaches under --attn_impl flash:
//   cet_attn_fwd      <- _flash_attention_impl (:589, call at :758), the
//                        kernel bodies at :387-477 (online) and :484-557
//                        (single step);
//   cet_attn_bwd_dkv  <- _flash_attention_bwd_dkv (:941, call at :1121),
//                        body at :796-940;
//   cet_attn_bwd_dq   <- _flash_attention_bwd_dq (:1287, call at :1456),
//                        body at :1146-1286.
//
// The function is the library's, with the repo's block sizes (every
// block b = the first of 512, 256, 128 that divides T; models/gpt2.py:
// 129-134), not a generic softmax attention. Scores are
// s = (q . k^T, f32 sums) * sm_scale, and a causal position (col > row)
// gets + MASK, a finite -0.7 * FLT_MAX (:29), not -inf.
//   Forward, b == T (the library's single step, :484-557): m = rowmax(s),
// p = exp(s - m), l = sum p, p /= l, o = (p cast to the input type) . v,
// f32 sums, cast. Forward, T > b (the online update, :387-477), per K
// block of b columns: m' = max(m, rowmax), p = exp(s - m'),
// l' = sum p + exp(m - m') l, acc = acc (exp(m - m') l / l') +
// ((p cast, unnormalised) . v) / l'. The two round p to bf16 at
// different scales, so both designs below keep the reference's K
// blocking: p is cast against the max of a whole block of b columns (and,
// in the single step, after the division by the whole row's l).
//   Backward (:254-318, :796-940, :1146-1286): p = exp(s - m) * (1 / l),
// dv = (p cast)^T . do, dp = do . v^T, ds = ((dp - di) * p) * sm_scale,
// dk = (ds cast)^T . q, dq = (ds cast) . k, each f32 sums cast to the
// input type. di = sum(o * do) over the head dim is the reference's XLA
// code outside its kernels; here it stays a PyTorch reduction
// (ops/attention.py). The backward's numbers do not depend on its
// blocking. dK/dV and dQ are two kernels, each owning its outputs, so
// the backward is deterministic and uses no atomics.
//   Work wholly above the diagonal contributes exact zeros in the
// reference (exp(MASK - m) = 0) and is skipped here.
//
// Layout: the kernels read q, k, v and do through strides (batch, head,
// token; the head dim is unit-stride), so the (B, T, H, hd) views the
// model cuts from its fused qkv projection go in without a transpose;
// they write o, dq, dk and dv with the strides they are given, and m and
// l as (B, H, T) f32.
//
// Two designs, fixed per template instantiation (tc_design(); never a
// fallback at run time):
// - tensor cores (wgmma) for the forward, dK/dV and dQ at bf16, hd 64
//   and 128 (GPT-2's 12 heads of 64 take hd 64);
// - FMA for f32 at every hd (a bf16 or TF32 product would change its
//   results) and bf16 at hd 16 and 32 (narrower than a 64-column SW128
//   panel).
//
// Tensor-core forward (attn_fwd_tc_kernel, single step and online update
// as two instantiations). A block is one warpgroup (128 threads) and owns
// a 64-row q tile of one (batch, head); the tiles with most work launch
// first. Q, K and V come into SW128 panels (csrc/wgmma.cuh) by cp.async
// through their strides, the next step's K chunk and V chunk in flight
// while the current one is used. S = Q . K^T over a chunk of up to 256
// columns is one shared-shared wgmma (m64nNk16, hd / 16 k steps) into f32
// registers (128 a thread for 64 x 256); there the mask (+ MASK, as
// masked()), the row max across the four threads of a row, exp, l, and
// (single step) p * (1 / l) are taken, p is packed to bf16 pairs (the
// accumulator layout of one product is the register-A layout of the
// next) and multiplied by V, MN-major, with register-A wgmmas. A
// reference block of at most one chunk (the single step at T <= 256 at
// hd 64, the round's shape) makes one q . k^T pass; a wider block
// (b = 512, or T 512's single step) takes its row max and sum chunk by
// chunk first and recomputes each chunk's scores to form p. The online
// update keeps p . v of the block apart and folds it in as
// acc (l_corr / l') + oc / l'. Chunks are 256 columns in the single step
// at hd 64, 128 in its online update and at hd 128, 64 in the online
// update at hd 128: what fits in 255 registers with no spill. 1 / l is
// rounded once a row and multiplied (within an f32 ulp of the reference's
// p / l; one IEEE division an element took half the kernel's time).
//
// Tensor-core dK/dV (attn_bwd_dkv_tc_kernel). A block (one warpgroup)
// owns a 64-row K/V tile, held in SW128 panels, and walks the q tiles
// from the diagonal to T, each tile's Q, dO, m, l and di through a
// two-stage cp.async ring (1 / l taken once a row there). Per q tile:
// S^T = K . Q^T and dP^T = V . dO^T (shared-shared wgmma n64); P^T and
// dS^T in registers, in the plain version's order, each rounded to bf16
// as the A operand of dV += P^T . dO and dK += dS^T . Q (register-A
// wgmma, dO and Q MN-major from the same panels); dK and dV go out
// through shared memory, 16 bytes a thread.
//
// Tensor-core dQ (attn_bwd_dq_tc_kernel), the transpose of dK/dV. A
// block (one warpgroup) owns a 64-row q tile, Q and dO held in SW128
// panels and its rows' m, 1 / l and di in registers (a thread's two rows
// for the whole walk; 1 / l taken once a row), the tiles with most work
// first, and walks the K/V tiles from 0 to the diagonal through a
// two-stage cp.async ring. Per K/V tile: S = Q . K^T and dP = dO . V^T
// (shared-shared wgmma n64, two groups: p is taken while dP's products
// run); dS in registers, in the plain version's order, rounded to bf16
// as the A operand of dQ += dS . K (register-A wgmma, K MN-major from
// the same panel); dQ goes out through shared memory, 16 bytes a thread.
// 168 registers at hd 64 (three blocks an SM), 222 at hd 128.
//
// FMA design (the first kernels): one block of 256 threads per
// (batch * head, 64-row tile); the tiles it multiplies staged in shared
// memory as f32 (the bf16 products are exact in f32, so the sums are
// the reference's f32 sums of exact products, in another order); f32
// accumulators and the softmax statistics in registers. A thread holds
// 4 rows x 4 columns of a 64 x 64 score tile (rows ty + 16 i, columns
// tx + 16 j) and 4 rows x hd/16 consecutive columns of an output tile;
// a row's max and sum cross its 16 threads by shuffles. The products
// are scalar FMAs from shared memory, with 16-byte loads. The forward
// walks the K blocks and, inside each, takes the block's row max and sum
// over 64-column tiles (pass 1), then recomputes the scores and forms p
// against the block's m' (pass 2); the sum of a block is taken against
// the running max of its tiles and rescaled, so l differs from the
// reference's by f32 rounding only.
//
// Bound at the GPT-2 round's shape (64 sequences x 12 heads x T 256 x
// hd 64, bf16), by bytes: the forward reads q, k, v and writes o (and
// m, l): 100.7 MB, 0.0305 ms at 3.35 TB/s against 6.4 GFLOP of causal
// products, 0.0065 ms at 989 TFLOP/s; dK/dV reads q, k, v, do, m, l, di
// and writes dk, dv: 0.0458 ms; dQ reads q, k, v, do, m, l, di and
// writes dq: 0.0383 ms. At T 1024 (8 x 12 heads) the forward is bound by
// bytes (0.0153 ms), dK/dV and dQ by operations (0.0261 ms, 0.0196 ms:
// four and three causal products of 2 hd flops a score entry). The
// tensor-core kernels run at a small share of those bounds: each block
// is one warpgroup that waits on its own copies and products in turn,
// with two blocks an SM at 216-255 registers (dQ three at 168); the
// exact exp of every score is a large part of the forward's time. The
// FMA kernels run their products at 67 TFLOP/s f32, far off the byte
// bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int TILE = 64;          // rows of a q tile and of a k/v tile
constexpr int THREADS = 256;      // 16 x 16
constexpr int SLD = TILE + 4;     // row stride of a 64-column score tile
// -0.7 * FLT_MAX, the library's DEFAULT_MASK_VALUE
constexpr float MASK_VALUE = (float)(-0.7 * 3.4028234663852886e38);

struct Strides {
  long long b, h, t;
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

// x rounded to the element type and back: the reference's
// p.astype(v.dtype) / ds.astype(k.dtype) before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Copies a 64 x HD tile (rows row0.., of head (b, h)) of a strided
// tensor into shared memory as f32, row stride HD + 4, 16 bytes a load.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          Strides s, int b, int h,
                                          int row0) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  const T* base = src + b * s.b + h * s.h;
  for (int idx = threadIdx.x; idx < TILE * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        base + (long long)(row0 + r) * s.t + c);
    const T* vals = reinterpret_cast<const T*>(&raw);
    float* d = dst + r * (HD + 4) + c;
#pragma unroll
    for (int e = 0; e < VEC; ++e) d[e] = to_f<T>(vals[e]);
  }
}

// N consecutive floats from 16-byte-aligned (N = 4, 8) or 8-byte-aligned
// (N = 2) shared memory
template <int N>
__device__ __forceinline__ void lds(float (&out)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + e);
      out[e] = x.x; out[e + 1] = x.y; out[e + 2] = x.z; out[e + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = p[e];
  }
}

// acc[i][j] += A[ty + 16 i] . B[tx + 16 j] over HD (f32 rows in shared
// memory, stride HD + 4): a 4 x 4 piece of a 64 x 64 product A . B^T
template <int HD>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int LD = HD + 4;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bb[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, bb[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, bb[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, bb[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, bb[j].w, acc[i][j]);
      }
  }
}

// out[i][e] += sum_c P[rows[i]][c] * V[c][tx * DPT + e] over the 64
// columns of a score tile P (stride SLD) and the rows of V (stride
// HD + 4); rows[i] = ty + 16 i, or (transposed) P[c][ty + 16 i] when
// TRANS.
template <int HD, bool TRANS>
__device__ __forceinline__ void pv_tile(float (&out)[4][HD / 16],
                                        const float* P, const float* V,
                                        int ty, int tx) {
  constexpr int DPT = HD / 16;
  constexpr int LD = HD + 4;
#pragma unroll 4
  for (int c = 0; c < TILE; ++c) {
    float vv[DPT];
    lds<DPT>(vv, V + c * LD + tx * DPT);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = TRANS ? P[c * SLD + ty + 16 * i]
                            : P[(ty + 16 * i) * SLD + c];
#pragma unroll
      for (int e = 0; e < DPT; ++e) out[i][e] = fmaf(p, vv[e], out[i][e]);
    }
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

// the reference's masked score: s * scale, + MASK where col > row
__device__ __forceinline__ float masked(float dot, float scale, int row,
                                        int col) {
  const float s = dot * scale;
  return col > row ? s + MASK_VALUE : s + 0.0f;
}

template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* dst, Strides s, int b, int h,
                                           int row0, int ty, int tx,
                                           const float (&acc)[4][HD / 16]) {
  constexpr int DPT = HD / 16;
  T* base = dst + b * s.b + h * s.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* row = base + (long long)(row0 + ty + 16 * i) * s.t + tx * DPT;
#pragma unroll
    for (int e = 0; e < DPT; ++e) row[e] = from_f<T>(acc[i][e]);
  }
}

// ---------------------------------------------------------------------
// Forward: grid (T / 64 q tiles, B * H). Shared: Q, K, V (64 x HD + 4
// f32 each) and P (64 x 68 f32).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int H, int Tn, int blk, float scale, Strides qs,
                    Strides ks, Strides vs, Strides os) {
  constexpr int DPT = HD / 16;
  constexpr int LD = HD + 4;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + TILE * LD;
  float* sV = sK + TILE * LD;
  float* sP = sV + TILE * LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * TILE;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const bool single = blk == Tn;
  const int q_last = q0 + TILE - 1;

  load_tile<T, HD>(sQ, q, qs, b, h, q0);

  float m_prev[4], l_prev[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_prev[i] = -INFINITY;
    l_prev[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.0f;
  }

  // the reference's K blocks on or below the diagonal of this tile's
  // q block; inside a block, the 64-column tiles not wholly above it
  const int n_blocks = q0 / blk + 1;
  for (int kb = 0; kb < n_blocks; ++kb) {
    const int k_begin = kb * blk;
    const int k_end = min(k_begin + blk, q_last + 1);

    // pass 1: the block's row max and its sum against that max
    float mb[4], lb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) { mb[i] = -INFINITY; lb[i] = 0.0f; }
    for (int k0 = k_begin; k0 < k_end; k0 += TILE) {
      __syncthreads();
      load_tile<T, HD>(sK, k, ks, b, h, k0);
      __syncthreads();
      float s[4][4] = {};
      dot_tile<HD>(s, sQ, sK, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = masked(s[i][j], scale, row, k0 + tx + 16 * j);
          tmax = fmaxf(tmax, s[i][j]);
        }
        tmax = row_max16(tmax);
        const float mn = fmaxf(mb[i], tmax);
        float ts = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) ts += expf(s[i][j] - mn);
        ts = row_sum16(ts);
        lb[i] = lb[i] * expf(mb[i] - mn) + ts;
        mb[i] = mn;
      }
    }

    float m_new[4], l_new[4], l_corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m_new[i] = fmaxf(m_prev[i], mb[i]);
      l_corr[i] = expf(m_prev[i] - m_new[i]) * l_prev[i];
      l_new[i] = lb[i] * expf(mb[i] - m_new[i]) + l_corr[i];
    }

    // pass 2: p against the block's max, cast, times V
    float oc[4][DPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < DPT; ++e) oc[i][e] = 0.0f;
    for (int k0 = k_begin; k0 < k_end; k0 += TILE) {
      __syncthreads();
      load_tile<T, HD>(sK, k, ks, b, h, k0);
      load_tile<T, HD>(sV, v, vs, b, h, k0);
      __syncthreads();
      float s[4][4] = {};
      dot_tile<HD>(s, sQ, sK, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p = expf(masked(s[i][j], scale, row, k0 + tx + 16 * j) -
                         m_new[i]);
          if (single) p = p / l_new[i];
          sP[(ty + 16 * i) * SLD + tx + 16 * j] = round_to<T>(p);
        }
      }
      __syncthreads();
      pv_tile<HD, false>(oc, sP, sV, ty, tx);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (single) {
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = oc[i][e];
      } else {
        const float inv = 1.0f / l_new[i];
        const float corr = l_corr[i] * inv;
#pragma unroll
        for (int e = 0; e < DPT; ++e)
          acc[i][e] = acc[i][e] * corr + oc[i][e] * inv;
      }
      m_prev[i] = m_new[i];
      l_prev[i] = l_new[i];
    }
  }

  store_rows<T, HD>(o, os, b, h, q0, ty, tx, acc);
  if (tx == 0) {
    const long long base = ((long long)blockIdx.y) * Tn + q0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m_out[base + ty + 16 * i] = m_prev[i];
      l_out[base + ty + 16 * i] = l_prev[i];
    }
  }
}

// p and ds of a 64 x 64 (q rows, k columns) tile from the staged Q, dO,
// K, V and the rows' m, 1 / l and di: p rounded to T into sP (when
// given), ds rounded to T into sDS
template <typename T, int HD>
__device__ __forceinline__ void p_ds_tile(float* sP, float* sDS,
                                          const float* sQ, const float* sDO,
                                          const float* sK, const float* sV,
                                          const float (&m)[4],
                                          const float (&linv)[4],
                                          const float (&di)[4], int q0,
                                          int k0, float scale, int ty,
                                          int tx) {
  float s[4][4] = {}, dp[4][4] = {};
  dot_tile<HD>(s, sQ, sK, ty, tx);
  dot_tile<HD>(dp, sDO, sV, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      const float p = expf(masked(s[i][j], scale, row, col) - m[i]) * linv[i];
      const float ds = ((dp[i][j] - di[i]) * p) * scale;
      const int at = (ty + 16 * i) * SLD + tx + 16 * j;
      if (sP != nullptr) sP[at] = round_to<T>(p);
      sDS[at] = round_to<T>(ds);
    }
  }
}

// ---------------------------------------------------------------------
// dK/dV: grid (T / 64 k tiles, B * H); a block owns its K/V tile and
// walks the q tiles on or below the diagonal. Shared: K, V, Q, dO
// (64 x HD + 4 f32 each), P and dS (64 x 68 f32), and m, 1 / l, di of
// the q tile.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ m,
                        const float* __restrict__ l,
                        const float* __restrict__ di, T* __restrict__ dk,
                        T* __restrict__ dv, int H, int Tn, float scale,
                        Strides qs, Strides ks, Strides vs, Strides dos,
                        Strides dks, Strides dvs) {
  constexpr int DPT = HD / 16;
  constexpr int LD = HD + 4;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + TILE * LD;
  float* sQ = sV + TILE * LD;
  float* sDO = sQ + TILE * LD;
  float* sP = sDO + TILE * LD;
  float* sDS = sP + TILE * SLD;
  float* sM = sDS + TILE * SLD;
  float* sLinv = sM + TILE;
  float* sDi = sLinv + TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * TILE;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long row_base = ((long long)blockIdx.y) * Tn;

  load_tile<T, HD>(sK, k, ks, b, h, k0);
  load_tile<T, HD>(sV, v, vs, b, h, k0);

  float dk_acc[4][DPT], dv_acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) { dk_acc[i][e] = 0.0f; dv_acc[i][e] = 0.0f; }

  for (int q0 = k0; q0 < Tn; q0 += TILE) {
    __syncthreads();
    load_tile<T, HD>(sQ, q, qs, b, h, q0);
    load_tile<T, HD>(sDO, dout, dos, b, h, q0);
    if (threadIdx.x < TILE) {
      sM[threadIdx.x] = m[row_base + q0 + threadIdx.x];
      sLinv[threadIdx.x] = 1.0f / l[row_base + q0 + threadIdx.x];
      sDi[threadIdx.x] = di[row_base + q0 + threadIdx.x];
    }
    __syncthreads();
    float mm[4], li[4], dd[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mm[i] = sM[ty + 16 * i];
      li[i] = sLinv[ty + 16 * i];
      dd[i] = sDi[ty + 16 * i];
    }
    p_ds_tile<T, HD>(sP, sDS, sQ, sDO, sK, sV, mm, li, dd, q0, k0, scale,
                     ty, tx);
    __syncthreads();
    // dv[c] += sum_r P[r][c] dO[r]; dk[c] += sum_r dS[r][c] Q[r], for the
    // k rows c = ty + 16 i this thread owns
    pv_tile<HD, true>(dv_acc, sP, sDO, ty, tx);
    pv_tile<HD, true>(dk_acc, sDS, sQ, ty, tx);
  }

  store_rows<T, HD>(dk, dks, b, h, k0, ty, tx, dk_acc);
  store_rows<T, HD>(dv, dvs, b, h, k0, ty, tx, dv_acc);
}

// ---------------------------------------------------------------------
// dQ: grid (T / 64 q tiles, B * H); a block owns its q tile and walks
// the k tiles on or below the diagonal. Shared: Q, dO, K, V (64 x HD + 4
// f32 each) and dS (64 x 68 f32).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ m,
                       const float* __restrict__ l,
                       const float* __restrict__ di, T* __restrict__ dq,
                       int H, int Tn, float scale, Strides qs, Strides ks,
                       Strides vs, Strides dos, Strides dqs) {
  constexpr int DPT = HD / 16;
  constexpr int LD = HD + 4;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + TILE * LD;
  float* sK = sDO + TILE * LD;
  float* sV = sK + TILE * LD;
  float* sDS = sV + TILE * LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * TILE;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long row_base = ((long long)blockIdx.y) * Tn + q0;

  load_tile<T, HD>(sQ, q, qs, b, h, q0);
  load_tile<T, HD>(sDO, dout, dos, b, h, q0);
  float mm[4], li[4], dd[4], dq_acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mm[i] = m[row_base + ty + 16 * i];
    li[i] = 1.0f / l[row_base + ty + 16 * i];
    dd[i] = di[row_base + ty + 16 * i];
#pragma unroll
    for (int e = 0; e < DPT; ++e) dq_acc[i][e] = 0.0f;
  }

  for (int k0 = 0; k0 <= q0; k0 += TILE) {
    __syncthreads();
    load_tile<T, HD>(sK, k, ks, b, h, k0);
    load_tile<T, HD>(sV, v, vs, b, h, k0);
    __syncthreads();
    p_ds_tile<T, HD>(nullptr, sDS, sQ, sDO, sK, sV, mm, li, dd, q0, k0,
                     scale, ty, tx);
    __syncthreads();
    pv_tile<HD, false>(dq_acc, sDS, sK, ty, tx);
  }

  store_rows<T, HD>(dq, dqs, b, h, q0, ty, tx, dq_acc);
}

// ---------------------------------------------------------------------
// The tensor-core design (bf16 at hd 64 and 128): one warpgroup (128
// threads) a block, operand tiles in SW128 panels (csrc/wgmma.cuh) filled
// by cp.async, products on wgmma with f32 accumulators in registers.
// Accumulator register i of thread t holds row rA + 8 ((i / 2) % 2) and
// column 8 (i / 4) + q2 + i % 2 of its tile (rA = 16 (t / 32) +
// (t % 32) / 4, q2 = 2 (t % 4)); registers 8 kk .. 8 kk + 7, packed to
// bf16 pairs in order, are the A operand of k step kk of the next product.

constexpr int TC_THREADS = 128;  // one warpgroup
constexpr int TC_STAGES = 2;  // tiles in the dK/dV (Q, dO) and dQ (K, V) rings

// score columns a forward step holds in registers (32 a thread for
// every 64), so that no instantiation spills: 256 in the single step at
// hd 64; 128 in its online update (a second output accumulator) and in
// the single step at hd 128 (output accumulators of 64 registers); 64 in
// the online update at hd 128
template <int HD, bool SINGLE>
__host__ __device__ constexpr int tc_chunk() {
  return HD == 64 ? (SINGLE ? 256 : 128) : (SINGLE ? 128 : 64);
}

// the first 1024-byte boundary at or after `raw` (shared memory)
__device__ __forceinline__ unsigned char* tc_align(unsigned char* raw) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  return raw + ((CET_SW128_ATOM - (a & (CET_SW128_ATOM - 1))) &
                (CET_SW128_ATOM - 1));
}

__device__ __forceinline__ uint32_t tc_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bf16 pair, the low column in the low half
__device__ __forceinline__ uint32_t tc_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the rows of head (b, h) of a strided tensor
template <typename T>
__device__ __forceinline__ T* head_rows(T* src, Strides s, int b, int h) {
  return src + b * s.b + h * s.h;
}

// rows [row0, row0 + n) of a head's bf16 rows (token stride st) into an
// SW128-panel tile of CAP rows; issues cp.async only
template <int CAP, int HD>
__device__ __forceinline__ void tc_load_rows(unsigned char* tile,
                                             const __nv_bfloat16* base,
                                             long long st, int row0, int n) {
  constexpr int CPR = HD / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < n * CPR; i += TC_THREADS) {
    const int r = i / CPR, ch = i % CPR;
    cp_async16(tile + cet_sw128_offset(r, ch, CAP),
               base + (long long)(row0 + r) * st + ch * 8, true);
  }
}

// A (64 x HD) K-major at `a` (panel stride 64 rows) times B^T, B (N x HD)
// K-major at `b` with panel stride BCAP rows: d = A . B^T over HD / 16
// k steps
template <int HD, int N, int BCAP>
__device__ __forceinline__ void tc_qk(float* d, uint32_t a, uint32_t b) {
  const uint64_t da = cet_sw128_desc(a, 16, CET_SW128_ATOM);
  const uint64_t db = cet_sw128_desc(b, 16, CET_SW128_ATOM);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    cet_wgmma_ss<N>(d, cet_desc_add(da, (kk >> 2) * 64 * 128 + (kk & 3) * 32),
                    cet_desc_add(db, (kk >> 2) * BCAP * 128 + (kk & 3) * 32),
                    kk > 0);
}

// ---------------------------------------------------------------------
// Forward (tensor cores). A q tile's work is a list of steps, one q . k^T
// product each over a chunk of at most tc_chunk() columns:
// - FUSED: a reference K block whose columns up to the diagonal fit in
//   one chunk: scores, the block's max and sum, p and p . v from the same
//   registers (the single step at T <= 256 at hd 64: one q . k^T pass);
// - STATS, then PV: a block wider than a chunk. The STATS steps take the
//   block's row max and sum chunk by chunk; the PV steps recompute each
//   chunk's scores and form p against the block's max (and, in the
//   single step, divided by its l) before the cast.
enum : int { STEP_FUSED = 0, STEP_STATS = 1, STEP_PV = 2 };

struct FwdPlan {
  int blk, ch, q_last, n_blocks, spf, total;
};

struct FwdStep {
  int k0, nt, kind;
  bool first_pv, last;  // the block's first PV step; its last step
};

__device__ __forceinline__ int fwd_steps_in(int width, int ch) {
  return width <= ch ? 1 : 2 * ((width + ch - 1) / ch);
}

__device__ __forceinline__ FwdPlan fwd_plan(int blk, int ch, int q0) {
  FwdPlan p;
  p.blk = blk;
  p.ch = ch;
  p.q_last = q0 + TILE - 1;
  p.n_blocks = q0 / blk + 1;
  p.spf = fwd_steps_in(blk, ch);
  p.total = (p.n_blocks - 1) * p.spf +
            fwd_steps_in(p.q_last + 1 - (p.n_blocks - 1) * blk, ch);
  return p;
}

__device__ __forceinline__ FwdStep fwd_step(const FwdPlan& p, int s) {
  const int kb = min(s / p.spf, p.n_blocks - 1);
  const int r = s - kb * p.spf;
  const int width = kb == p.n_blocks - 1 ? p.q_last + 1 - kb * p.blk : p.blk;
  const int n = fwd_steps_in(width, p.ch);
  FwdStep st;
  int c = 0;
  if (n == 1) {
    st.kind = STEP_FUSED;
    st.first_pv = st.last = true;
  } else {
    const int nch = n / 2;
    c = r % nch;
    st.kind = r < nch ? STEP_STATS : STEP_PV;
    st.first_pv = r == nch;
    st.last = r == n - 1;
  }
  st.k0 = kb * p.blk + c * p.ch;
  // the whole chunk up to the block's end, also past the diagonal (those
  // columns are masked to exact zeros): a tile count per block size, so
  // two step bodies at most
  st.nt = min(p.ch, p.blk - c * p.ch) / TILE;
  return st;
}

// the first step after s that multiplies by V (-1: none)
__device__ __forceinline__ int fwd_next_pv(const FwdPlan& p, int s) {
  for (++s; s < p.total; ++s)
    if (fwd_step(p, s).kind != STEP_STATS) return s;
  return -1;
}

// SINGLE: p . v goes straight into acc (one K block, divided by l
// before the cast); otherwise into oc, folded into acc at the block's end
template <int HD, bool SINGLE>
struct FwdState {
  float acc[HD / 2];                 // the output so far
  float oc[SINGLE ? 1 : HD / 2];     // (p cast) . v of the current K block
  float m_prev[2], l_prev[2];  // running max and sum of the thread's rows
  float mb[2], lb[2];          // the current block's (STATS steps)
  float m_new[2], l_new[2], l_corr[2];
};

struct FwdCtx {
  const __nv_bfloat16 *k, *v;  // head (b, h)'s rows
  long long kt, vt;            // their token strides
  FwdPlan plan;
  unsigned char *sK, *sV;
  uint32_t aQ, aK, aV;
  int q0, rA, q2;
  float scale;
};

template <int HD, bool SINGLE>
__device__ __forceinline__ void fwd_load_k(const FwdCtx& c, int s) {
  if (s < c.plan.total) {
    const FwdStep st = fwd_step(c.plan, s);
    tc_load_rows<tc_chunk<HD, SINGLE>(), HD>(c.sK, c.k, c.kt, st.k0,
                                             st.nt * TILE);
  }
  cp_async_commit();  // an empty group past the last keeps the count
}

template <int HD, bool SINGLE>
__device__ __forceinline__ void fwd_load_v(const FwdCtx& c, int s) {
  if (s >= 0) {
    const FwdStep st = fwd_step(c.plan, s);
    tc_load_rows<tc_chunk<HD, SINGLE>(), HD>(c.sV, c.v, c.vt, st.k0,
                                             st.nt * TILE);
  }
  cp_async_commit();
}

// Step s over NT 64-column tiles. Every step commits two cp.async groups,
// the next step's K chunk and then (after its p . v, or empty) the next
// PV step's V chunk, so "all but the newest group" is always the one
// waited for.
template <int HD, bool SINGLE, int NT>
__device__ __forceinline__ void fwd_step_body(const FwdCtx& c,
                                              FwdState<HD, SINGLE>& st,
                                              const FwdStep& step, int s,
                                              int& v_step) {
  constexpr int CH = tc_chunk<HD, SINGLE>();
  constexpr int NS = 32 * NT;  // score registers
  cp_async_wait_group<1>();  // this step's K (the V copy may still fly)
  cet_fence_proxy_async();
  __syncthreads();
  float sc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = 0.0f;
  cet_wgmma_fence();
  tc_qk<HD, 64 * NT, CH>(sc, c.aQ, c.aK);
  cet_wgmma_commit();
  cet_wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < NS; ++i) cet_fence_operand(sc[i]);
  __syncthreads();  // every warp's products are done with sK
  fwd_load_k<HD, SINGLE>(c, s + 1);

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int hr = (i >> 1) & 1;
    sc[i] = masked(sc[i], c.scale, c.q0 + c.rA + 8 * hr,
                   step.k0 + 8 * (i >> 2) + c.q2 + (i & 1));
    mx[hr] = fmaxf(mx[hr], sc[i]);
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);

  if (step.kind == STEP_STATS) {
    float sum[2] = {0.0f, 0.0f}, mn[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) mn[hr] = fmaxf(st.mb[hr], mx[hr]);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int hr = (i >> 1) & 1;
      sum[hr] += expf(sc[i] - mn[hr]);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      st.lb[hr] = st.lb[hr] * expf(st.mb[hr] - mn[hr]) + quad_sum(sum[hr]);
      st.mb[hr] = mn[hr];
    }
    cp_async_commit();  // no V this step
    return;
  }

  // the single step has one block: nothing before it (m = -inf, l = 0),
  // so m' is the block's max and l' its sum
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (step.kind == STEP_FUSED) {
      st.m_new[hr] = SINGLE ? mx[hr] : fmaxf(st.m_prev[hr], mx[hr]);
    } else if (step.first_pv) {
      if constexpr (SINGLE) {
        st.m_new[hr] = st.mb[hr];
        st.l_new[hr] = st.lb[hr];
      } else {
        st.m_new[hr] = fmaxf(st.m_prev[hr], st.mb[hr]);
        st.l_corr[hr] = expf(st.m_prev[hr] - st.m_new[hr]) * st.l_prev[hr];
        st.l_new[hr] =
            st.lb[hr] * expf(st.mb[hr] - st.m_new[hr]) + st.l_corr[hr];
      }
    }
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int hr = (i >> 1) & 1;
    sc[i] = expf(sc[i] - st.m_new[hr]);
    sum[hr] += sc[i];
  }
  if (step.kind == STEP_FUSED) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if constexpr (SINGLE) {
        st.l_new[hr] = quad_sum(sum[hr]);
      } else {
        st.l_corr[hr] = expf(st.m_prev[hr] - st.m_new[hr]) * st.l_prev[hr];
        st.l_new[hr] = quad_sum(sum[hr]) + st.l_corr[hr];
      }
    }
  }
  if constexpr (SINGLE) {
    // the single step casts p after p /= l, here p * (1 / l) with 1 / l
    // rounded once a row (within an f32 ulp of the division; one IEEE
    // division an element took half the kernel's time)
    const float linv[2] = {1.0f / st.l_new[0], 1.0f / st.l_new[1]};
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = sc[i] * linv[(i >> 1) & 1];
  }
  uint32_t pa[4 * NT][4];
#pragma unroll
  for (int kk = 0; kk < 4 * NT; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kk][j] = tc_pack(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);

  cp_async_wait_group<1>();  // this step's V (the next K may still fly)
  cet_fence_proxy_async();
  __syncthreads();
  float* out = SINGLE ? st.acc : st.oc;
  const uint64_t dv = cet_sw128_desc(c.aV, CH * 128, CET_SW128_ATOM);
  cet_wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NT; ++kk)
    cet_wgmma_rs_tb<HD>(out, pa[kk], cet_desc_add(dv, kk * 16 * 128));
  cet_wgmma_commit();
  cet_wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) cet_fence_operand(out[i]);
  __syncthreads();  // every warp's products are done with sV
  v_step = fwd_next_pv(c.plan, s);
  fwd_load_v<HD, SINGLE>(c, v_step);

  if (step.last) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if constexpr (!SINGLE) {
        const float inv = 1.0f / st.l_new[hr];
        const float corr = st.l_corr[hr] * inv;
#pragma unroll
        for (int i = 2 * hr; i < HD / 2; i += 4)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            st.acc[i + e] = st.acc[i + e] * corr + st.oc[i + e] * inv;
            st.oc[i + e] = 0.0f;
          }
      }
      if constexpr (!SINGLE) {
        st.m_prev[hr] = st.m_new[hr];
        st.l_prev[hr] = st.l_new[hr];
      }
      st.mb[hr] = -INFINITY;
      st.lb[hr] = 0.0f;
    }
  }
}

// the step body for the step's tile count: CH / 64, or 2 where a block
// of 128 columns is narrower than a chunk of 256 (a block-uniform
// branch: every thread takes the same one)
template <int HD, bool SINGLE>
__device__ __forceinline__ void fwd_dispatch(const FwdCtx& c,
                                             FwdState<HD, SINGLE>& st,
                                             const FwdStep& step, int s,
                                             int& v_step) {
  constexpr int NT = tc_chunk<HD, SINGLE>() / TILE;
  if constexpr (NT > 2) {
    if (step.nt == 2) {
      fwd_step_body<HD, SINGLE, 2>(c, st, step, s, v_step);
      return;
    }
  }
  fwd_step_body<HD, SINGLE, NT>(c, st, step, s, v_step);
}

// grid (T / 64 q tiles, B * H), the q tiles with most work first.
// Shared: Q (64 x HD), a K chunk and a V chunk (tc_chunk() x HD each),
// SW128 panels. SINGLE: blk == T.
template <int HD, bool SINGLE>
__global__ void __launch_bounds__(TC_THREADS, 1)
    attn_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       int H, int Tn, int blk, float scale, Strides qs,
                       Strides ks, Strides vs, Strides os) {
  constexpr int CH = tc_chunk<HD, SINGLE>();
  extern __shared__ unsigned char tc_smem_raw[];
  unsigned char* sQ = tc_align(tc_smem_raw);
  unsigned char* sK = sQ + TILE * HD * 2;
  unsigned char* sV = sK + CH * HD * 2;
  const int t = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int b = blockIdx.y / H, h = blockIdx.y % H;

  FwdCtx c;
  c.k = head_rows(k, ks, b, h);
  c.v = head_rows(v, vs, b, h);
  c.kt = ks.t;
  c.vt = vs.t;
  c.plan = fwd_plan(blk, CH, q0);
  c.sK = sK;
  c.sV = sV;
  c.aQ = tc_addr(sQ);
  c.aK = tc_addr(sK);
  c.aV = tc_addr(sV);
  c.q0 = q0;
  c.rA = 16 * (t >> 5) + ((t & 31) >> 2);
  c.q2 = 2 * (t & 3);
  c.scale = scale;

  tc_load_rows<TILE, HD>(sQ, head_rows(q, qs, b, h), qs.t, q0, TILE);
  fwd_load_k<HD, SINGLE>(c, 0);  // one group: Q and step 0's K
  int v_step = fwd_next_pv(c.plan, -1);
  fwd_load_v<HD, SINGLE>(c, v_step);

  FwdState<HD, SINGLE> st;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) st.acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (SINGLE ? 1 : HD / 2); ++i) st.oc[i] = 0.0f;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    st.m_prev[hr] = st.mb[hr] = -INFINITY;
    st.l_prev[hr] = st.lb[hr] = 0.0f;
    st.m_new[hr] = st.l_new[hr] = st.l_corr[hr] = 0.0f;
  }
  for (int s = 0; s < c.plan.total; ++s) {
    const FwdStep step = fwd_step(c.plan, s);
    fwd_dispatch<HD, SINGLE>(c, st, step, s, v_step);
  }

  // o through shared memory (row stride HD + 8), 16 bytes a thread
  cp_async_wait_group0();
  __syncthreads();
  constexpr int LDS = HD + 8;
  __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(sK);
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(
        stg + (c.rA + 8 * ((i >> 1) & 1)) * LDS + 8 * (i >> 2) + c.q2) =
        __floats2bfloat162_rn(st.acc[i], st.acc[i + 1]);
  __syncthreads();
  __nv_bfloat16* obase = o + b * os.b + h * os.h;
  for (int i = t; i < TILE * (HD / 8); i += TC_THREADS) {
    const int r = i / (HD / 8), ch = i % (HD / 8);
    *reinterpret_cast<uint4*>(obase + (long long)(q0 + r) * os.t + ch * 8) =
        *reinterpret_cast<const uint4*>(stg + r * LDS + ch * 8);
  }
  if ((t & 3) == 0) {
    const long long base = ((long long)blockIdx.y) * Tn + q0 + c.rA;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m_out[base + 8 * hr] = SINGLE ? st.m_new[hr] : st.m_prev[hr];
      l_out[base + 8 * hr] = SINGLE ? st.l_new[hr] : st.l_prev[hr];
    }
  }
}

// ---------------------------------------------------------------------
// dK/dV (tensor cores): grid (T / 64 k tiles, B * H); a block owns its
// K/V tile and walks the q tiles from the diagonal to T, each tile's Q,
// dO and m, l, di through a two-stage cp.async ring. Per q tile:
// S^T = K . Q^T and dP^T = V . dO^T (wgmma, both K-major from shared
// memory); P^T and dS^T in registers, rounded to bf16 as the next
// products' A operands; dV += P^T . dO and dK += dS^T . Q (wgmma, dO and
// Q MN-major from the same tiles).
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
    attn_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ m,
                           const float* __restrict__ l,
                           const float* __restrict__ di,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int Tn,
                           float scale, Strides qs, Strides ks, Strides vs,
                           Strides dos, Strides dks, Strides dvs) {
  constexpr int TB = TILE * HD * 2;  // bytes of a 64-row tile
  extern __shared__ unsigned char tc_smem_raw[];
  unsigned char* sK = tc_align(tc_smem_raw);
  unsigned char* sV = sK + TB;
  unsigned char* ring = sV + TB;  // stage j: Q, then dO
  float* stats = reinterpret_cast<float*>(ring + TC_STAGES * 2 * TB);
  const int t = threadIdx.x;
  const int k0 = blockIdx.x * TILE;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long row_base = ((long long)blockIdx.y) * Tn;
  const int n_q = (Tn - k0) / TILE;
  const int rA = 16 * (t >> 5) + ((t & 31) >> 2), q2 = 2 * (t & 3);
  const __nv_bfloat16* qb = head_rows(q, qs, b, h);
  const __nv_bfloat16* dob = head_rows(dout, dos, b, h);

  // q tile j (rows k0 + 64 j ..) into stage j % 2: Q, dO, and m, l, di as
  // three arrays of 64 f32
  auto load_q = [&](int j) {
    if (j < n_q) {
      const int q0 = k0 + j * TILE;
      unsigned char* st = ring + (j % TC_STAGES) * 2 * TB;
      tc_load_rows<TILE, HD>(st, qb, qs.t, q0, TILE);
      tc_load_rows<TILE, HD>(st + TB, dob, dos.t, q0, TILE);
      if (t < 48) {
        const float* src = t < 16 ? m : t < 32 ? l : di;
        cp_async16(stats + (j % TC_STAGES) * 3 * TILE + 4 * t,
                   src + row_base + q0 + 4 * (t & 15), true);
      }
    }
    cp_async_commit();
  };
  tc_load_rows<TILE, HD>(sK, head_rows(k, ks, b, h), ks.t, k0, TILE);
  tc_load_rows<TILE, HD>(sV, head_rows(v, vs, b, h), vs.t, k0, TILE);
  load_q(0);  // one group: K, V and q tile 0
  load_q(1);

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  const uint32_t aK = tc_addr(sK), aV = tc_addr(sV);
  const int krow[2] = {k0 + rA, k0 + rA + 8};

  for (int j = 0; j < n_q; ++j) {
    cp_async_wait_group<1>();  // q tile j (tile j + 1 may still fly)
    cet_fence_proxy_async();
    __syncthreads();
    const int q0 = k0 + j * TILE;
    const uint32_t aQ = tc_addr(ring + (j % TC_STAGES) * 2 * TB);
    const uint32_t aDO = aQ + TB;
    float* sM = stats + (j % TC_STAGES) * 3 * TILE;
    // 1 / l once a row, as the plain version takes it
    if (t < TILE) sM[TILE + t] = 1.0f / sM[TILE + t];
    __syncthreads();

    float s_t[32], dp_t[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s_t[i] = dp_t[i] = 0.0f;
    cet_wgmma_fence();
    tc_qk<HD, 64, TILE>(s_t, aK, aQ);
    tc_qk<HD, 64, TILE>(dp_t, aV, aDO);
    cet_wgmma_commit();
    cet_wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      cet_fence_operand(s_t[i]);
      cet_fence_operand(dp_t[i]);
    }

    // p and ds of k row krow[(i / 2) % 2], q column q0 + qc; the rows'
    // statistics for the thread's 16 columns, two at a time
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int cp = 0; cp < 8; ++cp) {
      const int qc = 8 * cp + q2;
      const float2 mm = *reinterpret_cast<const float2*>(sM + qc);
      const float2 ll = *reinterpret_cast<const float2*>(sM + TILE + qc);
      const float2 dd = *reinterpret_cast<const float2*>(sM + 2 * TILE + qc);
      const float mv[2] = {mm.x, mm.y}, li[2] = {ll.x, ll.y};
      const float dv2[2] = {dd.x, dd.y};
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * cp + e, c2 = e & 1;
        const float p = expf(masked(s_t[i], scale, q0 + qc + c2,
                                    krow[(e >> 1) & 1]) -
                             mv[c2]) *
                        li[c2];
        pv[e] = p;
        dsv[e] = ((dp_t[i] - dv2[c2]) * p) * scale;
      }
      // accumulator registers 4 cp .. 4 cp + 3: k step cp / 2, pairs
      // (row rA, row rA + 8) of its low (cp even) or high half
      pa[cp >> 1][2 * (cp & 1)] = tc_pack(pv[0], pv[1]);
      pa[cp >> 1][2 * (cp & 1) + 1] = tc_pack(pv[2], pv[3]);
      da[cp >> 1][2 * (cp & 1)] = tc_pack(dsv[0], dsv[1]);
      da[cp >> 1][2 * (cp & 1) + 1] = tc_pack(dsv[2], dsv[3]);
    }

    const uint64_t d_do = cet_sw128_desc(aDO, TILE * 128, CET_SW128_ATOM);
    const uint64_t d_q = cet_sw128_desc(aQ, TILE * 128, CET_SW128_ATOM);
    cet_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      cet_wgmma_rs_tb<HD>(dv_acc, pa[kk], cet_desc_add(d_do, kk * 16 * 128));
      cet_wgmma_rs_tb<HD>(dk_acc, da[kk], cet_desc_add(d_q, kk * 16 * 128));
    }
    cet_wgmma_commit();
    cet_wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      cet_fence_operand(dv_acc[i]);
      cet_fence_operand(dk_acc[i]);
    }
    __syncthreads();  // every warp is done with stage j % 2
    load_q(j + 2);
  }

  // dK and dV through shared memory (row stride HD + 8), 16 bytes a
  // thread
  cp_async_wait_group0();
  __syncthreads();
  constexpr int LDS = HD + 8;
  __nv_bfloat16* stg_k = reinterpret_cast<__nv_bfloat16*>(ring);
  __nv_bfloat16* stg_v = reinterpret_cast<__nv_bfloat16*>(ring + 2 * TB);
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int at = (rA + 8 * ((i >> 1) & 1)) * LDS + 8 * (i >> 2) + q2;
    *reinterpret_cast<__nv_bfloat162*>(stg_k + at) =
        __floats2bfloat162_rn(dk_acc[i], dk_acc[i + 1]);
    *reinterpret_cast<__nv_bfloat162*>(stg_v + at) =
        __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
  }
  __syncthreads();
  __nv_bfloat16* kbase = head_rows(dk, dks, b, h);
  __nv_bfloat16* vbase = head_rows(dv, dvs, b, h);
  for (int i = t; i < TILE * (HD / 8); i += TC_THREADS) {
    const int r = i / (HD / 8), ch = i % (HD / 8);
    *reinterpret_cast<uint4*>(kbase + (long long)(k0 + r) * dks.t + ch * 8) =
        *reinterpret_cast<const uint4*>(stg_k + r * LDS + ch * 8);
    *reinterpret_cast<uint4*>(vbase + (long long)(k0 + r) * dvs.t + ch * 8) =
        *reinterpret_cast<const uint4*>(stg_v + r * LDS + ch * 8);
  }
}

// ---------------------------------------------------------------------
// dQ (tensor cores): grid (T / 64 q tiles, B * H), the q tiles with most
// work first; a block owns its q tile and walks the K/V tiles from 0 to
// the diagonal, each tile's K and V through a two-stage cp.async ring.
// Per K/V tile: S = Q . K^T and dP = dO . V^T (wgmma, both K-major from
// shared memory); dS in registers, rounded to bf16 as the A operand of
// dQ += dS . K (wgmma, K MN-major from the same tile). The accumulators'
// rows are the thread's two q rows, so m, 1 / l and di are two
// constants a thread; a column is a key. Compiled for three blocks an SM
// at hd 64 (no spill there; uncapped, ptxas fits two, which timed
// slower); at hd 128 that cap spills.
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, HD == 64 ? 3 : 1)
    attn_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ m,
                          const float* __restrict__ l,
                          const float* __restrict__ di,
                          __nv_bfloat16* __restrict__ dq, int H, int Tn,
                          float scale, Strides qs, Strides ks, Strides vs,
                          Strides dos, Strides dqs) {
  constexpr int TB = TILE * HD * 2;  // bytes of a 64-row tile
  extern __shared__ unsigned char tc_smem_raw[];
  unsigned char* sQ = tc_align(tc_smem_raw);
  unsigned char* sDO = sQ + TB;
  unsigned char* ring = sDO + TB;  // stage j: K, then V
  const int t = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n_k = q0 / TILE + 1;
  const int rA = 16 * (t >> 5) + ((t & 31) >> 2), q2 = 2 * (t & 3);
  const __nv_bfloat16* kb = head_rows(k, ks, b, h);
  const __nv_bfloat16* vb = head_rows(v, vs, b, h);

  // K/V tile j (rows 64 j ..) into stage j % 2
  auto load_k = [&](int j) {
    if (j < n_k) {
      unsigned char* st = ring + (j % TC_STAGES) * 2 * TB;
      tc_load_rows<TILE, HD>(st, kb, ks.t, j * TILE, TILE);
      tc_load_rows<TILE, HD>(st + TB, vb, vs.t, j * TILE, TILE);
    }
    cp_async_commit();
  };
  tc_load_rows<TILE, HD>(sQ, head_rows(q, qs, b, h), qs.t, q0, TILE);
  tc_load_rows<TILE, HD>(sDO, head_rows(dout, dos, b, h), dos.t, q0, TILE);
  load_k(0);  // one group: Q, dO and K/V tile 0
  load_k(1);

  // the thread's rows q0 + rA and q0 + rA + 8: m, 1 / l (once a row, as
  // the plain version takes it) and di
  const long long at = ((long long)blockIdx.y) * Tn + q0 + rA;
  const int qrow[2] = {q0 + rA, q0 + rA + 8};
  float mv[2], li[2], dd[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mv[hr] = m[at + 8 * hr];
    li[hr] = 1.0f / l[at + 8 * hr];
    dd[hr] = di[at + 8 * hr];
  }
  float dq_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.0f;
  const uint32_t aQ = tc_addr(sQ), aDO = tc_addr(sDO);

  for (int j = 0; j < n_k; ++j) {
    cp_async_wait_group<1>();  // K/V tile j (tile j + 1 may still fly)
    cet_fence_proxy_async();
    __syncthreads();
    const int k0 = j * TILE;
    const uint32_t aK = tc_addr(ring + (j % TC_STAGES) * 2 * TB);
    const uint32_t aV = aK + TB;

    // S and dP as two groups: p is taken while dP's products run
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    cet_wgmma_fence();
    tc_qk<HD, 64, TILE>(s, aQ, aK);
    cet_wgmma_commit();
    tc_qk<HD, 64, TILE>(dp, aDO, aV);
    cet_wgmma_commit();
    cet_wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < 32; ++i) cet_fence_operand(s[i]);
    // p of q row qrow[(i / 2) % 2], key k0 + 8 (i / 4) + q2 + i % 2
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hr = (i >> 1) & 1;
      s[i] = expf(masked(s[i], scale, qrow[hr],
                         k0 + 8 * (i >> 2) + q2 + (i & 1)) -
                  mv[hr]) *
             li[hr];
    }
    cet_wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) cet_fence_operand(dp[i]);
    // ds; registers 8 kk .. 8 kk + 7, packed in pairs, are k step kk's A
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int hr = jj & 1, i = 8 * kk + 2 * jj;
        da[kk][jj] = tc_pack(((dp[i] - dd[hr]) * s[i]) * scale,
                             ((dp[i + 1] - dd[hr]) * s[i + 1]) * scale);
      }

    const uint64_t d_k = cet_sw128_desc(aK, TILE * 128, CET_SW128_ATOM);
    cet_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      cet_wgmma_rs_tb<HD>(dq_acc, da[kk], cet_desc_add(d_k, kk * 16 * 128));
    cet_wgmma_commit();
    cet_wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) cet_fence_operand(dq_acc[i]);
    __syncthreads();  // every warp is done with stage j % 2
    load_k(j + 2);
  }

  // dQ through shared memory (row stride HD + 8), 16 bytes a thread
  cp_async_wait_group0();
  __syncthreads();
  constexpr int LDS = HD + 8;
  __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(ring);
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(
        stg + (rA + 8 * ((i >> 1) & 1)) * LDS + 8 * (i >> 2) + q2) =
        __floats2bfloat162_rn(dq_acc[i], dq_acc[i + 1]);
  __syncthreads();
  __nv_bfloat16* qbase = head_rows(dq, dqs, b, h);
  for (int i = t; i < TILE * (HD / 8); i += TC_THREADS) {
    const int r = i / (HD / 8), ch = i % (HD / 8);
    *reinterpret_cast<uint4*>(qbase + (long long)(q0 + r) * dqs.t + ch * 8) =
        *reinterpret_cast<const uint4*>(stg + r * LDS + ch * 8);
  }
}

inline Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * TILE * (HD + 4) + TILE * SLD);
}
template <int HD>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * TILE * (HD + 4) + 2 * TILE * SLD + 3 * TILE);
}
template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * TILE * (HD + 4) + TILE * SLD);
}

// the instantiations that run the tensor-core design (the rest run the
// FMA kernels: f32, whose results a bf16 or TF32 product would change,
// and bf16 at hd 16 and 32, narrower than a 64-column SW128 panel)
template <typename T, int HD>
constexpr bool tc_design() {
  return sizeof(T) == 2 && (HD == 64 || HD == 128);
}
template <int HD, bool SINGLE>
constexpr size_t fwd_tc_smem() {
  return CET_SW128_ATOM +
         (size_t)(TILE + 2 * tc_chunk<HD, SINGLE>()) * HD * 2;
}
template <int HD, bool SINGLE>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          void* o, float* m, float* l, int B, int H, int Tn,
                          int blk, float scale, const long long* st,
                          cudaStream_t stream) {
  constexpr size_t smem = fwd_tc_smem<HD, SINGLE>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_tc_kernel<HD, SINGLE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Tn / TILE, B * H);
  attn_fwd_tc_kernel<HD, SINGLE><<<grid, TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, m, l, H, Tn, blk, scale,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3));
  return cudaGetLastError();
}
template <int HD>
constexpr size_t dkv_tc_smem() {
  return CET_SW128_ATOM + (size_t)(2 + 2 * TC_STAGES) * TILE * HD * 2 +
         TC_STAGES * 3 * TILE * sizeof(float);
}
template <int HD>
constexpr size_t dq_tc_smem() {
  return CET_SW128_ATOM + (size_t)(2 + 2 * TC_STAGES) * TILE * HD * 2;
}

template <typename T, int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* m, float* l, int B, int H, int Tn, int blk,
                       float scale, const long long* st,
                       cudaStream_t stream) {
  if constexpr (tc_design<T, HD>()) {
    return blk == Tn ? launch_fwd_tc<HD, true>(q, k, v, o, m, l, B, H, Tn,
                                               blk, scale, st, stream)
                     : launch_fwd_tc<HD, false>(q, k, v, o, m, l, B, H, Tn,
                                                blk, scale, st, stream);
  } else {
    constexpr size_t smem = fwd_smem<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(Tn / TILE, B * H);
    attn_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, m, l, H, Tn, blk,
        scale, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
        strides_at(st, 3));
    return cudaGetLastError();
  }
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* m, const float* l,
                       const float* di, void* dk, void* dv, int B, int H,
                       int Tn, float scale, const long long* st,
                       cudaStream_t stream) {
  const dim3 grid(Tn / TILE, B * H);
  if constexpr (tc_design<T, HD>()) {
    constexpr size_t smem = dkv_tc_smem<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_dkv_tc_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attn_bwd_dkv_tc_kernel<HD><<<grid, TC_THREADS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, m, l, di,
        (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H, Tn, scale,
        strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
        strides_at(st, 3), strides_at(st, 4), strides_at(st, 5));
    return cudaGetLastError();
  } else {
    constexpr size_t smem = dkv_smem<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_dkv_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attn_bwd_dkv_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, m, l, di,
        (T*)dk, (T*)dv, H, Tn, scale, strides_at(st, 0), strides_at(st, 1),
        strides_at(st, 2), strides_at(st, 3), strides_at(st, 4),
        strides_at(st, 5));
    return cudaGetLastError();
  }
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* m, const float* l,
                      const float* di, void* dq, int B, int H, int Tn,
                      float scale, const long long* st,
                      cudaStream_t stream) {
  const dim3 grid(Tn / TILE, B * H);
  if constexpr (tc_design<T, HD>()) {
    constexpr size_t smem = dq_tc_smem<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_dq_tc_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attn_bwd_dq_tc_kernel<HD><<<grid, TC_THREADS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, m, l, di,
        (__nv_bfloat16*)dq, H, Tn, scale, strides_at(st, 0),
        strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
        strides_at(st, 4));
    return cudaGetLastError();
  } else {
    constexpr size_t smem = dq_smem<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_dq_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attn_bwd_dq_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, m, l, di,
        (T*)dq, H, Tn, scale, strides_at(st, 0), strides_at(st, 1),
        strides_at(st, 2), strides_at(st, 3), strides_at(st, 4));
    return cudaGetLastError();
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 128}. The
// wrapper (ops/attention_kernels.py) checks shapes, strides, alignment
// and T % 128 == 0 before it calls; an unknown (dtype, hd) returns
// cudaErrorInvalidValue.
#define CET_ATTN_DISPATCH(CALL)                                        \
  switch (dtype * 1000 + hd) {                                         \
    case 16: return (int)CALL(float, 16);                              \
    case 32: return (int)CALL(float, 32);                              \
    case 64: return (int)CALL(float, 64);                              \
    case 128: return (int)CALL(float, 128);                            \
    case 1016: return (int)CALL(__nv_bfloat16, 16);                    \
    case 1032: return (int)CALL(__nv_bfloat16, 32);                    \
    case 1064: return (int)CALL(__nv_bfloat16, 64);                    \
    case 1128: return (int)CALL(__nv_bfloat16, 128);                   \
    default: return (int)cudaErrorInvalidValue;                        \
  }

// strides: q, k, v, o (3 each: batch, head, token), in elements
extern "C" int cet_attn_fwd(const void* q, const void* k, const void* v,
                            void* o, float* m, float* l, int dtype, int hd,
                            int B, int H, int Tn, int blk, float scale,
                            const long long* strides, void* stream) {
#define CET_FWD(TT, HH)                                                 \
  launch_fwd<TT, HH>(q, k, v, o, m, l, B, H, Tn, blk, scale, strides, \
                     (cudaStream_t)stream)
  CET_ATTN_DISPATCH(CET_FWD)
#undef CET_FWD
}

// strides: q, k, v, do, dk, dv
extern "C" int cet_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* m,
                                const float* l, const float* di, void* dk,
                                void* dv, int dtype, int hd, int B, int H,
                                int Tn, float scale,
                                const long long* strides, void* stream) {
#define CET_DKV(TT, HH)                                                   \
  launch_dkv<TT, HH>(q, k, v, dout, m, l, di, dk, dv, B, H, Tn, scale,  \
                     strides, (cudaStream_t)stream)
  CET_ATTN_DISPATCH(CET_DKV)
#undef CET_DKV
}

// strides: q, k, v, do, dq
extern "C" int cet_attn_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* m,
                               const float* l, const float* di, void* dq,
                               int dtype, int hd, int B, int H, int Tn,
                               float scale, const long long* strides,
                               void* stream) {
#define CET_DQ(TT, HH)                                                     \
  launch_dq<TT, HH>(q, k, v, dout, m, l, di, dq, B, H, Tn, scale, strides, \
                    (cudaStream_t)stream)
  CET_ATTN_DISPATCH(CET_DQ)
#undef CET_DQ
}

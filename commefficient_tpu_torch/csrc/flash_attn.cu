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
// different scales, so this kernel keeps the reference's K blocking: it
// walks the K blocks of b columns and, inside each, first takes the
// block's row max and sum over 64-column tiles (pass 1), then recomputes
// the scores and forms p against the block's m' (pass 2). The sum of a
// block is taken against the running max of its tiles and rescaled, so
// l differs from the reference's by f32 rounding only.
//   Backward (:254-318, :796-940, :1146-1286): p = exp(s - m) * (1 / l),
// dv = (p cast)^T . do, dp = do . v^T, ds = ((dp - di) * p) * sm_scale,
// dk = (ds cast)^T . q, dq = (ds cast) . k, each f32 sums cast to the
// input type. di = sum(o * do) over the head dim is the reference's XLA
// code outside its kernels; here it stays a PyTorch reduction
// (ops/attention.py). The backward's numbers do not depend on its
// blocking. dK/dV and dQ are two kernels, each owning its outputs, so
// the backward is deterministic and uses no atomics.
//   A 64 x 64 tile that lies wholly above the diagonal contributes exact
// zeros in the reference (exp(MASK - m) = 0) and is skipped here.
//
// Layout: the kernels read q, k, v and do through strides (batch, head,
// token; the head dim is unit-stride), so the (B, T, H, hd) views the
// model cuts from its fused qkv projection go in without a transpose;
// they write o, dq, dk and dv with the strides they are given, and m and
// l as (B, H, T) f32.
//
// Design (the simple first kernel): one block of 256 threads per
// (batch * head, 64-row tile); the tiles it multiplies staged in shared
// memory as f32 (the bf16 products are exact in f32, so the sums are
// the reference's f32 sums of exact products, in another order); f32
// accumulators and the softmax statistics in registers. A thread holds
// 4 rows x 4 columns of a 64 x 64 score tile (rows ty + 16 i, columns
// tx + 16 j) and 4 rows x hd/16 consecutive columns of an output tile;
// a row's max and sum cross its 16 threads by shuffles. The products
// are scalar FMAs from shared memory, with 16-byte loads.
//   Bound at the GPT-2 round's shape (64 sequences x 12 heads x T 256 x
// hd 64, bf16), by bytes: the forward reads q, k, v and writes o (and
// m, l): 100.7 MB, 0.030 ms at 3.35 TB/s against 6.4 GFLOP of causal
// products, 0.0065 ms at 989 TFLOP/s. The backward reads q, k, v, do, m,
// l, di and writes dq, dk, dv. These kernels run their products on the
// FMA units (67 TFLOP/s f32), not the tensor cores, and the forward
// computes q . k^T twice: they are bounded by that arithmetic, far off
// the byte bound; a wgmma/TMA design is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <typename T, int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* m, float* l, int B, int H, int Tn, int blk,
                       float scale, const long long* st,
                       cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Tn / TILE, B * H);
  attn_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, m, l, H, Tn, blk, scale,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3));
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* m, const float* l,
                       const float* di, void* dk, void* dv, int B, int H,
                       int Tn, float scale, const long long* st,
                       cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Tn / TILE, B * H);
  attn_bwd_dkv_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, m, l, di,
      (T*)dk, (T*)dv, H, Tn, scale, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4),
      strides_at(st, 5));
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* m, const float* l,
                      const float* di, void* dq, int B, int H, int Tn,
                      float scale, const long long* st,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Tn / TILE, B * H);
  attn_bwd_dq_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, m, l, di,
      (T*)dq, H, Tn, scale, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4));
  return cudaGetLastError();
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

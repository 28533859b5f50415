// Hopper (sm_90a) warpgroup matrix products and the asynchronous copies
// that feed them, shared by the kernels of this directory.
//
// Shared-memory layout ("SW128 panels"). A tile of R rows x C bf16
// (C % 64 == 0) is stored as C / 64 panels of 64 columns, one after
// another (panel stride R * 128 bytes); inside a panel, row r takes
// 128 bytes at r * 128, and its eight 16-byte chunks are permuted by the
// 128-byte swizzle: chunk j lands at (j ^ (r % 8)) * 16. Every panel
// starts on a 1024-byte boundary. One such tile is both
// - a K-major operand (rows = M or N, columns = K): the descriptor's
//   start moves 32 bytes per 16-deep k step inside a panel and one
//   panel stride per 4 steps; SBO = 1024 (8 rows), LBO unused;
// - an MN-major operand (rows = K, columns = N): SBO = 1024 (8 k rows),
//   LBO = the panel stride (the next 64 columns of N).
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

constexpr int CET_SW128_ATOM = 1024;  // bytes of one 8-row swizzle atom

// byte offset of 16-byte chunk `ch` (of C / 8 in a row) of row `r` in an
// SW128-panel tile of `rows` rows
__device__ __forceinline__ uint32_t cet_sw128_offset(int r, int ch, int rows) {
  return (uint32_t)((ch >> 3) * rows * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4));
}

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t cet_sw128_desc(uint32_t smem_addr,
                                                   uint32_t lbo_bytes,
                                                   uint32_t sbo_bytes) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// a descriptor moved `bytes` further into shared memory (16-byte units
// in the start-address field)
__device__ __forceinline__ uint64_t cet_desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (uint64_t)(bytes >> 4);
}

__device__ __forceinline__ void cet_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cet_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cet_wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// waits until at most N of the warpgroup's committed wgmma groups are
// still in flight
template <int N>
__device__ __forceinline__ void cet_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving an accumulator register across a
// wgmma fence, commit or wait
__device__ __forceinline__ void cet_fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// makes this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) visible to the async proxy that wgmma reads through
__device__ __forceinline__ void cet_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes global -> shared, bypassing L1; valid == false zero-fills
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// 4 bytes global -> shared; valid == false zero-fills
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_group0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// waits until at most N of this thread's committed cp.async groups are
// still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of a row-major (nrows, C) bf16 matrix into an
// SW128-panel tile at `tile` (1024-byte aligned), by `nthreads` threads
// of which this is `tid`; rows past nrows read as zero. Issues cp.async
// only: the caller commits and waits.
template <int ROWS, int C>
__device__ __forceinline__ void cet_load_tile_sw128(unsigned char* tile,
                                                    const __nv_bfloat16* g,
                                                    long long row0,
                                                    long long nrows, int tid,
                                                    int nthreads) {
  constexpr int CPR = C / 8;  // 16-byte chunks per row
  for (int i = tid; i < ROWS * CPR; i += nthreads) {
    const int r = i / CPR, ch = i - r * CPR;
    const long long gr = row0 + r;
    const bool ok = gr < nrows;
    cp_async16(tile + cet_sw128_offset(r, ch, ROWS),
               g + (ok ? gr : 0) * (long long)C + ch * 8, ok);
  }
}

// rows [row0, row0 + ROWS) and columns [col0, col0 + 64) of a row-major
// bf16 matrix with `nrows` rows of `ld` elements into one SW128 panel of
// ROWS rows at `panel` (1024-byte aligned), by the NTHREADS threads of
// the block (this is `tid`); rows past nrows read as zero. Thread `tid`
// always copies 16-byte chunk tid % 8 of its rows. Issues cp.async only:
// the caller commits and waits.
template <int ROWS, int NTHREADS>
__device__ __forceinline__ void cet_load_chunk_sw128(unsigned char* panel,
                                                     const __nv_bfloat16* g,
                                                     long long row0,
                                                     long long nrows, int ld,
                                                     int col0, int tid) {
  static_assert(NTHREADS % 8 == 0 && (ROWS * 8) % NTHREADS == 0,
                "whole rows of 16-byte chunks per pass");
#pragma unroll
  for (int k = 0; k < ROWS * 8 / NTHREADS; ++k) {
    const int r = (tid >> 3) + k * (NTHREADS / 8), ch = tid & 7;
    const long long gr = row0 + r;
    const bool ok = gr < nrows;
    cp_async16(panel + cet_sw128_offset(r, ch, ROWS),
               g + (ok ? gr : 0) * (long long)ld + col0 + ch * 8, ok);
  }
}

#define CET_F8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D(64 x N) = A . B (+ D if accumulate), A (64 x 16) and B (N x 16)
// K-major in shared memory, N in {32, 64, 128, 192, 256}; N / 2
// accumulator registers a thread. Register i of thread t of the
// warpgroup holds row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (t % 4) + i % 2 (as for every m64nNk16 below).
template <int N>
__device__ __forceinline__ void cet_wgmma_ss(float* d, uint64_t da,
                                             uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void cet_wgmma_ss<32>(float* d, uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : CET_F8(0), CET_F8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void cet_wgmma_ss<64>(float* d, uint64_t da,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : CET_F8(0), CET_F8(8), CET_F8(16), CET_F8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void cet_wgmma_ss<128>(float* d, uint64_t da,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : CET_F8(0), CET_F8(8), CET_F8(16), CET_F8(24), CET_F8(32), CET_F8(40),
        CET_F8(48), CET_F8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void cet_wgmma_ss<192>(float* d, uint64_t da,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : CET_F8(0), CET_F8(8), CET_F8(16), CET_F8(24), CET_F8(32), CET_F8(40),
        CET_F8(48), CET_F8(56), CET_F8(64), CET_F8(72), CET_F8(80),
        CET_F8(88)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void cet_wgmma_ss<256>(float* d, uint64_t da,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : CET_F8(0), CET_F8(8), CET_F8(16), CET_F8(24), CET_F8(32), CET_F8(40),
        CET_F8(48), CET_F8(56), CET_F8(64), CET_F8(72), CET_F8(80),
        CET_F8(88), CET_F8(96), CET_F8(104), CET_F8(112), CET_F8(120)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x N) += A . B with A (64 x 16 bf16) in registers and B from
// shared memory MN-major (transpose bit set). A's four registers hold
// bf16 pairs, low half first: rows g and g + 8 (g = 16 (t / 32) +
// (t % 32) / 4), columns 2 (t % 4) + {0, 1} and 8 + 2 (t % 4) + {0, 1}:
// the layout of an m64n16 accumulator, in the order a0 = (g, lo),
// a1 = (g + 8, lo), a2 = (g, hi), a3 = (g + 8, hi).
template <int N>
__device__ __forceinline__ void cet_wgmma_rs_tb(float* d, const uint32_t* a,
                                                uint64_t db);

template <>
__device__ __forceinline__ void cet_wgmma_rs_tb<64>(float* d,
                                                     const uint32_t* a,
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : CET_F8(0), CET_F8(8), CET_F8(16), CET_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <>
__device__ __forceinline__ void cet_wgmma_rs_tb<128>(float* d,
                                                     const uint32_t* a,
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : CET_F8(0), CET_F8(8), CET_F8(16), CET_F8(24), CET_F8(32), CET_F8(40),
        CET_F8(48), CET_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <>
__device__ __forceinline__ void cet_wgmma_rs_tb<192>(float* d,
                                                     const uint32_t* a,
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : CET_F8(0), CET_F8(8), CET_F8(16), CET_F8(24), CET_F8(32), CET_F8(40),
        CET_F8(48), CET_F8(56), CET_F8(64), CET_F8(72), CET_F8(80),
        CET_F8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <>
__device__ __forceinline__ void cet_wgmma_rs_tb<256>(float* d,
                                                     const uint32_t* a,
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : CET_F8(0), CET_F8(8), CET_F8(16), CET_F8(24), CET_F8(32), CET_F8(40),
        CET_F8(48), CET_F8(56), CET_F8(64), CET_F8(72), CET_F8(80),
        CET_F8(88), CET_F8(96), CET_F8(104), CET_F8(112), CET_F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

#undef CET_F8

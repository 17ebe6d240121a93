// Hopper (sm_90a) building blocks shared by the tensor-core flash-attention
// kernels (flash_fwd_sm90.cu, flash_bwd_sm90.cu): the 128-byte swizzled
// bf16 tile layout, cp.async copies into it, wgmma descriptors and
// products, and the staged store of an accumulator tile.
//
// A 64-row tile of D bf16 columns is D/64 blocks of 64 rows x 128 bytes;
// the 16-byte chunk c of row r is stored at c ^ (r % 8). wgmma reads it
// without bank conflicts, as a K-major operand (K = head dim) or, through
// the descriptor's transpose flag, as an MN-major one (K = rows).
//
// Included by one source of each shared library; everything here is
// internal to that library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows of every tile: one warpgroup's wgmma M
constexpr int NT = 128;  // threads per block: one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr uint32_t kTileBytes = 64 * D * 2;  // one 64-row bf16 tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c8 (head-dim columns 8*c8 .. 8*c8+7) of row r
// in a swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int c8) {
  return (c8 >> 3) * (64 * 128) + r * 128 + (((c8 & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// Makes the copies' writes visible to wgmma's operand reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows r0 .. r0+63 of one head (row stride `ss` elements) into the
// swizzled tile at `dst`; rows at or past S are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, long long ss,
                                          int r0, int S) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int j = 0; j < 64 * CH / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / CH, c8 = i % CH;
    const bool ok = r0 + r < S;
    cp_async16(dst + swz(r, c8), src + (ok ? (r0 + r) * ss + c8 * 8 : 0), ok);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand (a 64-row tile, K = head dim): k-step kk covers columns
// 16*kk .. 16*kk+15, 32 bytes into a 128-byte row of column block kk / 4;
// 8-row groups are 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * (64 * 128) + (kk & 3) * 32, 16, 1024);
}
// MN-major operand (the same tile read as K = rows, N = head dim): k-step
// kk covers rows 16*kk .. 16*kk+15; 64-column blocks are 8 KB apart (LBO),
// 8-row groups 1024 bytes (SBO).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * 128, 64 * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Orders the compiler's accesses to an accumulator after the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define F8(d, i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64x64] (+)= A[64x16] B[16x64], both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64x64] += A[64x16] (registers) B[16x64] (shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d[64x128] += A[64x16] (registers) B[16x128] (shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator fragment of a 64 x N wgmma (N/2 floats a thread): element
// 4n + 2h + j is row 16*warp + lane/4 + 8h, column 8n + 2*(lane%4) + j.
// Pairs (j = 0, 1) rounded to bf16, in that order, are the A-operand
// registers of the next product: k-step kk takes pairs 4kk .. 4kk+3.

// The tile `acc` [64 x D] rounded to bf16 and written to rows r0 .. r0+63
// of `out` (row stride `rs` elements; rows past S are skipped), staged
// through the swizzled tile at `stage` for 16-byte stores.
template <int D>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 2], uint8_t* stage,
                                           __nv_bfloat16* out, long long rs, int r0, int S) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(stage + swz(16 * warp + g + 8 * h, n) + 4 * t) =
          pack_bf16(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
  __syncthreads();
  constexpr int CH = D / 8;
#pragma unroll
  for (int j = 0; j < 64 * CH / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / CH, c8 = i % CH;
    if (r0 + r < S)
      *reinterpret_cast<uint4*>(out + (r0 + r) * rs + c8 * 8) =
          *reinterpret_cast<const uint4*>(stage + swz(r, c8));
  }
}

}  // namespace

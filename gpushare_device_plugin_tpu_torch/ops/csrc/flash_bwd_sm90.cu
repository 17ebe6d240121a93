// Flash attention backward for Hopper's tensor cores (sm_90a), bf16 with
// head dim 64 or 128; plain C interface for ctypes.
//
// Replaces the two backward Pallas kernels of
// gpushare_device_plugin_tpu/ops/flash_attention.py:
//   flash_bwd_dq  <- _dq_kernel  (:251-306): P = exp(S*scale - lse),
//                    dP = dO V^T, dS = P (dP - delta) scale, dQ = sum_kv dS K;
//   flash_bwd_dkv <- _dkv_kernel (:309-375): per KV head, summed over every
//                    (group member, Q tile): dV += P^T dO, dK += dS^T Q.
// Inputs, outputs, masks and casts are those of flash_bwd.cu (its scalar
// entries take f32 and the other head dims): q, dO [B, S, H, D] and k, v
// [B, S, Hkv, D] bf16 read by stride (rows 16-byte aligned), lse and
// delta [B, S, H] f32 contiguous; causal, `start` and `kv_len` masks; a
// row with lse = -inf is shifted by 0, so its P is 0; dS is rounded to
// bf16 before dS K and dS^T Q, P before P^T dO; sums are f32 and each
// output is rounded once at the end.
//
// Bound on an H100: at the training shape (B=4, S=2048, H=32, Hkv=8,
// D=128, causal) both are compute bound: dQ does 6*D flops and dK/dV 8*D
// flops per visible (query, key) pair per head against 989 TFLOP/s bf16
// (0.21 and 0.28 ms), while their bytes take 0.05 ms at 3.35 TB/s.
//
// What the design does about it:
// - Every product is a warpgroup MMA (wgmma.mma_async m64nNk16, bf16 in,
//   f32 sums in registers). One block is one warpgroup (128 threads) that
//   owns a 64-row tile: wgmma's M.
// - The scores are computed in the orientation of the next product, so P
//   and dS never leave registers: dQ computes S = Q K^T and dP = dO V^T
//   (rows = its queries), dK/dV computes S^T = K Q^T and dP^T = V dO^T
//   (rows = its keys). The f32 accumulator fragment of a 64x64 product,
//   rounded to bf16 in pairs, is the register A operand of the next
//   wgmma, so dQ += dS K, dV += P^T dO and dK += dS^T Q read A from
//   registers and B from shared memory.
// - Tiles stay bf16 in shared memory in the 128-byte swizzled layout that
//   wgmma reads without bank conflicts: a 64-row tile is D/64 blocks of
//   64 rows x 128 bytes, the 16-byte chunk c of row r stored at c ^ (r % 8).
//   The same tile is K-major for S = Q K^T (K = head dim) and MN-major for
//   dS K (K = keys), through the descriptor's transpose flag: nothing is
//   transposed in shared memory.
// - cp.async 16-byte copies fill the swizzled tiles straight from the
//   strided inputs (rows at or past S zero-filled), through a two-stage
//   ring: the next tile loads while this one computes. 97 KB (dQ) and
//   98 KB (dK/dV) of shared memory a block at D = 128, so two blocks share
//   an SM and one's exponentials overlap the other's products.
// - The grid's slow dimension is the tile, heaviest first under causality
//   (dQ: the last Q tile; dK/dV: KV tile 0), so the light tiles fill the
//   tail. Tiles the masks hide entirely are never loaded.
// - Each block owns its output rows: no atomics, the same bits every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows of every tile: one warpgroup's wgmma M
constexpr int NT = 128;  // threads per block: one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr uint32_t kTileBytes = 64 * D * 2;  // one 64-row bf16 tile

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // [B, S, H]
  const float* delta;  // [B, S, H]
  const int* start;    // [B] or null
  const int* kv_len;   // [B] or null
  __nv_bfloat16* out0; // dq, or dk
  __nv_bfloat16* out1; // unused, or dv
  int B, S, H, Hkv, D;
  long long q_sb, q_ss, q_sh;  // element strides over (batch, seq, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // of dO
  float scale;
  int causal;
};

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

// lse (threads 0-63) and delta (threads 64-127) of Q rows q0 .. q0+63 of
// head h into lse_dst[64] and lse_dst + 512 bytes; rows past S read 0.
__device__ __forceinline__ void load_stats(uint32_t lse_dst, const BwdArgs& a, int b, int h,
                                           int q0) {
  const int t = threadIdx.x & 63;
  const bool is_delta = threadIdx.x >= 64;
  const bool ok = q0 + t < a.S;
  const long long row = ok ? (static_cast<long long>(b) * a.S + q0 + t) * a.H + h : 0;
  cp_async4(lse_dst + (is_delta ? 512 : 0) + 4 * t, (is_delta ? a.delta : a.lse) + row, ok);
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

__device__ __forceinline__ bool visible(const BwdArgs& a, int qp, int kp, int start, int end) {
  return qp < a.S && kp < end && kp >= start && (!a.causal || kp <= qp);
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

template <int D>
constexpr size_t kDqSmem = 6 * kTileBytes<D> + 1024;  // + alignment slack
template <int D>
constexpr size_t kDkvSmem = 6 * kTileBytes<D> + 1024 + 1024;  // + lse/delta ring

// One block per (batch*head, 64-row Q tile); grid (B*H, ceil(S/64)), the
// last Q tile first. Shared memory: Q, dO resident; K, V two stages each.
template <int D>
__global__ void __launch_bounds__(NT, 2) dq_kernel(const BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-byte aligned
  uint8_t* const gbase = smem_raw + (base - raw);
  constexpr uint32_t TB = kTileBytes<D>;
  const uint32_t sQ = base, sdO = base + TB;  // K of stage st at (2+st)*TB, V at (4+st)*TB

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int S = a.S;

  const __nv_bfloat16* qg = a.q + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* og = a.dout + b * a.o_sb + h * a.o_sh;
  const __nv_bfloat16* kg = a.k + b * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* vg = a.v + b * a.v_sb + kvh * a.v_sh;

  const int start = a.start ? a.start[b] : 0;
  const int end = a.kv_len ? min(a.kv_len[b], S) : S;
  const int kv_lo = (start / BM) * BM;
  const int kv_hi = a.causal ? min(end, q0 + BM) : end;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BM - 1) / BM : 0;

  load_tile<D>(sQ, qg, a.q_ss, q0, S);
  load_tile<D>(sdO, og, a.o_ss, q0, S);
  if (n_tiles > 0) {
    load_tile<D>(base + 2 * TB, kg, a.k_ss, kv_lo, S);
    load_tile<D>(base + 4 * TB, vg, a.v_ss, kv_lo, S);
  }
  cp_async_commit();

  // lse (log2 units, shifted by 0 where it is -inf) and delta of the
  // thread's two rows.
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qp = q0 + 16 * warp + g + 8 * hh;
    float l = 0.f, d = 0.f;
    if (qp < S) {
      const long long row = (static_cast<long long>(b) * S + qp) * a.H + h;
      l = a.lse[row];
      d = a.delta[row];
    }
    lse2[hh] = l == -INFINITY ? 0.f : l * LOG2E;
    dl[hh] = d;
  }
  const float scale_log2 = a.scale * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int k0 = kv_lo + it * BM;
    if (it + 1 < n_tiles) {  // the next K/V tile loads while this one computes
      load_tile<D>(base + (3 - st) * TB, kg, a.k_ss, k0 + BM, S);
      load_tile<D>(base + (5 - st) * TB, vg, a.v_ss, k0 + BM, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t sK = base + (2 + st) * TB, sV = base + (4 + st) * TB;

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc(sQ, kk), kmajor_desc(sK, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, kmajor_desc(sdO, kk), kmajor_desc(sV, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const bool full = k0 >= start && k0 + BM <= end && (!a.causal || k0 + BM - 1 <= q0);
    uint32_t ds_frag[16];  // dS in bf16 (K's dtype), the A operand of dS K
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float ds[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * n + 2 * hh + j;
          const int qp = q0 + 16 * warp + g + 8 * hh;
          const int kp = k0 + 8 * n + 2 * t + j;
          float p = 0.f;
          if (full || visible(a, qp, kp, start, end))
            p = exp2f(fmaf(s[e], scale_log2, -lse2[hh]));
          ds[j] = p * (dp[e] - dl[hh]) * a.scale;
        }
        ds_frag[2 * n + hh] = pack_bf16(ds[0], ds[1]);
      }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, ds_frag[4 * kk], ds_frag[4 * kk + 1], ds_frag[4 * kk + 2],
               ds_frag[4 * kk + 3], mnmajor_desc(sK, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();
  store_tile<D>(acc, gbase, a.out0 + (static_cast<long long>(b) * S * a.H + h) * D,
                static_cast<long long>(a.H) * D, q0, S);
}

// One block per (batch*kv-head, 64-row KV tile); grid (B*Hkv, ceil(S/64)),
// KV tile 0 first. It walks (group member, Q tile) from the first Q tile
// causality lets see its keys. Shared memory: K, V resident; Q, dO and
// the Q tile's lse and delta two stages each.
template <int D>
__global__ void __launch_bounds__(NT, 2) dkv_kernel(const BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  constexpr uint32_t TB = kTileBytes<D>;
  const uint32_t sK = base, sV = base + TB;  // Q of stage st at (2+st)*TB, dO at (4+st)*TB
  const uint32_t s_stats = base + 6 * TB;    // lse[2][64], then delta[2][64]
  const float* stats = reinterpret_cast<const float*>(gbase + 6 * TB);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.Hkv, kvh = blockIdx.x % a.Hkv;
  const int groups = a.H / a.Hkv;
  const int k0 = blockIdx.y * BM;
  const int S = a.S;

  const __nv_bfloat16* kg = a.k + b * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* vg = a.v + b * a.v_sb + kvh * a.v_sh;
  const __nv_bfloat16* qb = a.q + b * a.q_sb;
  const __nv_bfloat16* ob = a.dout + b * a.o_sb;

  const int start = a.start ? a.start[b] : 0;
  const int end = a.kv_len ? min(a.kv_len[b], S) : S;
  // A tile wholly inside the left pad or at/after kv_len has zero dK/dV.
  const bool live = k0 + BM - 1 >= start && k0 < end;
  const int qt_first = a.causal ? k0 / BM : 0;
  const int nq = (S + BM - 1) / BM - qt_first;
  const int n_steps = live ? groups * nq : 0;

  auto load_step = [&](int step, int st) {
    const int hq = kvh * groups + step / nq;
    const int q0 = (qt_first + step % nq) * BM;
    load_tile<D>(base + (2 + st) * TB, qb + hq * a.q_sh, a.q_ss, q0, S);
    load_tile<D>(base + (4 + st) * TB, ob + hq * a.o_sh, a.o_ss, q0, S);
    load_stats(s_stats + st * 256, a, b, hq, q0);
  };
  if (n_steps > 0) {
    load_tile<D>(sK, kg, a.k_ss, k0, S);
    load_tile<D>(sV, vg, a.v_ss, k0, S);
    load_step(0, 0);
  }
  cp_async_commit();

  const float scale_log2 = a.scale * LOG2E;
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const int st = step & 1;
    if (step + 1 < n_steps) load_step(step + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const int q0 = (qt_first + step % nq) * BM;
    const uint32_t sQ = base + (2 + st) * TB, sdO = base + (4 + st) * TB;
    const float* lse_s = stats + st * 64;
    const float* dl_s = stats + 128 + st * 64;

    float s[32], dp[32];  // S^T and dP^T: rows = this block's keys, columns = queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc(sK, kk), kmajor_desc(sQ, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, kmajor_desc(sV, kk), kmajor_desc(sdO, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const bool full =
        q0 + BM <= S && k0 >= start && k0 + BM <= end && (!a.causal || k0 + BM - 1 <= q0);
    uint32_t p_frag[16], ds_frag[16];  // P^T in dO's dtype, dS^T in Q's dtype
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * n + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(dl_s + 8 * n + 2 * t);
      const float lj[2] = {l2.x == -INFINITY ? 0.f : l2.x * LOG2E,
                           l2.y == -INFINITY ? 0.f : l2.y * LOG2E};
      const float dj[2] = {d2.x, d2.y};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float p[2], ds[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * n + 2 * hh + j;
          const int kp = k0 + 16 * warp + g + 8 * hh;
          const int qp = q0 + 8 * n + 2 * t + j;
          p[j] = 0.f;
          if (full || visible(a, qp, kp, start, end))
            p[j] = exp2f(fmaf(s[e], scale_log2, -lj[j]));
          ds[j] = p[j] * (dp[e] - dj[j]) * a.scale;
        }
        p_frag[2 * n + hh] = pack_bf16(p[0], p[1]);
        ds_frag[2 * n + hh] = pack_bf16(ds[0], ds[1]);
      }
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc_v, p_frag[4 * kk], p_frag[4 * kk + 1], p_frag[4 * kk + 2],
               p_frag[4 * kk + 3], mnmajor_desc(sdO, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc_k, ds_frag[4 * kk], ds_frag[4 * kk + 1], ds_frag[4 * kk + 2],
               ds_frag[4 * kk + 3], mnmajor_desc(sQ, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_v);
    fence_regs(acc_k);
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();
  const long long row0 = static_cast<long long>(b) * S * a.Hkv + kvh;
  const long long rs = static_cast<long long>(a.Hkv) * D;
  store_tile<D>(acc_k, gbase, a.out0 + row0 * D, rs, k0, S);
  store_tile<D>(acc_v, gbase + TB, a.out1 + row0 * D, rs, k0, S);
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// cudaSuccess, or why the entries do not take these arguments: bf16 only,
// D in {64, 128}, rows of q, k, v and dO 16-byte aligned.
int check(const void* q, const void* k, const void* v, const void* dout, int H, int Hkv,
          int D, const long long* st, int dtype) {
  if (dtype != 1 || (D != 64 && D != 128) || Hkv < 1 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  long long strides = 0;
  for (int i = 0; i < 12; ++i) strides |= st[i];
  if ((ptrs & 15) || (strides & 7)) return static_cast<int>(cudaErrorMisalignedAddress);
  return static_cast<int>(cudaSuccess);
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, const int* start,
                  const int* kv_len, void* out0, void* out1, int B, int S, int H,
                  int Hkv, int D, const long long* st, float scale, int causal) {
  using bf = __nv_bfloat16;
  return BwdArgs{static_cast<const bf*>(q), static_cast<const bf*>(k),
                 static_cast<const bf*>(v), static_cast<const bf*>(dout),
                 lse, delta, start, kv_len, static_cast<bf*>(out0), static_cast<bf*>(out1),
                 B, S, H, Hkv, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                 st[8], st[9], st[10], st[11], scale, causal};
}

}  // namespace

// The same C interface as flash_bwd.cu's scalar entries. strides: 12
// element strides, (batch, seq, head) of q, k, v and dO in turn. dtype
// must be 1 (bfloat16). Each returns cudaGetLastError() of its launch, or
// why it refused the arguments.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const int* start,
                            const int* kv_len, void* dq, int B, int S, int H, int Hkv,
                            int D, const long long* strides, float scale, int causal,
                            int dtype, void* stream) {
  const int bad = check(q, k, v, dout, H, Hkv, D, strides, dtype);
  if (bad) return bad;
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, start, kv_len, dq, nullptr, B, S,
                              H, Hkv, D, strides, scale, causal);
  const dim3 grid(B * H, (S + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch(dq_kernel<64>, kDqSmem<64>, grid, a, s);
  return launch(dq_kernel<128>, kDqSmem<128>, grid, a, s);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, const int* start,
                             const int* kv_len, void* dk, void* dv, int B, int S, int H,
                             int Hkv, int D, const long long* strides, float scale,
                             int causal, int dtype, void* stream) {
  const int bad = check(q, k, v, dout, H, Hkv, D, strides, dtype);
  if (bad) return bad;
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, start, kv_len, dk, dv, B, S, H,
                              Hkv, D, strides, scale, causal);
  const dim3 grid(B * Hkv, (S + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch(dkv_kernel<64>, kDkvSmem<64>, grid, a, s);
  return launch(dkv_kernel<128>, kDkvSmem<128>, grid, a, s);
}

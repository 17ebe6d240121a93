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
//   wgmma reads without bank conflicts (its helpers are in sm90.cuh, shared
//   with flash_fwd_sm90.cu): a 64-row tile is D/64 blocks of
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

#include "sm90.cuh"

namespace {

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

__device__ __forceinline__ bool visible(const BwdArgs& a, int qp, int kp, int start, int end) {
  return qp < a.S && kp < end && kp >= start && (!a.causal || kp <= qp);
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

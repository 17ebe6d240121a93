// Flash attention forward for Hopper's tensor cores (sm_90a), bf16 with
// head dim 64 or 128; plain C interface for ctypes.
//
// Replaces gpushare_device_plugin_tpu/ops/flash_attention.py::_fwd_kernel
// (:96-166): online-softmax attention over q [B, S, H, D] and grouped k/v
// [B, S, Hkv, D] bf16 (read by stride, rows 16-byte aligned), writing O
// [B, S, H, D] bf16 and the per-row logsumexp lse [B, S, H] f32. What it
// computes is what flash_fwd.cu computes (its entry flash_fwd_scalar takes
// f32 and the other head dims): causal, `start` and `kv_len` masks; a row
// that sees no key gets O = 0 and lse = -inf, never NaN (the reference's
// m_safe shift); the denominator l sums the f32 probabilities, P is
// rounded to bf16 (V's dtype) before the PV product, and O is rounded once
// at the end.
//
// Bound on an H100, 4*D flops per visible (query, key) pair per head
// against 989 TFLOP/s bf16, and q, k, v read once, O and lse written once
// against 3.35 TB/s:
// - the served shape (B=1, S=512, H=32, Hkv=8, D=128, kv_len, causal):
//   2.15 GFLOP take 2.2 us, 10.5 MB take 3.1 us, so bytes bound it at
//   3.1 us. 256 blocks of 1 to 8 KV tiles fill the card about once: the
//   launch and the longest block's serial loop set the time there.
// - the training shape (B=4, S=2048, the same heads, causal): 137.5 GFLOP
//   take 0.139 ms, 169 MB take 0.050 ms, so operations bound it.
//
// What the design does about it:
// - Both products are warpgroup MMAs (wgmma.mma_async, bf16 in, f32 sums
//   in registers). One block is one warpgroup (128 threads) that owns a
//   64-row Q tile: wgmma's M. S = Q K^T is D/16 m64n64k16 steps with both
//   operands K-major in shared memory.
// - The online softmax runs on S's accumulator fragment, 2 rows x 16
//   columns a thread: the row max is reduced over the 4 threads of a quad
//   by shuffles, the row sum is kept per thread and reduced once at the
//   end. The probabilities, rounded to bf16 in pairs, are the register A
//   operand of O += P V (m64nDk16, V's tile read MN-major through the
//   descriptor's transpose flag): P never leaves registers, and O stays in
//   registers for the whole KV loop.
// - Q is resident in shared memory; K and V go through a two-stage
//   cp.async ring in the 128-byte swizzle (sm90.cuh), the next tile loading
//   while this one computes, rows at or past S zero-filled. Five tiles, 81
//   KB a block at D = 128, so two blocks share an SM and one's
//   exponentials overlap the other's products.
// - The grid's slow dimension is the Q tile, the last (heaviest under
//   causality) first, so the light tiles fill the tail. KV tiles the masks
//   hide entirely are never loaded, and the masks are applied only on
//   tiles that are not wholly visible.
// - O leaves through a swizzled staging tile as 16-byte stores. Each block
//   owns its rows: the same bits every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float LN2 = 0.6931471805599453f;

struct FwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;    // [B, S, H, D] contiguous
  float* lse;          // [B, S, H] contiguous
  const int* start;    // [B] or null
  const int* kv_len;   // [B] or null
  int B, S, H, Hkv, D;
  long long q_sb, q_ss, q_sh;  // element strides over (batch, seq, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal;
};

template <int D>
constexpr size_t kFwdSmem = 5 * kTileBytes<D> + 1024;  // + alignment slack

// One block per (batch*head, 64-row Q tile); grid (B*H, ceil(S/64)), the
// last Q tile first. Shared memory: Q resident; K, V two stages each.
template <int D>
__global__ void __launch_bounds__(NT, 2) fwd_kernel(const FwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-byte aligned
  uint8_t* const gbase = smem_raw + (base - raw);
  constexpr uint32_t TB = kTileBytes<D>;
  const uint32_t sQ = base;  // K of stage st at (1+st)*TB, V at (3+st)*TB

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / (a.H / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int S = a.S;

  const __nv_bfloat16* qg = a.q + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kg = a.k + b * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* vg = a.v + b * a.v_sb + kvh * a.v_sh;

  // Only KV tiles some key of which is visible: from the tile holding
  // `start` up to the causal diagonal / kv_len / S, whichever ends first.
  const int start = a.start ? a.start[b] : 0;
  const int end = a.kv_len ? min(a.kv_len[b], S) : S;
  const int kv_lo = (start / BM) * BM;
  const int kv_hi = a.causal ? min(end, q0 + BM) : end;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BM - 1) / BM : 0;

  load_tile<D>(sQ, qg, a.q_ss, q0, S);
  if (n_tiles > 0) {
    load_tile<D>(base + TB, kg, a.k_ss, kv_lo, S);
    load_tile<D>(base + 3 * TB, vg, a.v_ss, kv_lo, S);
  }
  cp_async_commit();

  const float scale_log2 = a.scale * LOG2E;
  // Per row hh of the thread's two: the running max of S * scale in log2
  // units (-inf until a key is visible), and this thread's share of the
  // running denominator (its 16 columns; the quad's shares sum to l).
  float m2[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int k0 = kv_lo + it * BM;
    if (it + 1 < n_tiles) {  // the next K/V tile loads while this one computes
      load_tile<D>(base + (2 - st) * TB, kg, a.k_ss, k0 + BM, S);
      load_tile<D>(base + (4 - st) * TB, vg, a.v_ss, k0 + BM, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t sK = base + (1 + st) * TB, sV = base + (3 + st) * TB;

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc(sQ, kk), kmajor_desc(sK, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Scaled scores in log2 units; keys a row does not see are -inf.
    const bool full = k0 >= start && k0 + BM <= end && (!a.causal || k0 + BM - 1 <= q0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * n + 2 * hh + j;
          const int qp = q0 + 16 * warp + g + 8 * hh;
          const int kp = k0 + 8 * n + 2 * t + j;
          const bool vis = full || (qp < S && kp < end && kp >= start && (!a.causal || kp <= qp));
          s[e] = vis ? s[e] * scale_log2 : -INFINITY;
        }

    uint32_t p_frag[16];  // P in bf16 (V's dtype), the A operand of P V
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m2[hh];
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * hh], s[4 * n + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // A row with nothing visible yet keeps m = -inf; shift by 0 there
      // so exp() gives 0 and never NaN.
      const float m_safe = mx == -INFINITY ? 0.f : mx;
      const float alpha = exp2f(m2[hh] - m_safe);  // 0 while m was -inf
      m2[hh] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float p0 = exp2f(s[4 * n + 2 * hh] - m_safe);
        const float p1 = exp2f(s[4 * n + 2 * hh + 1] - m_safe);
        sum += p0 + p1;  // l sums the unrounded probabilities
        p_frag[2 * n + hh] = pack_bf16(p0, p1);
      }
      l[hh] = alpha * l[hh] + sum;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n + 2 * hh] *= alpha;
        acc[4 * n + 2 * hh + 1] *= alpha;
      }
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, p_frag[4 * kk], p_frag[4 * kk + 1], p_frag[4 * kk + 2],
               p_frag[4 * kk + 3], mnmajor_desc(sV, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();

  // O = acc / l (l = 0 divides by 1: O = 0), lse = m + log(l) or -inf.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const float l_safe = l[hh] == 0.f ? 1.f : l[hh];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n + 2 * hh] /= l_safe;
      acc[4 * n + 2 * hh + 1] /= l_safe;
    }
    const int qp = q0 + 16 * warp + g + 8 * hh;
    if (t == 0 && qp < S)
      a.lse[(static_cast<long long>(b) * S + qp) * a.H + h] =
          l[hh] == 0.f ? -INFINITY : m2[hh] * LN2 + logf(l[hh]);
  }
  store_tile<D>(acc, gbase, a.o + (static_cast<long long>(b) * S * a.H + h) * D,
                static_cast<long long>(a.H) * D, q0, S);
}

template <int D>
int launch(const FwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kFwdSmem<D>));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.B * a.H, (a.S + BM - 1) / BM);
  fwd_kernel<D><<<grid, NT, kFwdSmem<D>, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The same C interface as flash_fwd.cu's flash_fwd_scalar. Strides are
// element strides over (batch, seq, head); o [B, S, H, D] and lse
// [B, S, H] are contiguous. dtype must be 1 (bfloat16), D 64 or 128, and
// the rows of q, k and v 16-byte aligned. Returns cudaGetLastError() of the
// launch, or why it refused the arguments.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, const int* start, const int* kv_len,
                         int B, int S, int H, int Hkv, int D,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         float scale, int causal, int dtype, void* stream) {
  if (dtype != 1 || (D != 64 && D != 128) || Hkv < 1 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const long long strides = q_sb | q_ss | q_sh | k_sb | k_ss | k_sh | v_sb | v_ss | v_sh;
  if ((ptrs & 15) || (strides & 7)) return static_cast<int>(cudaErrorMisalignedAddress);
  using bf = __nv_bfloat16;
  const FwdArgs a{static_cast<const bf*>(q), static_cast<const bf*>(k),
                  static_cast<const bf*>(v), static_cast<bf*>(o), lse, start, kv_len,
                  B, S, H, Hkv, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                  scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(a, s);
  return launch<128>(a, s);
}

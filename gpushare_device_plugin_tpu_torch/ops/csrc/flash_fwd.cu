// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces gpushare_device_plugin_tpu/ops/flash_attention.py::_fwd_kernel:
// online-softmax attention over q [B, S, H, D] and grouped k/v
// [B, S, Hkv, D] (bf16 or f32), writing O [B, S, H, D] in q's dtype and the
// per-row logsumexp lse [B, S, H] f32. Masks: causal, per-batch-row
// `start` (keys before it are left padding) and `kv_len` (keys at or after
// it are right padding). A row that sees no key gets O = 0 and
// lse = -inf, never NaN (the reference's m_safe shift).
//
// Bound on an H100: at the serving shapes (S <= 2048, D = 128) attention is
// compute bound: 4*S^2*D*H FLOP (halved when causal) against 989 TFLOP/s
// bf16, while the bytes are O(S*D*H). This first kernel does not reach the
// tensor cores: it runs scalar f32 FMAs from shared memory (67 TFLOP/s
// peak). What the design does about the bound: every block keeps one
// 64-row Q tile resident and streams 64-row K/V tiles through shared
// memory, so each K/V byte is read once per Q tile and scores never touch
// device memory; register micro-tiles (4x4 scores, 8x4 accumulators) give
// each shared-memory load several FMAs; KV tiles that the masks hide
// entirely (past the causal diagonal, before `start`, at or after
// `kv_len`) are never loaded or computed.
//
// Grid: (ceil(S / 64), B * H); 256 threads; the KV tiles are a loop inside
// the block (the TPU grid's sequential dimension). GQA: query head h reads
// KV head h / (H / Hkv) through the strides, K/V are never repeated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per KV tile
constexpr int MAXD = 128;            // largest head dim the kernel takes
constexpr int NT = 256;              // threads per block
constexpr int NW = NT / 32;          // warps per block
constexpr int QK_STRIDE = MAXD + 1;  // padded rows: column walks hit distinct banks
constexpr int P_STRIDE = BK + 1;

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* start;   // [B] or null
  const int* kv_len;  // [B] or null
  int B, S, H, Hkv, D;
  long long q_sb, q_ss, q_sh;  // element strides of q over (batch, seq, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal;
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
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr size_t kSmemBytes =
    sizeof(float) * (BQ * QK_STRIDE + BK * QK_STRIDE + BK * MAXD +
                     BQ * P_STRIDE + 3 * BQ);

template <typename T>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][QK_STRIDE]
  float* Ks = Qs + BQ * QK_STRIDE;  // [BK][QK_STRIDE]
  float* Vs = Ks + BK * QK_STRIDE;  // [BK][MAXD]
  float* Ps = Vs + BK * MAXD;       // [BQ][P_STRIDE] scores, then probabilities
  float* m_s = Ps + BQ * P_STRIDE;  // running max per row
  float* l_s = m_s + BQ;            // running denominator per row
  float* a_s = l_s + BQ;            // this tile's rescale factor per row

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kvh = h / (a.H / a.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int S = a.S;
  const int D = a.D;

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  const int start = a.start ? a.start[b] : 0;
  const int end = a.kv_len ? min(a.kv_len[b], S) : S;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int qp = q0 + r;
    Qs[r * QK_STRIDE + c] = qp < S ? to_f(qg[qp * a.q_ss + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // PV ownership: rows warp + NW*i, columns lane + 32*j.
  float acc[BQ / NW][MAXD / 32];
#pragma unroll
  for (int i = 0; i < BQ / NW; ++i)
#pragma unroll
    for (int j = 0; j < MAXD / 32; ++j) acc[i][j] = 0.f;

  // Score ownership: rows sr0 + i, columns sc0 + 16*j (a 4x4 micro-tile).
  const int sr0 = (tid / 16) * 4;
  const int sc0 = tid % 16;

  // Only KV tiles some key of which is visible: from the tile holding
  // `start` up to the causal diagonal / kv_len / S, whichever ends first.
  const int kv_lo = (start / BK) * BK;
  int kv_hi = end;
  if (a.causal) kv_hi = min(kv_hi, q0 + BQ);

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int kp = k0 + r;
      const bool in = kp < S;
      Ks[r * QK_STRIDE + c] = in ? to_f(kg[kp * a.k_ss + c]) : 0.f;
      Vs[r * MAXD + c] = in ? to_f(vg[kp * a.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(sr0 + i) * QK_STRIDE + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(sc0 + 16 * j) * QK_STRIDE + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = sr0 + i;
      const int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = sc0 + 16 * j;
        const int kp = k0 + c;
        const bool ok =
            kp < end && kp >= start && (!a.causal || kp <= qp);
        Ps[r * P_STRIDE + c] = ok ? s[i][j] * a.scale : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax: warp w updates rows w*8 .. w*8+7, two keys per lane.
    for (int rr = 0; rr < BQ / NW; ++rr) {
      const int r = warp * (BQ / NW) + rr;
      const float x0 = Ps[r * P_STRIDE + lane];
      const float x1 = Ps[r * P_STRIDE + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      // A row with nothing visible yet keeps m = -inf; shift by 0 there
      // so exp() gives 0 and never NaN.
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = expf(x0 - m_safe);
      const float p1 = expf(x1 - m_safe);
      const float sum = warp_sum(p0 + p1);
      // P enters the PV product in V's dtype, as the reference casts it.
      Ps[r * P_STRIDE + lane] = to_f(from_f<T>(p0));
      Ps[r * P_STRIDE + lane + 32] = to_f(from_f<T>(p1));
      if (lane == 0) {
        const float alpha = expf(m_prev - m_safe);
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < BQ / NW; ++i) {
      const float alpha = a_s[warp + NW * i];
#pragma unroll
      for (int j = 0; j < MAXD / 32; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < BK; ++c) {
      float vv[MAXD / 32];
#pragma unroll
      for (int j = 0; j < MAXD / 32; ++j) vv[j] = Vs[c * MAXD + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < BQ / NW; ++i) {
        const float pv = Ps[(warp + NW * i) * P_STRIDE + c];
#pragma unroll
        for (int j = 0; j < MAXD / 32; ++j) acc[i][j] = fmaf(pv, vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();  // m_s/l_s are final (also when no tile was visible)

  T* og = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < BQ / NW; ++i) {
    const int r = warp + NW * i;
    const int qp = q0 + r;
    if (qp >= S) continue;
    const float l = l_s[r];
    const float l_safe = l == 0.f ? 1.f : l;
    const long long row = (static_cast<long long>(b) * S + qp) * a.H + h;
#pragma unroll
    for (int j = 0; j < MAXD / 32; ++j) {
      const int c = lane + 32 * j;
      if (c < D) og[row * D + c] = from_f<T>(acc[i][j] / l_safe);
    }
    if (lane == 0) a.lse[row] = l == 0.f ? -INFINITY : m_s[r] + logf(l);
  }
}

template <typename T>
int launch(const FwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
  flash_fwd_kernel<T><<<grid, NT, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the launch.
extern "C" int flash_fwd_scalar(const void* q, const void* k, const void* v, void* o,
                         float* lse, const int* start, const int* kv_len,
                         int B, int S, int H, int Hkv, int D,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         float scale, int causal, int dtype, void* stream) {
  if (D > MAXD || D < 1 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{q, k, v, o, lse, start, kv_len, B, S, H, Hkv, D,
            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
            scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(a, s);
  if (dtype == 0) return launch<float>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

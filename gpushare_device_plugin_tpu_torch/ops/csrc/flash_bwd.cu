// Flash attention backward on scalar FMAs (sm_90a), plain C interface for
// ctypes: the entries for f32 and for head dims other than 64 and 128.
// bf16 with D in {64, 128} (serving and training) goes to the tensor-core
// kernels of flash_bwd_sm90.cu instead; f32 stays here because the tensor
// cores' f32 route is TF32, which cannot meet the f32 tolerance.
//
// Replaces the two backward Pallas kernels of
// gpushare_device_plugin_tpu/ops/flash_attention.py:
//   flash_bwd_dq_scalar  <- _dq_kernel  (:251-306): P = exp(S*scale - lse),
//                    dP = dO V^T, dS = P (dP - delta) scale, dQ = sum_kv dS K;
//   flash_bwd_dkv_scalar <- _dkv_kernel (:309-375): per KV head, summed over
//                    every (group member, Q tile): dV += P^T dO, dK += dS^T Q.
// Inputs: q, dO [B, S, H, D] and k, v [B, S, Hkv, D] (bf16 or f32, read by
// stride), lse and delta = rowsum(dO * O) - dlse [B, S, H] f32 contiguous.
// Outputs (contiguous): dq [B, S, H, D] in q's dtype, dk, dv [B, S, Hkv, D].
// Masks as in flash_fwd.cu: causal, `start` (keys before it are left pad)
// and `kv_len` (keys at or after it are right pad). A row with lse = -inf
// (it sees no key) is shifted by 0, so its P is 0 and never NaN. The casts
// are the reference's: dS to K's dtype before dS K, P to dO's dtype before
// P^T dO, dS to Q's dtype before dS^T Q, f32 sums cast to the output dtype
// at the end.
//
// Bound on an H100: at the training shape (S = 2048, D = 128) both are
// compute bound: dQ does 6*D flops and dK/dV 8*D flops per visible
// (query, key) pair per head, against 989 TFLOP/s bf16, while the bytes are
// O(S*D*H). These kernels do not reach the tensor cores: they run scalar
// f32 FMAs from shared memory (67 TFLOP/s peak). What the design does
// about the bound: scores, P and dS never touch device memory (they are
// recomputed from lse in shared memory); every block keeps its own 64-row
// tile resident and streams the other side's 64-row tiles through shared
// memory; register micro-tiles (4x4 scores, 8x4 accumulators) give each
// shared-memory load several FMAs; tiles the masks hide entirely are never
// loaded.
//
// dQ grid: (ceil(S / 64), B * H), one block per (batch*head, 64-row Q tile),
// the KV tiles a loop inside the block with the causal / start / kv_len
// skips of flash_fwd.cu. Query head h reads KV head h / (H / Hkv).
// dK/dV grid: (ceil(S / 64), B * Hkv), one block per (batch*kv-head, 64-row
// KV tile), the loop inside runs over group member x Q tile from the first Q
// tile that causality lets see this KV tile (the reference's grid
// (BKV, num_kv, groups * num_q) and its first_qi). Each block owns its
// dK/dV rows: no atomics, the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // keys per tile
constexpr int MAXD = 128;        // largest head dim the kernels take
constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int ROW = MAXD + 1;    // padded rows: column walks hit distinct banks
constexpr int P_STRIDE = BK + 1;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, S, H]
  const float* delta;  // [B, S, H]
  const int* start;    // [B] or null
  const int* kv_len;   // [B] or null
  void* out0;          // dq, or dk
  void* out1;          // unused, or dv
  int B, S, H, Hkv, D;
  long long q_sb, q_ss, q_sh;  // element strides over (batch, seq, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // of dO
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

// x rounded to T and back: the value a cast to T leaves.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// Rows r0 .. r0+63 of one head (row stride `ss` elements) into a padded f32
// tile; rows at or past S read as 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ss,
                                          int r0, int S, int D) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    const int p = r0 + r;
    dst[r * ROW + c] = p < S ? to_f(src[p * ss + c]) : 0.f;
  }
}

// lse (shifted by 0 where it is -inf) and delta of Q rows q0 .. q0+63 of
// head h; rows past S read as 0.
__device__ __forceinline__ void load_stats(float* lse_s, float* dl_s, const BwdArgs& a,
                                           int b, int h, int q0) {
  const int t = threadIdx.x;
  if (t < BQ) {
    const int qp = q0 + t;
    float l = 0.f, d = 0.f;
    if (qp < a.S) {
      const long long row = (static_cast<long long>(b) * a.S + qp) * a.H + h;
      l = a.lse[row];
      d = a.delta[row];
    }
    lse_s[t] = l == -INFINITY ? 0.f : l;
    dl_s[t] = d;
  }
}

// For the thread's 4x4 micro-tile (Q rows sr0 + i, keys sc0 + 16 j): the
// scores Q K^T and dP = dO V^T, both f32 sums over the head dim.
__device__ __forceinline__ void scores(const float* Qs, const float* dOs, const float* Ks,
                                       const float* Vs, int sr0, int sc0, int D,
                                       float s[4][4], float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(sr0 + i) * ROW + d];
      ov[i] = dOs[(sr0 + i) * ROW + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(sc0 + 16 * j) * ROW + d];
      vv[j] = Vs[(sc0 + 16 * j) * ROW + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

__device__ __forceinline__ bool visible(const BwdArgs& a, int qp, int kp, int start, int end) {
  return qp < a.S && kp < end && kp >= start && (!a.causal || kp <= qp);
}

constexpr size_t kDqSmem = sizeof(float) * (4 * 64 * ROW + BQ * P_STRIDE + 2 * BQ);
constexpr size_t kDkvSmem = sizeof(float) * (4 * 64 * ROW + 2 * BQ * P_STRIDE + 2 * BQ);

template <typename T>
__global__ void __launch_bounds__(NT) dq_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][ROW]
  float* dOs = Qs + BQ * ROW;       // [BQ][ROW]
  float* Ks = dOs + BQ * ROW;       // [BK][ROW]
  float* Vs = Ks + BK * ROW;        // [BK][ROW]
  float* dSs = Vs + BK * ROW;       // [BQ][P_STRIDE]
  float* lse_s = dSs + BQ * P_STRIDE;
  float* dl_s = lse_s + BQ;

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
  const T* og = static_cast<const T*>(a.dout) + b * a.o_sb + h * a.o_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  const int start = a.start ? a.start[b] : 0;
  const int end = a.kv_len ? min(a.kv_len[b], S) : S;

  load_tile(Qs, qg, a.q_ss, q0, S, D);
  load_tile(dOs, og, a.o_ss, q0, S, D);
  load_stats(lse_s, dl_s, a, b, h, q0);

  // dQ ownership: rows warp + NW*i, columns lane + 32*j.
  float acc[BQ / NW][MAXD / 32];
#pragma unroll
  for (int i = 0; i < BQ / NW; ++i)
#pragma unroll
    for (int j = 0; j < MAXD / 32; ++j) acc[i][j] = 0.f;

  const int sr0 = (tid / 16) * 4;
  const int sc0 = tid % 16;

  const int kv_lo = (start / BK) * BK;
  int kv_hi = end;
  if (a.causal) kv_hi = min(kv_hi, q0 + BQ);

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, kg, a.k_ss, k0, S, D);
    load_tile(Vs, vg, a.v_ss, k0, S, D);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores(Qs, dOs, Ks, Vs, sr0, sc0, D, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = sr0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = sc0 + 16 * j;
        const float p =
            visible(a, q0 + r, k0 + c, start, end) ? expf(s[i][j] * a.scale - lse_s[r]) : 0.f;
        // dS enters dS K in K's dtype, as the reference casts it.
        dSs[r * P_STRIDE + c] = round_to<T>(p * (dp[i][j] - dl_s[r]) * a.scale);
      }
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float kk[MAXD / 32];
#pragma unroll
      for (int j = 0; j < MAXD / 32; ++j) kk[j] = Ks[c * ROW + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < BQ / NW; ++i) {
        const float ds = dSs[(warp + NW * i) * P_STRIDE + c];
#pragma unroll
        for (int j = 0; j < MAXD / 32; ++j) acc[i][j] = fmaf(ds, kk[j], acc[i][j]);
      }
    }
  }

  T* dq = static_cast<T*>(a.out0);
#pragma unroll
  for (int i = 0; i < BQ / NW; ++i) {
    const int qp = q0 + warp + NW * i;
    if (qp >= S) continue;
    const long long row = (static_cast<long long>(b) * S + qp) * a.H + h;
#pragma unroll
    for (int j = 0; j < MAXD / 32; ++j) {
      const int c = lane + 32 * j;
      if (c < D) dq[row * D + c] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) dkv_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* Ks = smem;                 // [BK][ROW]
  float* Vs = Ks + BK * ROW;        // [BK][ROW]
  float* Qs = Vs + BK * ROW;        // [BQ][ROW]
  float* dOs = Qs + BQ * ROW;       // [BQ][ROW]
  float* Ps = dOs + BQ * ROW;       // [BQ][P_STRIDE], P in dO's dtype
  float* dSs = Ps + BQ * P_STRIDE;  // [BQ][P_STRIDE], dS in Q's dtype
  float* lse_s = dSs + BQ * P_STRIDE;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bkv = blockIdx.y;
  const int b = bkv / a.Hkv;
  const int kvh = bkv % a.Hkv;
  const int groups = a.H / a.Hkv;
  const int k0 = blockIdx.x * BK;
  const int S = a.S;
  const int D = a.D;

  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  const int start = a.start ? a.start[b] : 0;
  const int end = a.kv_len ? min(a.kv_len[b], S) : S;

  load_tile(Ks, kg, a.k_ss, k0, S, D);
  load_tile(Vs, vg, a.v_ss, k0, S, D);

  // dK/dV ownership: KV rows warp + NW*i, columns lane + 32*j.
  float acc_k[BK / NW][MAXD / 32], acc_v[BK / NW][MAXD / 32];
#pragma unroll
  for (int i = 0; i < BK / NW; ++i)
#pragma unroll
    for (int j = 0; j < MAXD / 32; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int sr0 = (tid / 16) * 4;
  const int sc0 = tid % 16;

  // A tile wholly inside the left pad or at/after kv_len has zero dK/dV.
  const bool live = k0 + BK - 1 >= start && k0 < end;
  // First Q tile that sees this KV tile under causality.
  const int q_first = a.causal ? (k0 / BQ) * BQ : 0;

  for (int g = 0; live && g < groups; ++g) {
    const int h = kvh * groups + g;
    const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* og = static_cast<const T*>(a.dout) + b * a.o_sb + h * a.o_sh;
    for (int q0 = q_first; q0 < S; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      load_tile(Qs, qg, a.q_ss, q0, S, D);
      load_tile(dOs, og, a.o_ss, q0, S, D);
      load_stats(lse_s, dl_s, a, b, h, q0);
      __syncthreads();

      float s[4][4], dp[4][4];
      scores(Qs, dOs, Ks, Vs, sr0, sc0, D, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = sr0 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = sc0 + 16 * j;
          const float p =
              visible(a, q0 + r, k0 + c, start, end) ? expf(s[i][j] * a.scale - lse_s[r]) : 0.f;
          // P enters P^T dO in dO's dtype, dS enters dS^T Q in Q's dtype.
          Ps[r * P_STRIDE + c] = round_to<T>(p);
          dSs[r * P_STRIDE + c] = round_to<T>(p * (dp[i][j] - dl_s[r]) * a.scale);
        }
      }
      __syncthreads();

      for (int r = 0; r < BQ; ++r) {
        float ov[MAXD / 32], qv[MAXD / 32];
#pragma unroll
        for (int j = 0; j < MAXD / 32; ++j) {
          ov[j] = dOs[r * ROW + lane + 32 * j];
          qv[j] = Qs[r * ROW + lane + 32 * j];
        }
#pragma unroll
        for (int i = 0; i < BK / NW; ++i) {
          const int c = warp + NW * i;
          const float p = Ps[r * P_STRIDE + c];
          const float ds = dSs[r * P_STRIDE + c];
#pragma unroll
          for (int j = 0; j < MAXD / 32; ++j) {
            acc_v[i][j] = fmaf(p, ov[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(ds, qv[j], acc_k[i][j]);
          }
        }
      }
    }
  }

  T* dk = static_cast<T*>(a.out0);
  T* dv = static_cast<T*>(a.out1);
#pragma unroll
  for (int i = 0; i < BK / NW; ++i) {
    const int kp = k0 + warp + NW * i;
    if (kp >= S) continue;
    const long long row = (static_cast<long long>(b) * S + kp) * a.Hkv + kvh;
#pragma unroll
    for (int j = 0; j < MAXD / 32; ++j) {
      const int c = lane + 32 * j;
      if (c < D) {
        dk[row * D + c] = from_f<T>(acc_k[i][j]);
        dv[row * D + c] = from_f<T>(acc_v[i][j]);
      }
    }
  }
}

int launch(void (*kernel)(BwdArgs), size_t smem, dim3 grid, const BwdArgs& a,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, const int* start,
                  const int* kv_len, void* out0, void* out1, int B, int S, int H,
                  int Hkv, int D, const long long* st, float scale, int causal) {
  return BwdArgs{q, k, v, dout, lse, delta, start, kv_len, out0, out1, B, S, H, Hkv, D,
                 st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                 st[9], st[10], st[11], scale, causal};
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) of q, k, v and dO in turn.
// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() of its
// launch.
extern "C" int flash_bwd_dq_scalar(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   const int* start, const int* kv_len, void* dq, int B,
                                   int S, int H, int Hkv, int D, const long long* strides,
                                   float scale, int causal, int dtype, void* stream) {
  if (D > MAXD || D < 1 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, start, kv_len, dq, nullptr, B, S,
                              H, Hkv, D, strides, scale, causal);
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch(dq_kernel<__nv_bfloat16>, kDqSmem, grid, a, s);
  if (dtype == 0) return launch(dq_kernel<float>, kDqSmem, grid, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv_scalar(const void* q, const void* k, const void* v,
                                    const void* dout, const float* lse, const float* delta,
                                    const int* start, const int* kv_len, void* dk, void* dv,
                                    int B, int S, int H, int Hkv, int D,
                                    const long long* strides, float scale, int causal,
                                    int dtype, void* stream) {
  if (D > MAXD || D < 1 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, start, kv_len, dk, dv, B, S, H,
                              Hkv, D, strides, scale, causal);
  const dim3 grid((S + BK - 1) / BK, B * Hkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch(dkv_kernel<__nv_bfloat16>, kDkvSmem, grid, a, s);
  if (dtype == 0) return launch(dkv_kernel<float>, kDkvSmem, grid, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

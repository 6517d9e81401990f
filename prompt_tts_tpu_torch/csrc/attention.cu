// Attention forward for Hopper (sm_90a): softmax(q k^T * D^-1/2 + key_bias) v.
//
// Replaces the TPU kernel prompt_tts_tpu/ops/pallas/attention.py:flash_attention
// (_attn_kernel / _flash_fwd_impl).  Same contract: q [B,Tq,H,D], k/v
// [B,Tk,H,D] at f32 or bf16, an optional additive key-only bias [B,Tk] (f32),
// f32 scores and softmax statistics, output at q's dtype in [B,Tq,H,D].
// Optionally it also writes each row's f32 log-sum-exp lse [B,H,Tq] of the
// scaled, biased scores, which the training backward (attention_bwd.cu)
// uses to recompute the probabilities; with a null lse pointer nothing is
// written and the kernel is the inference forward.
//
// Design.  One CTA owns a 64-row query block of one (head, batch): 4 warps of
// 16 query rows each.  K/V stream through shared memory in 64-key tiles and
// an online softmax (f32 running max, sum and accumulator per row) folds each
// tile in, so no [Tq,Tk] score matrix is written to device memory and the
// K/V panel never has to fit on chip at once (the TPU kernel held the whole
// panel in VMEM; an SM has 227 KB).  Heads are addressed through strides, so
// the projection output is consumed and the result written in [B,T,H,D]
// with no transposes at the boundary.  Ragged Tq/Tk tails are masked by
// bounds: rows past Tq are not stored, keys past Tk get probability 0.
//
// What bounds it.  Scores and PV run on the CUDA cores in f32 (bf16 inputs
// are widened as they are staged into shared memory, and p stays f32 for
// PV where the TPU kernel rounded it to bf16).  At the slice's shapes the
// kernel is bound by shared-memory operand traffic and FMA issue, not by
// device memory: K/V tiles are reused by all 64 query rows of the CTA.
// Tensor cores (wgmma) and TMA staging are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C interface,
// loaded with ctypes by prompt_tts_tpu_torch/ops/cuda/attention.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;   // query rows per warp (16)
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
constexpr int smem_bytes() {
  // Qs[kBQ][D] + Ks[kBK][D+1] + Vs[kBK][D] + Ps[kWarps][kRows][kBK] + bias[kBK]
  return 4 * (kBQ * D + kBK * (D + 1) + kBK * D + kWarps * kRows * kBK + kBK);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                T* __restrict__ o, float* __restrict__ lse, int Tq, int Tk,
                int H, float scale,
                long long sqb, long long sqt, long long sqh,
                long long skb, long long skt, long long skh,
                long long svb, long long svt, long long svh,
                long long sob, long long sot, long long soh) {
  constexpr int NC = D / 32;   // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBQ][D]
  float* Ks = Qs + kBQ * D;               // [kBK][D+1] (padded: lanes read rows)
  float* Vs = Ks + kBK * (D + 1);         // [kBK][D]
  float* Ps = Vs + kBK * D;               // [kWarps][kRows][kBK]
  float* Bs = Ps + kWarps * kRows * kBK;  // [kBK]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    Qs[e] = (q0 + r < Tq) ? to_f32(qb[(q0 + r) * sqt + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  const float* Qw = Qs + warp * kRows * D;
  float* Pw = Ps + warp * kRows * kBK;

  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    const int kn = min(kBK, Tk - k0);
    __syncthreads();  // previous tile fully consumed (and Qs staged)
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const bool ok = j < kn;
      Ks[j * (D + 1) + d] = ok ? to_f32(kb[(k0 + j) * skt + d]) : 0.f;
      Vs[j * D + d] = ok ? to_f32(vb[(k0 + j) * svt + d]) : 0.f;
    }
    for (int j = tid; j < kBK; j += kThreads)
      Bs[j] = (j < kn && bias != nullptr) ? bias[(long long)b * Tk + k0 + j] : 0.f;
    __syncthreads();

    // scores: this lane's keys are (lane, lane + 32) for each of the warp's rows
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float k0v = Ks[lane * (D + 1) + d];
      const float k1v = Ks[(lane + 32) * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = Qw[r * D + d];
        s[r][0] = fmaf(qv, k0v, s[r][0]);
        s[r][1] = fmaf(qv, k1v, s[r][1]);
      }
    }

    const bool ok0 = lane < kn, ok1 = lane + 32 < kn;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float a = ok0 ? s[r][0] * scale + Bs[lane] : -CUDART_INF_F;
      const float c = ok1 ? s[r][1] * scale + Bs[lane + 32] : -CUDART_INF_F;
      float mt = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      // every tile holds at least one valid key, so m_new is finite
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      const float p0 = expf(a - m_new);
      const float p1 = expf(c - m_new);
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) acc[r][cc] *= alpha;
      Pw[r * kBK + lane] = p0;
      Pw[r * kBK + lane + 32] = p1;
    }
    __syncwarp();

    for (int j = 0; j < kn; ++j) {
      float vv[NC];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) vv[cc] = Vs[j * D + lane + 32 * cc];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = Pw[r * kBK + j];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) acc[r][cc] = fmaf(p, vv[cc], acc[r][cc]);
      }
    }
    __syncwarp();
  }

  T* ob = o + b * sob + h * soh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = q0 + warp * kRows + r;
    if (t < Tq) {
      const float inv = 1.f / l[r];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
        store(ob + t * sot + lane + 32 * cc, acc[r][cc] * inv);
      if (lse != nullptr && lane == 0)
        lse[((long long)b * H + h) * Tq + t] = m[r] + logf(l[r]);
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   void* o, void* lse, int B, int Tq, int Tk, int H, const long long* st,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  auto kern = attn_fwd_kernel<D, T>;
  // The shared-memory opt-in holds per device: one bit per device this
  // template instance has been configured on.
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(configured & bit)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    configured |= bit;
  }
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), static_cast<float*>(lse), Tq, Tk, H, rsqrtf((float)D),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* bias, void* o, void* lse, int B, int Tq,
                       int Tk, int H, const long long* st, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32, T>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, stream);
    case 64: return launch<64, T>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, stream);
    case 96: return launch<96, T>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, stream);
    case 128: return launch<128, T>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (batch,
// time, head) for q, k, v, o in that order; the head_dim stride must be 1.
// bias: [B, Tk] float32 or null.  lse: [B, H, Tq] float32 out, or null.
// Returns cudaGetLastError() after launch.
extern "C" int ptts_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* bias, void* o, void* lse, int B, int Tq,
                                  int Tk, int H, int D, int dtype,
                                  const long long* strides, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, bias, o, lse, B, Tq, Tk, H, strides, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, bias, o, lse, B, Tq, Tk, H, strides, s);
  return cudaErrorInvalidValue;
}

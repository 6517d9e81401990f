// Attention backward for Hopper (sm_90a): dq, dk, dv and the key-bias
// gradient of o = softmax(q k^T * scale + key_bias) v.
//
// Replaces the TPU kernel prompt_tts_tpu/ops/pallas/attention_bwd.py:
// attention_fused_bwd (_attn_bwd_kernel / _bwd_impl).  Same contract:
// q, o, do [B,Tq,H,D] and k, v [B,Tk,H,D] at f32 or bf16 (D in 32/64/96/128),
// an optional additive key bias [B,Tk] f32, and the forward's f32 row
// log-sum-exp lse [B,H,Tq] (attention.cu writes it).  With
// p = exp(s*scale + bias - lse) recomputed in f32 and
// delta = rowsum(do * o):
//   dv = p^T do,  ds = p * (do v^T - delta),
//   dq = ds k * scale,  dk = ds^T q * scale,  dbias = sum_{h, q rows} ds.
// dq/dk/dv are written at the input dtype from f32 accumulators; the bias
// gradient is written per head, [B,H,Tk] f32, and the caller sums the heads.
//
// Design.  The TPU kernel walks the q blocks of a batch row in order and
// keeps dk/dv resident in VMEM across them.  CUDA blocks run in no order,
// so the work is split into two launches on one stream, with no atomics
// (the same bits on every run):
//   1. dq pass, grid (ceil(Tq/64), H, B): a CTA owns 64 query rows, computes
//      their delta (written out for pass 2), then loops over 64-key tiles,
//      recomputes p and ds and accumulates dq.
//   2. dk/dv pass, grid (ceil(Tk/64), H, B): a CTA owns 64 keys, keeps its
//      K/V tile and the f32 dk/dv accumulators on chip and loops over every
//      64-row query tile, recomputing p and ds and accumulating dk, dv and
//      the per-head bias gradient.
// Each recomputes the score tile once (pass 1 for dq, pass 2 for dk/dv), so
// the card does 7 of the TPU kernel's 5 [T,T,D] products; no [Tq,Tk] tensor
// touches device memory.  256 threads as a 16 x 16 grid own strided 4 x 4
// micro-tiles (rows ty + 16i, columns tx + 16j), so shared-memory reads are
// conflict-free or broadcast; the dk/dv/dq accumulators are 4 x D/16 per
// thread.  Ragged Tq/Tk tails are masked by bounds (p = ds = 0 there), and
// heads are addressed through the [B,T,H,D] layout, with no transposes.
//
// What bounds it.  All products run on the CUDA cores in f32 (bf16 inputs
// are widened as they are staged; p and ds stay f32 where the TPU kernel
// rounded them to bf16), reading their operands from shared memory: it is
// bound by FMA issue and shared-memory bandwidth, far from the tensor-core
// bound of the same work.  wgmma, TMA staging and split-K come later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C interface,
// loaded with ctypes by prompt_tts_tpu_torch/ops/cuda/attention_bwd.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kB = 64;            // query rows per q tile, keys per k tile
constexpr int kTy = 16;           // thread grid 16 x 16
constexpr int kThreads = kTy * kTy;
constexpr int kLdp = kB + 1;      // padded row of a [64][64] p/ds tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Rows [0, n) of a [rows, H*D] panel (row stride ld elements) into a padded
// f32 tile dst[64][D+1]; rows n..63 are zero.
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ld,
                                      int n) {
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = r < n ? to_f32(src[r * ld + d]) : 0.f;
  }
}

// s = Q K^T and dp = dO V^T for this thread's rows ty + 16i and columns
// tx + 16j of a 64 x 64 tile.
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int ty, int tx, float s[4][4],
                                       float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty + kTy * i) * (D + 1) + d];
      ov[i] = dOs[(ty + kTy * i) * (D + 1) + d];
      kv[i] = Ks[(tx + kTy * i) * (D + 1) + d];
      vv[i] = Vs[(tx + kTy * i) * (D + 1) + d];
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

template <int D>
constexpr int dq_smem_bytes() {
  // Qs, dOs, Ks, Vs [64][D+1]; dSs [64][65]; lse, delta, bias [64]
  return 4 * (4 * kB * (D + 1) + kB * kLdp + 3 * kB);
}

template <int D>
constexpr int dkv_smem_bytes() {
  // Qs, dOs, Ks, Vs [64][D+1]; Ps, dSs [64][65]; lse, delta, bias [64]
  return 4 * (4 * kB * (D + 1) + 2 * kB * kLdp + 3 * kB);
}

// Pass 1: delta and dq for 64 query rows of one (head, batch).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ o,
                   const T* __restrict__ dout, const float* __restrict__ bias,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   T* __restrict__ dq, int Tq, int Tk, int H, float scale) {
  constexpr int NJ = D / kTy;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * (D + 1);
  float* Ks = dOs + kB * (D + 1);
  float* Vs = Ks + kB * (D + 1);
  float* dSs = Vs + kB * (D + 1);
  float* Ls = dSs + kB * kLdp;
  float* Ds = Ls + kB;
  float* Bs = Ds + kB;

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qn = min(kB, Tq - q0);
  const int tx = threadIdx.x % kTy, ty = threadIdx.x / kTy;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long ld = (long long)H * D;                  // row stride
  const long long qoff = ((long long)b * Tq + q0) * ld + (long long)h * D;
  const long long koff = (long long)b * Tk * ld + (long long)h * D;
  const long long row0 = ((long long)b * H + h) * Tq + q0;   // lse/delta

  stage<D>(Qs, q + qoff, ld, qn);
  stage<D>(dOs, dout + qoff, ld, qn);
  // delta = rowsum(do * o), one warp per row, o read straight from memory
  for (int r = warp; r < kB; r += kThreads / 32) {
    float acc = 0.f;
    if (r < qn)
      for (int d = lane; d < D; d += 32)
        acc = fmaf(to_f32(dout[qoff + r * ld + d]),
                   to_f32(o[qoff + r * ld + d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      Ds[r] = acc;
      Ls[r] = r < qn ? lse[row0 + r] : 0.f;
      if (r < qn) delta[row0 + r] = acc;
    }
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += kB) {
    const int kn = min(kB, Tk - k0);
    __syncthreads();   // previous tile consumed (and Qs/dOs/Ds/Ls staged)
    stage<D>(Ks, k + koff + k0 * ld, ld, kn);
    stage<D>(Vs, v + koff + k0 * ld, ld, kn);
    for (int j = threadIdx.x; j < kB; j += kThreads)
      Bs[j] = (j < kn && bias != nullptr) ? bias[(long long)b * Tk + k0 + j] : 0.f;
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + kTy * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + kTy * j;
        float ds = 0.f;
        if (r < qn && c < kn) {
          const float p = expf(s[i][j] * scale + Bs[c] - Ls[r]);
          ds = p * (dp[i][j] - Ds[r]);
        }
        dSs[r * kLdp + c] = ds;
      }
    }
    __syncthreads();

    for (int c = 0; c < kn; ++c) {
      float dsv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + kTy * i) * kLdp + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[c * (D + 1) + tx + kTy * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + kTy * i;
    if (r < qn) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        store(dq + qoff + r * ld + tx + kTy * j, acc[i][j] * scale);
    }
  }
}

// Pass 2: dk, dv and the per-head bias gradient for 64 keys of one
// (head, batch).  Reads the delta that pass 1 wrote.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ bias,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, float* __restrict__ dbias_h, int Tq,
                    int Tk, int H, float scale) {
  constexpr int NJ = D / kTy;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * (D + 1);
  float* Ks = dOs + kB * (D + 1);
  float* Vs = Ks + kB * (D + 1);
  float* Ps = Vs + kB * (D + 1);
  float* dSs = Ps + kB * kLdp;
  float* Ls = dSs + kB * kLdp;
  float* Ds = Ls + kB;
  float* Bs = Ds + kB;

  const int k0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kn = min(kB, Tk - k0);
  const int tx = threadIdx.x % kTy, ty = threadIdx.x / kTy;
  const long long ld = (long long)H * D;
  const long long koff = ((long long)b * Tk + k0) * ld + (long long)h * D;
  const long long qbase = (long long)b * Tq * ld + (long long)h * D;
  const long long rowb = ((long long)b * H + h) * Tq;

  stage<D>(Ks, k + koff, ld, kn);
  stage<D>(Vs, v + koff, ld, kn);
  for (int j = threadIdx.x; j < kB; j += kThreads)
    Bs[j] = (j < kn && bias != nullptr) ? bias[(long long)b * Tk + k0 + j] : 0.f;

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  float db_acc = 0.f;   // threads 0..63: the bias gradient of key k0 + tid

  for (int q0 = 0; q0 < Tq; q0 += kB) {
    const int qn = min(kB, Tq - q0);
    __syncthreads();   // previous tile consumed (and Ks/Vs/Bs staged)
    stage<D>(Qs, q + qbase + q0 * ld, ld, qn);
    stage<D>(dOs, dout + qbase + q0 * ld, ld, qn);
    for (int r = threadIdx.x; r < kB; r += kThreads) {
      Ls[r] = r < qn ? lse[rowb + q0 + r] : 0.f;
      Ds[r] = r < qn ? delta[rowb + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + kTy * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + kTy * j;
        float p = 0.f, ds = 0.f;
        if (r < qn && c < kn) {
          p = expf(s[i][j] * scale + Bs[c] - Ls[r]);
          ds = p * (dp[i][j] - Ds[r]);
        }
        Ps[r * kLdp + c] = p;
        dSs[r * kLdp + c] = ds;
      }
    }
    __syncthreads();

    // this thread's keys are ty + 16i, its columns tx + 16j
    for (int r = 0; r < qn; ++r) {
      float pv[4], dsv[4], ov[NJ], qv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * kLdp + ty + kTy * i];
        dsv[i] = dSs[r * kLdp + ty + kTy * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        ov[j] = dOs[r * (D + 1) + tx + kTy * j];
        qv[j] = Qs[r * (D + 1) + tx + kTy * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
    }
    if (dbias_h != nullptr && threadIdx.x < kB) {
      float col = 0.f;
      for (int r = 0; r < qn; ++r) col += dSs[r * kLdp + threadIdx.x];
      db_acc += col;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + kTy * i;
    if (c < kn) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        store(dk + koff + c * ld + tx + kTy * j, dk_acc[i][j] * scale);
        store(dv + koff + c * ld + tx + kTy * j, dv_acc[i][j]);
      }
    }
  }
  if (dbias_h != nullptr && threadIdx.x < kn)
    dbias_h[((long long)b * H + h) * Tk + k0 + threadIdx.x] = db_acc;
}

// The shared-memory opt-in holds per device: one bit per device a kernel
// instance has been configured on.
template <typename K>
cudaError_t opt_in(K kern, int smem, unsigned long long* configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(*configured & bit)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    *configured |= bit;
  }
  return cudaSuccess;
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* bias, const void* lse,
                   void* dq, void* dk, void* dv, void* dbias_h, void* delta,
                   int B, int Tq, int Tk, int H, float scale,
                   cudaStream_t stream) {
  static unsigned long long configured_dq = 0, configured_dkv = 0;
  auto kdq = attn_bwd_dq_kernel<D, T>;
  auto kdkv = attn_bwd_dkv_kernel<D, T>;
  cudaError_t err = opt_in(kdq, dq_smem_bytes<D>(), &configured_dq);
  if (err != cudaSuccess) return err;
  err = opt_in(kdkv, dkv_smem_bytes<D>(), &configured_dkv);
  if (err != cudaSuccess) return err;
  dim3 gq((Tq + kB - 1) / kB, H, B);
  kdq<<<gq, kThreads, dq_smem_bytes<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(bias),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), Tq, Tk, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gk((Tk + kB - 1) / kB, H, B);
  kdkv<<<gk, kThreads, dkv_smem_bytes<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(bias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(dbias_h), Tq, Tk, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* bias,
                       const void* lse, void* dq, void* dk, void* dv,
                       void* dbias_h, void* delta, int B, int Tq, int Tk,
                       int H, float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch<32, T>(q, k, v, o, dout, bias, lse, dq, dk, dv, dbias_h, delta, B, Tq, Tk, H, scale, s);
    case 64: return launch<64, T>(q, k, v, o, dout, bias, lse, dq, dk, dv, dbias_h, delta, B, Tq, Tk, H, scale, s);
    case 96: return launch<96, T>(q, k, v, o, dout, bias, lse, dq, dk, dv, dbias_h, delta, B, Tq, Tk, H, scale, s);
    case 128: return launch<128, T>(q, k, v, o, dout, bias, lse, dq, dk, dv, dbias_h, delta, B, Tq, Tk, H, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Two launches on `stream`: the dq pass (which also writes delta [B,H,Tq]
// f32 scratch) and then the dk/dv pass.  dtype: 0 = float32, 1 = bfloat16.
// Every tensor is contiguous: q, o, dout, dq [B,Tq,H,D]; k, v, dk, dv
// [B,Tk,H,D]; lse and delta [B,H,Tq] f32; bias [B,Tk] f32 or null; dbias_h
// [B,H,Tk] f32 out, or null to skip the bias gradient.  Returns the first
// launch error, else cudaGetLastError() after the second launch.
extern "C" int ptts_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* bias, const void* lse, void* dq,
                                  void* dk, void* dv, void* dbias_h,
                                  void* delta, int B, int Tq, int Tk, int H,
                                  int D, int dtype, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, dout, bias, lse, dq, dk, dv,
                             dbias_h, delta, B, Tq, Tk, H, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, dout, bias, lse, dq, dk,
                                     dv, dbias_h, delta, B, Tq, Tk, H, scale, s);
  return cudaErrorInvalidValue;
}

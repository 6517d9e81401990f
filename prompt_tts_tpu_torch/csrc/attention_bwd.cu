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
// Design, both dtypes.  The TPU kernel walks the q blocks of a batch row in
// order and keeps dk/dv resident in VMEM across them.  CUDA blocks run in no
// order, so the work is split into two launches on one stream, with no
// atomics (the same bits on every run):
//   1. dq pass, grid (ceil(Tq/64), H, B): a CTA owns 64 query rows, computes
//      their delta (written out for pass 2), then loops over 64-key tiles,
//      recomputes p and ds and accumulates dq.
//   2. dk/dv pass, grid (ceil(Tk/64), H, B): a CTA owns 64 keys, keeps its
//      K/V tile and the f32 dk/dv accumulators on chip and loops over every
//      64-row query tile, recomputing p and ds and accumulating dk, dv and
//      the per-head bias gradient.
// Each pass recomputes the score tile, so the card does 7 [T,T,D] products
// where the TPU kernel did 5, and 2 exps a score where it did 1; no
// [Tq,Tk] tensor touches device memory.  Ragged Tq/Tk tails are masked
// (p = ds = 0 there), and heads are addressed through the [B,T,H,D] layout.
//
// bf16: tensor cores (attn_bwd_*_tc_kernel), one warpgroup a CTA.  Every
// product is wgmma with f32 accumulation; p and ds*scale are rounded to
// bf16 before their products, as the TPU kernel does (attention_bwd.py:95,
// 110).  dq pass, per key tile: S = Q K^T and dP = dO V^T (m64n64k16, both
// operands in shared memory, K-major), P = exp2(S scale log2e + bias log2e
// - lse log2e) with the rows' lse and delta in registers, dS = P (dP -
// delta), dQ += (dS scale as bf16) K (m64nDk16, the bf16 dS from registers
// as A, the K tile [keys][D] as the transposed B).  dk/dv pass, per q tile:
// S^T = K Q^T and dP^T = V dO^T, P^T with the tile's lse from shared
// memory, dV += (P^T as bf16) dO, dS^T = P^T (dP^T - delta), dK += (dS^T
// scale as bf16) Q, and the bias gradient adds the rows of dS^T in f32.
// Tiles stream through a 2-stage ring of cp.async 16-byte copies (the next
// tile's copies overlap this tile's products) in wgmma's unswizzled
// core-matrix layout (wgmma.cuh).
//   What bounds it.  The seven products are 14 D flops a score against two
//   exps (~470 bf16 flops at the card's peaks, 16 exps a clock per SM): at
//   D = 32 the exps weigh as much as the tensor cores, above it the
//   products; device memory is read once per input and per 64-row block,
//   from L2 mostly.  The CUDA-core version this replaces ran the products
//   as f32 FMAs from shared memory, 8 x behind the library's backward.  This
//   one is bound by latency: within a tile the score products, the
//   elementwise p and ds, and the gradient products run one after another.
//
// f32: CUDA cores (attn_bwd_*_f32_kernel), kept for the f32 contracts,
// which TF32 tensor cores would miss.  256 threads as a 16 x 16 grid own
// strided 4 x 4 micro-tiles (rows ty + 16i, columns tx + 16j), so
// shared-memory reads are conflict-free or broadcast; p and ds stay f32.
// Bound by FMA issue and shared-memory bandwidth.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C interface,
// loaded with ctypes by prompt_tts_tpu_torch/ops/cuda/attention_bwd.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace ptts;

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

// ---------------------------------------------------------------- f32 ----

constexpr int kB = 64;            // query rows per q tile, keys per k tile
constexpr int kTy = 16;           // thread grid 16 x 16
constexpr int kThreads = kTy * kTy;
constexpr int kLdp = kB + 1;      // padded row of a [64][64] p/ds tile

// Rows [0, n) of a [rows, H*D] panel (row stride ld elements) into a padded
// f32 tile dst[64][D+1]; rows n..63 are zero.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, long long ld,
                                      int n) {
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = r < n ? src[r * ld + d] : 0.f;
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
constexpr int dq_f32_smem_bytes() {
  // Qs, dOs, Ks, Vs [64][D+1]; dSs [64][65]; lse, delta, bias [64]
  return 4 * (4 * kB * (D + 1) + kB * kLdp + 3 * kB);
}

template <int D>
constexpr int dkv_f32_smem_bytes() {
  // Qs, dOs, Ks, Vs [64][D+1]; Ps, dSs [64][65]; lse, delta, bias [64]
  return 4 * (4 * kB * (D + 1) + 2 * kB * kLdp + 3 * kB);
}

// Pass 1: delta and dq for 64 query rows of one (head, batch).
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ o,
                       const float* __restrict__ dout,
                       const float* __restrict__ bias,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, float* __restrict__ dq,
                       int Tq, int Tk, int H, float scale) {
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
        acc = fmaf(dout[qoff + r * ld + d], o[qoff + r * ld + d], acc);
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
        dq[qoff + r * ld + tx + kTy * j] = acc[i][j] * scale;
    }
  }
}

// Pass 2: dk, dv and the per-head bias gradient for 64 keys of one
// (head, batch).  Reads the delta that pass 1 wrote.
template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ bias,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float* __restrict__ dbias_h, int Tq, int Tk, int H,
                        float scale) {
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
        dk[koff + c * ld + tx + kTy * j] = dk_acc[i][j] * scale;
        dv[koff + c * ld + tx + kTy * j] = dv_acc[i][j];
      }
    }
  }
  if (dbias_h != nullptr && threadIdx.x < kn)
    dbias_h[((long long)b * H + h) * Tk + k0 + threadIdx.x] = db_acc;
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* bias,
                       const void* lse, void* dq, void* dk, void* dv,
                       void* dbias_h, void* delta, int B, int Tq, int Tk,
                       int H, float scale, cudaStream_t stream) {
  static unsigned long long configured_dq = 0, configured_dkv = 0;
  auto kdq = attn_bwd_dq_f32_kernel<D>;
  auto kdkv = attn_bwd_dkv_f32_kernel<D>;
  cudaError_t err = opt_in(kdq, dq_f32_smem_bytes<D>(), &configured_dq);
  if (err != cudaSuccess) return err;
  err = opt_in(kdkv, dkv_f32_smem_bytes<D>(), &configured_dkv);
  if (err != cudaSuccess) return err;
  dim3 gq((Tq + kB - 1) / kB, H, B);
  kdq<<<gq, kThreads, dq_f32_smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(bias),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<float*>(dq), Tq, Tk, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gk((Tk + kB - 1) / kB, H, B);
  kdkv<<<gk, kThreads, dkv_f32_smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(bias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dbias_h), Tq, Tk, H, scale);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bf16 ----

constexpr int kTcThreads = 128;   // one warpgroup

template <int D>
constexpr int tc_smem_bytes() {
  // six [64][D] bf16 tiles (the CTA's own two, and two of each streamed
  // kind), then two [64] f32 rows in each of 2 stages
  return 6 * kB * D * 2 + 4 * kB * 4;
}

// Pass 1 (bf16): delta and dq for 64 query rows of one (head, batch).
template <int D>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ bias,
                      const float* __restrict__ lse, float* __restrict__ delta,
                      bf16* __restrict__ dq, int Tq, int Tk, int H,
                      float scale) {
  constexpr int kTileBytes = kB * D * 2;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sQ = smem_u32(tc_smem);
  const uint32_t sdO = sQ + kTileBytes;
  const uint32_t sK = sdO + kTileBytes;      // 2 stages
  const uint32_t sV = sK + 2 * kTileBytes;   // 2 stages
  float* Ls = reinterpret_cast<float*>(tc_smem + 6 * kTileBytes);   // [64]
  float* Ds = Ls + kB;                                           // [64]

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qn = min(kB, Tq - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4;   // accumulator rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);         // columns c0, c0 + 1 of every 8
  const long long ld = (long long)H * D;                  // row stride
  const long long qoff = ((long long)b * Tq + q0) * ld + (long long)h * D;
  const long long koff = (long long)b * Tk * ld + (long long)h * D;
  const long long row0 = ((long long)b * H + h) * Tq + q0;   // lse/delta
  const float scale_log2 = scale * kLog2e;
  const float* biasb = bias != nullptr ? bias + (long long)b * Tk : nullptr;

  load_tile<D, kTcThreads>(sQ, q + qoff, ld, qn, kB);
  load_tile<D, kTcThreads>(sdO, dout + qoff, ld, qn, kB);
  cp_async_commit();
  load_tile<D, kTcThreads>(sK, k + koff, ld, Tk, kB);
  load_tile<D, kTcThreads>(sV, v + koff, ld, Tk, kB);
  cp_async_commit();

  {  // delta = rowsum(do * o): two threads a row, half of D each
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    float acc = 0.f;
    if (r < qn) {
      const long long off = qoff + r * ld + half * (D / 2);
#pragma unroll
      for (int d = 0; d < D / 2; d += 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(dout + off + d);
        const uint4 y = *reinterpret_cast<const uint4*>(o + off + d);
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 a = __bfloat1622float2(x2[i]);
          const float2 c = __bfloat1622float2(y2[i]);
          acc = fmaf(a.x, c.x, acc);
          acc = fmaf(a.y, c.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      Ds[r] = acc;
      Ls[r] = r < qn ? lse[row0 + r] * kLog2e : 0.f;
      if (r < qn) delta[row0 + r] = acc;
    }
  }
  __syncthreads();
  float lse2[2], dl[2];
  bool rok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = Ls[r0 + 8 * r];
    dl[r] = Ds[r0 + 8 * r];
    rok[r] = r0 + 8 * r < qn;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const int ntiles = (Tk + kB - 1) / kB;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kB;
    const uint32_t tK = sK + (it & 1) * kTileBytes;
    const uint32_t tV = sV + (it & 1) * kTileBytes;
    if (it + 1 < ntiles) {   // the next tile's copies fly during this one
      const long long next = koff + (k0 + kB) * ld;
      load_tile<D, kTcThreads>(sK + ((it + 1) & 1) * kTileBytes, k + next, ld,
                               Tk - k0 - kB, kB);
      load_tile<D, kTcThreads>(sV + ((it + 1) & 1) * kTileBytes, v + next, ld,
                               Tk - k0 - kB, kB);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(s, kmajor_desc<D>(sQ, ks), kmajor_desc<D>(tK, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(dp, kmajor_desc<D>(sdO, ks), kmajor_desc<D>(tV, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // s <- ds * scale, from p = exp2(s scale log2e + bias log2e - lse log2e)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + c0 + e;
        const bool ok = col < Tk;
        const float bl = (ok && biasb != nullptr) ? __ldg(biasb + col) * kLog2e
                                                  : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          const float p = (ok && rok[r])
              ? ex2(fmaf(s[i], scale_log2, bl - lse2[r])) : 0.f;
          s[i] = p * (dp[i] - dl[r]) * scale;
        }
      }
    }
    uint32_t a[4][4];
    acc_to_a(s, a);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
      wgmma_rs(acc, a[t], mnmajor_desc<D>(tK, t), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();   // this stage is free for the copies of tile it + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rok[r]) {
      bf16* row = dq + qoff + (r0 + 8 * r) * ld;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j + c0) =
            pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// Pass 2 (bf16): dk, dv and the per-head bias gradient for 64 keys of one
// (head, batch).  Reads the delta that pass 1 wrote.
template <int D>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ bias,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, float* __restrict__ dbias_h,
                       int Tq, int Tk, int H, float scale) {
  constexpr int kTileBytes = kB * D * 2;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sK = smem_u32(tc_smem);
  const uint32_t sV = sK + kTileBytes;
  const uint32_t sQ = sV + kTileBytes;       // 2 stages
  const uint32_t sdO = sQ + 2 * kTileBytes;  // 2 stages
  float* Ls = reinterpret_cast<float*>(tc_smem + 6 * kTileBytes);   // [2][64]
  float* Ds = Ls + 2 * kB;                                       // [2][64]

  const int k0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kn = min(kB, Tk - k0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4;   // accumulator rows (keys) r0, r0 + 8
  const int c0 = 2 * (lane % 4);         // columns (q rows) c0, c0 + 1 of 8
  const long long ld = (long long)H * D;
  const long long koff = ((long long)b * Tk + k0) * ld + (long long)h * D;
  const long long qbase = (long long)b * Tq * ld + (long long)h * D;
  const long long rowb = ((long long)b * H + h) * Tq;
  const float scale_log2 = scale * kLog2e;

  // the copies of q tile `it` into stage `st`: Q, dO, and its lse and delta
  auto load_q = [&](int it, int st) {
    const int q0 = it * kB;
    load_tile<D, kTcThreads>(sQ + st * kTileBytes, q + qbase + q0 * ld, ld,
                             Tq - q0, kB);
    load_tile<D, kTcThreads>(sdO + st * kTileBytes, dout + qbase + q0 * ld, ld,
                             Tq - q0, kB);
    const int i = threadIdx.x % kB;
    const float* src = threadIdx.x < kB ? lse : delta;
    float* dst = (threadIdx.x < kB ? Ls : Ds) + st * kB + i;
    const bool ok = q0 + i < Tq;
    cp_async4(smem_u32(dst), ok ? src + rowb + q0 + i : src, ok);
  };

  load_tile<D, kTcThreads>(sK, k + koff, ld, kn, kB);
  load_tile<D, kTcThreads>(sV, v + koff, ld, kn, kB);
  cp_async_commit();
  load_q(0, 0);
  cp_async_commit();

  float bk[2];   // this thread's keys' bias, log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r)
    bk[r] = (bias != nullptr && r0 + 8 * r < kn)
        ? bias[(long long)b * Tk + k0 + r0 + 8 * r] * kLog2e : 0.f;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float db[2] = {0.f, 0.f};   // this thread's part of the keys' bias gradient

  const int ntiles = (Tq + kB - 1) / kB;
  for (int it = 0; it < ntiles; ++it) {
    const int q0 = it * kB;
    const int st = it & 1;
    const uint32_t tQ = sQ + st * kTileBytes;
    const uint32_t tdO = sdO + st * kTileBytes;
    if (it + 1 < ntiles) {   // the next tile's copies fly during this one
      load_q(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(s, kmajor_desc<D>(sK, ks), kmajor_desc<D>(tQ, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(dp, kmajor_desc<D>(sV, ks), kmajor_desc<D>(tdO, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // s <- p^T, dp <- ds^T * scale; the bias gradient takes ds^T unscaled
    const float* L = Ls + st * kB;
    const float* Dl = Ds + st * kB;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + c0 + e;
        const bool ok = q0 + col < Tq;
        const float lq = L[col] * kLog2e;
        const float dlt = Dl[col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          const float p = ok ? ex2(fmaf(s[i], scale_log2, bk[r] - lq)) : 0.f;
          const float ds = p * (dp[i] - dlt);
          db[r] += ds;
          s[i] = p;
          dp[i] = ds * scale;
        }
      }
    }
    uint32_t ap[4][4], ads[4][4];
    acc_to_a(s, ap);
    acc_to_a(dp, ads);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)
      wgmma_rs(dv_acc, ap[t], mnmajor_desc<D>(tdO, t), 1);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      wgmma_rs(dk_acc, ads[t], mnmajor_desc<D>(tQ, t), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();   // this stage is free for the copies of tile it + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
    const int key = r0 + 8 * r;
    if (key < kn) {
      bf16* dkr = dk + koff + key * ld;
      bf16* dvr = dv + koff + key * ld;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkr + 8 * j + c0) =
            pack_bf16(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvr + 8 * j + c0) =
            pack_bf16(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
      if (dbias_h != nullptr && lane % 4 == 0)
        dbias_h[((long long)b * H + h) * Tk + k0 + key] = db[r];
    }
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* bias,
                      const void* lse, void* dq, void* dk, void* dv,
                      void* dbias_h, void* delta, int B, int Tq, int Tk,
                      int H, float scale, cudaStream_t stream) {
  static unsigned long long configured_dq = 0, configured_dkv = 0;
  constexpr int smem = tc_smem_bytes<D>();
  auto kdq = attn_bwd_dq_tc_kernel<D>;
  auto kdkv = attn_bwd_dkv_tc_kernel<D>;
  cudaError_t err = opt_in(kdq, smem, &configured_dq);
  if (err != cudaSuccess) return err;
  err = opt_in(kdkv, smem, &configured_dkv);
  if (err != cudaSuccess) return err;
  dim3 gq((Tq + kB - 1) / kB, H, B);
  kdq<<<gq, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(bias),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<bf16*>(dq), Tq, Tk, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gk((Tk + kB - 1) / kB, H, B);
  kdkv<<<gk, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(bias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(dbias_h), Tq, Tk, H, scale);
  return cudaGetLastError();
}

#define PTTS_BWD_ARGS q, k, v, o, dout, bias, lse, dq, dk, dv, dbias_h, delta, \
                      B, Tq, Tk, H, scale, s

cudaError_t dispatch(int D, int dtype, const void* q, const void* k,
                     const void* v, const void* o, const void* dout,
                     const void* bias, const void* lse, void* dq, void* dk,
                     void* dv, void* dbias_h, void* delta, int B, int Tq,
                     int Tk, int H, float scale, cudaStream_t s) {
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_f32<32>(PTTS_BWD_ARGS);
      case 64: return launch_f32<64>(PTTS_BWD_ARGS);
      case 96: return launch_f32<96>(PTTS_BWD_ARGS);
      case 128: return launch_f32<128>(PTTS_BWD_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (D) {
      case 32: return launch_tc<32>(PTTS_BWD_ARGS);
      case 64: return launch_tc<64>(PTTS_BWD_ARGS);
      case 96: return launch_tc<96>(PTTS_BWD_ARGS);
      case 128: return launch_tc<128>(PTTS_BWD_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

#undef PTTS_BWD_ARGS

}  // namespace

// Two launches on `stream`: the dq pass (which also writes delta [B,H,Tq]
// f32 scratch) and then the dk/dv pass.  dtype: 0 = float32 (CUDA cores),
// 1 = bfloat16 (tensor cores; every pointer 16-byte aligned, which the
// wrapper checks).  Every tensor is contiguous: q, o, dout, dq [B,Tq,H,D];
// k, v, dk, dv [B,Tk,H,D]; lse and delta [B,H,Tq] f32; bias [B,Tk] f32 or
// null; dbias_h [B,H,Tk] f32 out, or null to skip the bias gradient.
// Returns the first launch error, else cudaGetLastError() after the second
// launch.
extern "C" int ptts_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* bias, const void* lse, void* dq,
                                  void* dk, void* dv, void* dbias_h,
                                  void* delta, int B, int Tq, int Tk, int H,
                                  int D, int dtype, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  return dispatch(D, dtype, q, k, v, o, dout, bias, lse, dq, dk, dv, dbias_h,
                  delta, B, Tq, Tk, H, scale, static_cast<cudaStream_t>(stream));
}

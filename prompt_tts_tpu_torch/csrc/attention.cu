// Attention forward for Hopper (sm_90a): softmax(q k^T * D^-1/2 + key_bias) v.
//
// Replaces the TPU kernel prompt_tts_tpu/ops/pallas/attention.py:flash_attention
// (_attn_kernel / _flash_fwd_impl).  Same contract: q [B,Tq,H,D], k/v
// [B,Tk,H,D] at f32 or bf16, an optional additive key-only bias [B,Tk] (f32),
// f32 scores and softmax statistics, output at q's dtype in [B,Tq,H,D].
// Optionally it also writes each row's f32 log-sum-exp lse [B,H,Tq] of the
// scaled, biased scores (natural log), which the training backward
// (attention_bwd.cu) uses to recompute the probabilities; with a null lse
// pointer nothing is written and the kernel is the inference forward.
// Heads are addressed through strides, so the projection output is consumed
// and the result written in [B,T,H,D] with no transposes; ragged Tq/Tk tails
// are masked (rows past Tq are not stored, keys past Tk get probability 0).
// K/V stream through shared memory in 64-key tiles with an online softmax,
// so no [Tq,Tk] matrix touches device memory and the K/V panel never has to
// fit on chip (the TPU kernel held the whole panel in VMEM; an SM has
// 227 KB).  The dtype alone picks one of two kernels:
//
// bf16: tensor cores (attn_fwd_tc_kernel).  The TPU kernel's numerics: f32
// scores plus the f32 bias, f32 max, exp and sum, the unnormalised p rounded
// to bf16 for PV with f32 accumulation, divided by the f32 sum.
//   What bounds it.  The two products are 4 D flops a score against one
//   exp, and an exp weighs as much as ~240 bf16 flops at the card's peaks
//   (16 exps a clock per SM): at D = 32-64 the special-function unit, not
//   the tensor cores, sets the floor; device memory is read once per input
//   (Q once, K/V once per CTA, from L2 mostly).  The
//   CUDA-core version this replaces was bound by shared-memory operand
//   reads of f32 FMAs, 10-14 x behind the library.  This one is bound by
//   latency: within a warpgroup a tile's S product, its softmax and its PV
//   product run one after the other; other CTAs on the SM fill the gaps.
//   Design.  A CTA owns 64 query rows per consumer warpgroup, of one
//   (head, batch): 2 warpgroups, which share the K/V tiles, when the
//   128-row grid still puts a CTA on every SM, else 1 (short sequences at
//   synthesis batches: B = 1-4 gives only 8-480 CTAs of 64 rows).  The Q
//   tile is copied into shared memory once; 64-key K/V tiles stream through
//   a 2-stage ring of cp.async 16-byte copies, the next tile's copies in
//   flight while this tile's products run.  S = Q K^T is wgmma m64n64k16
//   with both operands in shared memory (the K tile [keys][D] is already
//   K-major for B), D/16 steps; the online softmax runs on the f32
//   accumulator fragment in registers (keys >= Tk masked to -inf first in
//   the last tile, since a zero-filled key row scores 0; row max and sum by
//   shuffles within the quad; ex2 of log2e-scaled scores, the scale and the
//   bias folded into one FMA); O += P V is wgmma m64nDk16 with P as bf16
//   registers (the f32 accumulator layout of a 16-bit product is the A
//   fragment layout) and V [keys][D] as the transposed (MN-major) B.  Tiles
//   use wgmma's unswizzled core-matrix layout (wgmma.cuh), which takes
//   every D, 96 included.
//
// f32: CUDA cores (attn_fwd_f32_kernel), kept for the f32 contracts (2e-5
// on the kernel, 5e-4 on the model), which TF32 tensor cores would miss.
// 4 warps of 16 query rows each; f32 FMAs with operands in shared memory,
// p kept in f32.  Bound by shared-memory operand traffic and FMA issue.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C interface,
// loaded with ctypes by prompt_tts_tpu_torch/ops/cuda/attention.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

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

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;   // query rows per warp (16)
constexpr int kThreads = kWarps * 32;

template <int D>
constexpr int f32_smem_bytes() {
  // Qs[kBQ][D] + Ks[kBK][D+1] + Vs[kBK][D] + Ps[kWarps][kRows][kBK] + bias[kBK]
  return 4 * (kBQ * D + kBK * (D + 1) + kBK * D + kWarps * kRows * kBK + kBK);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ bias,
                    float* __restrict__ o, float* __restrict__ lse, int Tq,
                    int Tk, int H, float scale,
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

  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    Qs[e] = (q0 + r < Tq) ? qb[(q0 + r) * sqt + d] : 0.f;
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
      Ks[j * (D + 1) + d] = ok ? kb[(k0 + j) * skt + d] : 0.f;
      Vs[j * D + d] = ok ? vb[(k0 + j) * svt + d] : 0.f;
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

  float* ob = o + b * sob + h * soh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = q0 + warp * kRows + r;
    if (t < Tq) {
      const float inv = 1.f / l[r];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
        ob[t * sot + lane + 32 * cc] = acc[r][cc] * inv;
      if (lse != nullptr && lane == 0)
        lse[((long long)b * H + h) * Tq + t] = m[r] + logf(l[r]);
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* bias, void* o, void* lse, int B, int Tq,
                       int Tk, int H, const long long* st,
                       cudaStream_t stream) {
  static unsigned long long configured = 0;
  constexpr int smem = f32_smem_bytes<D>();
  auto kern = attn_fwd_f32_kernel<D>;
  cudaError_t err = opt_in(kern, smem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(lse), Tq, Tk, H,
      rsqrtf((float)D), st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bf16 ----

constexpr int kTile = 64;   // query rows a warpgroup owns
constexpr int kKeys = 64;   // keys a K/V tile holds (128 measured slower)

template <int D, int NWG>
constexpr int tc_smem_bytes() {
  // Q [NWG * 64][D], then K and V [kKeys][D] in each of 2 stages, bf16
  return 2 * D * (kTile * NWG + 4 * kKeys);
}

// s <- s * scale * log2e + bias * log2e for keys k0 + [0, kKeys) (this
// thread's columns c0, c0 + 1 of every 8), keys >= Tk -inf unless the tile
// is full; mx <- the running max of the thread's two rows.
template <bool kFull, int NS>
__device__ __forceinline__ void scale_bias(float (&s)[NS], float (&mx)[2],
                                           const float* biasb, int k0,
                                           int c0, int Tk, float scale_log2) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + 8 * j + c0 + e;
      const bool ok = kFull || col < Tk;
      const float bl = (ok && biasb != nullptr) ? __ldg(biasb + col) * kLog2e
                                                : 0.f;
      s[4 * j + e] = ok ? fmaf(s[4 * j + e], scale_log2, bl) : -CUDART_INF_F;
      s[4 * j + 2 + e] =
          ok ? fmaf(s[4 * j + 2 + e], scale_log2, bl) : -CUDART_INF_F;
      mx[0] = fmaxf(mx[0], s[4 * j + e]);
      mx[1] = fmaxf(mx[1], s[4 * j + 2 + e]);
    }
  }
}

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128)
attn_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ bias,
                   bf16* __restrict__ o, float* __restrict__ lse, int Tq,
                   int Tk, int H, float scale_log2,
                   long long sqb, long long sqt, long long sqh,
                   long long skb, long long skt, long long skh,
                   long long svb, long long svt, long long svh,
                   long long sob, long long sot, long long soh) {
  constexpr int NT = NWG * 128;
  constexpr int NO = D / 2;                  // O accumulator floats a thread
  constexpr int NS = kKeys / 2;              // S accumulator floats a thread
  constexpr int kQBytes = kTile * D * 2;     // a warpgroup's Q rows
  constexpr int kKVBytes = kKeys * D * 2;    // a K or V tile
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sQ = smem_u32(tc_smem);
  const uint32_t sK = sQ + NWG * kQBytes;    // 2 stages
  const uint32_t sV = sK + 2 * kKVBytes;     // 2 stages

  const int q0 = blockIdx.x * kTile * NWG;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  // this thread's accumulator rows r0, r0 + 8 of its warpgroup's 64, and
  // columns c0, c0 + 1 of every 8
  const int r0 = 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);

  const bf16* kb = k + b * skb + h * skh;
  const bf16* vb = v + b * svb + h * svh;
  const float* biasb = bias != nullptr ? bias + (long long)b * Tk : nullptr;

  load_tile<D, NT>(sQ, q + b * sqb + h * sqh + q0 * sqt, sqt, Tq - q0,
                   kTile * NWG);
  cp_async_commit();
  load_tile<D, NT>(sK, kb, skt, Tk, kKeys);
  load_tile<D, NT>(sV, vb, svt, Tk, kKeys);
  cp_async_commit();

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // running max, log2 units
  float l[2] = {0.f, 0.f};                       // this thread's partial sums
  const uint32_t sQw = sQ + wg * kQBytes;
  const int ntiles = (Tk + kKeys - 1) / kKeys;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kKeys;
    const uint32_t tK = sK + (it & 1) * kKVBytes;
    const uint32_t tV = sV + (it & 1) * kKVBytes;
    if (it + 1 < ntiles) {   // the next tile's copies fly during this one
      const int k1 = k0 + kKeys;
      load_tile<D, NT>(sK + ((it + 1) & 1) * kKVBytes, kb + k1 * skt, skt,
                       Tk - k1, kKeys);
      load_tile<D, NT>(sV + ((it + 1) & 1) * kKVBytes, vb + k1 * svt, svt,
                       Tk - k1, kKeys);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(s, kmajor_desc<D>(sQw, ks), kmajor_desc<D>(tK, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
    if (k0 + kKeys <= Tk)
      scale_bias<true>(s, mx, biasb, k0, c0, Tk, scale_log2);
    else
      scale_bias<false>(s, mx, biasb, k0, c0, Tk, scale_log2);
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds at least one key < Tk, so the new max is finite
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = ex2(s[4 * j + e] - m[0]);
        s[4 * j + 2 + e] = ex2(s[4 * j + 2 + e] - m[1]);
        ls[0] += s[4 * j + e];
        ls[1] += s[4 * j + 2 + e];
      }
    }
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j + 0] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    uint32_t a[NS / 8][4];
    acc_to_a(s, a);   // unnormalised p, rounded to bf16
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < NS / 8; ++t)
      wgmma_rs(acc, a[t], mnmajor_desc<D>(tV, t), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();   // this stage is free for the copies of tile it + 2
  }

  bf16* ob = o + b * sob + h * soh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int t = q0 + wg * kTile + r0 + 8 * r;
    if (t < Tq) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + t * sot + 8 * j + c0) =
            pack_bf16(acc[4 * j + 2 * r] / l[r], acc[4 * j + 2 * r + 1] / l[r]);
      if (lse != nullptr && lane % 4 == 0)
        lse[((long long)b * H + h) * Tq + t] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int D, int NWG>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* bias, void* o, void* lse, int B, int Tq,
                      int Tk, int H, const long long* st,
                      cudaStream_t stream) {
  static unsigned long long configured = 0;
  constexpr int smem = tc_smem_bytes<D, NWG>();
  auto kern = attn_fwd_tc_kernel<D, NWG>;
  cudaError_t err = opt_in(kern, smem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kTile * NWG - 1) / (kTile * NWG), H, B);
  kern<<<grid, NWG * 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(o), static_cast<float*>(lse), Tq, Tk, H,
      rsqrtf((float)D) * kLog2e, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

// Two warpgroups a CTA (K/V tiles shared by 128 query rows) when the
// 128-row grid still puts a CTA on every SM, else one: the shape decides,
// nothing else.
template <int D>
cudaError_t launch_tc_by_shape(const void* q, const void* k, const void* v,
                               const void* bias, void* o, void* lse, int B,
                               int Tq, int Tk, int H, const long long* st,
                               cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long ctas2 = (long long)((Tq + 2 * kTile - 1) / (2 * kTile)) * H * B;
  if (ctas2 >= sms)
    return launch_tc<D, 2>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, stream);
  return launch_tc<D, 1>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, stream);
}

cudaError_t dispatch(int D, int dtype, const void* q, const void* k,
                     const void* v, const void* bias, void* o, void* lse,
                     int B, int Tq, int Tk, int H, const long long* st,
                     cudaStream_t s) {
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_f32<32>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, s);
      case 64: return launch_f32<64>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, s);
      case 96: return launch_f32<96>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, s);
      case 128: return launch_f32<128>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (D) {
      case 32: return launch_tc_by_shape<32>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, s);
      case 64: return launch_tc_by_shape<64>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, s);
      case 96: return launch_tc_by_shape<96>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, s);
      case 128: return launch_tc_by_shape<128>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, s);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  strides:
// 12 element strides, (batch, time, head) for q, k, v, o in that order; the
// head_dim stride must be 1, and for bf16 every pointer and stride must
// give 16-byte aligned rows (the wrapper checks).  bias: [B, Tk] float32 or
// null.  lse: [B, H, Tq] float32 out, or null.  Returns cudaGetLastError()
// after launch.
extern "C" int ptts_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* bias, void* o, void* lse, int B, int Tq,
                                  int Tk, int H, int D, int dtype,
                                  const long long* strides, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  return dispatch(D, dtype, q, k, v, bias, o, lse, B, Tq, Tk, H, strides,
                  static_cast<cudaStream_t>(stream));
}

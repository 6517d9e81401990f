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
// 227 KB).  Both dtypes run on the tensor cores; the dtype alone picks one
// of two kernels:
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
// f32: tensor cores too (attn_fwd_tf32_kernel), every product in 3 x TF32.
// Plain TF32 (10 mantissa bits) misses the f32 contracts (2e-5 on the
// kernel, 5e-4 on the model) by ~10x; so each operand is split, hi =
// rna_tf32(x) and lo = rna_tf32(x - hi) (wgmma.cuh: split_tf32), and each
// product is hi.lo + lo.hi + hi.hi with f32 accumulation, within ~2^-22 of
// |a||b| a term (tests/test_torch_attention_tf32x3.py emulates it against
// JAX's f32 attention).  The softmax is the bf16 kernel's in f32, and p
// stays at f32 accuracy: it is split as well.
//   What bounds it.  Three TF32 products are 3 x 4 D flops a score at 495
//   TFLOP/s, against one exp: the products, 3.47 ms for the evaluate
//   path's 36 calls at B = 32, where f32 FMAs on the CUDA cores could not
//   go below 8.56 ms.  Within a warpgroup a tile's split, S, softmax and
//   PV run one after another (PERF.md).
//   Design.  .tf32 operands are K-major only, so V is stored transposed,
//   V^T [D][keys], and every tile is held as hi and lo f32 tiles in the
//   unswizzled core-matrix layout (wgmma.cuh, "3 x TF32 attention tiles").
//   P goes to the PV product as register A fragments with no shuffles: the
//   accumulator holds columns 2t, 2t + 1 of each 8 where a TF32 fragment
//   takes t, t + 4, so the keys of V^T come permuted within each group of 8
//   to match (acc_to_tf32, store_transposed).  Q's split is held as
//   register fragments (D / 8 x 8 registers) at D <= 96, in shared memory
//   at D = 128, which takes one warpgroup and reads K and V straight from
//   device memory.  At D <= 96 a raw f32 copy of the next K and V tiles
//   arrives by cp.async while this tile's products run, and all threads
//   then split it into the tiles (16-byte reads and stores, no bank
//   conflicts).  Two warpgroups share the tiles as in bf16 at D = 64 and 96
//   on a large grid; one at D = 32, where two 128-thread CTAs fit on an SM
//   (measured faster).
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

// ---------------------------------------------------------------- f32 ----

// The f32 kernel's shared memory: the K tile [kKeys][D] and V^T [D][kKeys]
// as TF32 hi and lo tiles, shared by the NWG warpgroups; at D <= 96 a raw
// f32 copy of the next K and V tiles, which cp.async fills while this
// tile's products run; at D = 128 Q's [kTile][D] hi and lo instead (its
// fragments would take 128 registers a thread), NWG = 1, and K and V are
// read straight from device memory.
template <int D, int NWG>
struct Tf32Fwd {
  static constexpr bool kQRegs = D <= 96;
  static constexpr int kNT = NWG * 128;
  static constexpr int kBytes = kKeys * D * 4;   // one hi or lo K/V tile
  static constexpr int kQBytes = kQRegs ? 0 : kTile * D * 4;
  static constexpr int kRawBytes = kQRegs ? kKeys * raw_ld<D>() * 4 : 0;
  static constexpr int kSmem = 4 * kBytes + 2 * kQBytes + 2 * kRawBytes;
  static_assert(kSmem <= 232448, "shared memory");
  static_assert(kQRegs || NWG == 1, "D = 128 takes one warpgroup");
};

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
attn_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias, float* __restrict__ o,
                     float* __restrict__ lse, int Tq, int Tk, int H,
                     float scale_log2,
                     long long sqb, long long sqt, long long sqh,
                     long long skb, long long skt, long long skh,
                     long long svb, long long svt, long long svh,
                     long long sob, long long sot, long long soh) {
  using L = Tf32Fwd<D, NWG>;
  constexpr int NT = L::kNT;
  constexpr int NO = D / 2;        // O accumulator floats a thread
  constexpr int NS = kKeys / 2;    // S accumulator floats a thread
  constexpr int KS = D / 8;        // K steps of S = Q K^T
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sKh = smem_u32(tc_smem), sKl = sKh + L::kBytes;
  const uint32_t sVh = sKl + L::kBytes, sVl = sVh + L::kBytes;
  const uint32_t sQh = sVl + L::kBytes, sQl = sQh + L::kQBytes;
  const uint32_t sRK = sQl + L::kQBytes, sRV = sRK + L::kRawBytes;
  const float* rawK = reinterpret_cast<const float*>(tc_smem + (sRK - sKh));
  const float* rawV = reinterpret_cast<const float*>(tc_smem + (sRV - sKh));

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * kTile * NWG + wg * kTile;   // this warpgroup's
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int tig = lane % 4;
  // this thread's accumulator rows r0, r0 + 8 and columns c0, c0 + 1 of
  // every 8
  const int r0 = 16 * warp + lane / 4;
  const int c0 = 2 * tig;

  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  const float* biasb = bias != nullptr ? bias + (long long)b * Tk : nullptr;
  const float* qb = q + b * sqb + h * sqh + q0 * sqt;

  if constexpr (L::kQRegs) {   // tile 0's raw copies fly while Q is split
    stage_raw<kKeys, D, NT>(sRK, kb, skt, Tk);
    stage_raw<kKeys, D, NT>(sRV, vb, svt, Tk);
    cp_async_commit();
  }
  uint32_t qh[L::kQRegs ? KS : 1][4], ql[L::kQRegs ? KS : 1][4];
  if constexpr (L::kQRegs)
    load_a_tf32<D>(qb, sqt, Tq - q0, r0, tig, qh, ql);
  else
    split_kmajor<kTile, D, NT>(sQh, sQl, qb, sqt, Tq - q0);

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // running max, log2 units
  float l[2] = {0.f, 0.f};                       // this thread's partial sums
  const int ntiles = (Tk + kKeys - 1) / kKeys;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kKeys;
    if constexpr (L::kQRegs) {
      cp_async_wait<0>();
      __syncthreads();   // the raw tile is in; the last tile's products done
      {
        float4 x[Kmajor<kKeys, D, NT>::kN];
        load_kmajor<kKeys, D, NT, false>(x, rawK, raw_ld<D>(), kKeys);
        store_kmajor<kKeys, D, NT>(sKh, sKl, x);
      }
      {
        float4 x[Transposed<kKeys, D, NT>::kN][4];
        load_transposed<kKeys, D, NT, false>(x, rawV, raw_ld<D>(), kKeys);
        store_transposed<kKeys, D, NT>(sVh, sVl, x);
      }
      fence_async_smem();
      __syncthreads();   // the tiles are in; the raw panels are free
      if (it + 1 < ntiles) {
        const int k1 = k0 + kKeys;
        stage_raw<kKeys, D, NT>(sRK, kb + k1 * skt, skt, Tk - k1);
        stage_raw<kKeys, D, NT>(sRV, vb + k1 * svt, svt, Tk - k1);
        cp_async_commit();
      }
    } else {
      __syncthreads();   // every warp's products of the last tile are done
      split_kmajor<kKeys, D, NT>(sKh, sKl, kb + k0 * skt, skt, Tk - k0);
      split_transposed<kKeys, D, NT>(sVh, sVl, vb + k0 * svt, svt, Tk - k0);
      fence_async_smem();
      __syncthreads();
    }

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    wgmma_fence();
    if constexpr (L::kQRegs)
      mma3_rs<D>(s, qh, ql, sKh, sKl, 0);
    else
      mma3_ss<D>(s, sQh, sQl, sKh, sKl, 0);
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
    uint32_t ph[NS / 4][4], pl[NS / 4][4];
    acc_to_tf32(s, ph, pl);   // the unnormalised p, split
    wgmma_fence();
    mma3_rs<kKeys>(acc, ph, pl, sVh, sVl, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  float* ob = o + b * sob + h * soh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int t = q0 + r0 + 8 * r;
    if (t < Tq) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(ob + t * sot + 8 * j + c0) =
            make_float2(acc[4 * j + 2 * r] / l[r],
                        acc[4 * j + 2 * r + 1] / l[r]);
      if (lse != nullptr && tig == 0)
        lse[((long long)b * H + h) * Tq + t] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int D, int NWG>
cudaError_t launch_tf32(const void* q, const void* k, const void* v,
                        const void* bias, void* o, void* lse, int B, int Tq,
                        int Tk, int H, const long long* st,
                        cudaStream_t stream) {
  static unsigned long long configured = 0;
  constexpr int smem = Tf32Fwd<D, NWG>::kSmem;
  auto kern = attn_fwd_tf32_kernel<D, NWG>;
  cudaError_t err = opt_in(kern, smem, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kTile * NWG - 1) / (kTile * NWG), H, B);
  kern<<<grid, NWG * 128, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(lse), Tq, Tk, H,
      rsqrtf((float)D) * kLog2e, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

// Two warpgroups a CTA (K/V tiles shared by 128 query rows) when the
// 128-row grid still puts a CTA on every SM, else one: the shape decides,
// nothing else.  f32 takes one at D = 32 too (two 128-thread CTAs then fit
// on an SM and run out of step, which measured faster) and at D = 128.
template <int D>
cudaError_t launch_by_shape(int dtype, const void* q, const void* k,
                            const void* v, const void* bias, void* o,
                            void* lse, int B, int Tq, int Tk, int H,
                            const long long* st, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long ctas2 = (long long)((Tq + 2 * kTile - 1) / (2 * kTile)) * H * B;
  const bool two = ctas2 >= sms;
  if (dtype == 1)
    return two ? launch_tc<D, 2>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, stream)
               : launch_tc<D, 1>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, stream);
  if constexpr (D == 64 || D == 96) {
    if (two)
      return launch_tf32<D, 2>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, stream);
  }
  return launch_tf32<D, 1>(q, k, v, bias, o, lse, B, Tq, Tk, H, st, stream);
}

cudaError_t dispatch(int D, int dtype, const void* q, const void* k,
                     const void* v, const void* bias, void* o, void* lse,
                     int B, int Tq, int Tk, int H, const long long* st,
                     cudaStream_t s) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch_by_shape<32>(dtype, q, k, v, bias, o, lse, B, Tq, Tk, H, st, s);
    case 64: return launch_by_shape<64>(dtype, q, k, v, bias, o, lse, B, Tq, Tk, H, st, s);
    case 96: return launch_by_shape<96>(dtype, q, k, v, bias, o, lse, B, Tq, Tk, H, st, s);
    case 128: return launch_by_shape<128>(dtype, q, k, v, bias, o, lse, B, Tq, Tk, H, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (3 x TF32), 1 = bfloat16.  strides: 12 element
// strides, (batch, time, head) for q, k, v, o in that order; the head_dim
// stride must be 1, and every pointer and stride must give 16-byte aligned
// rows (the wrapper checks).  bias: [B, Tk] float32 or
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

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
// f32: tensor cores too (attn_bwd_*_tf32_kernel), every product in 3 x
// TF32 as in the forward (attention.cu): each operand split into hi and lo
// TF32 parts, hi.lo + lo.hi + hi.hi with f32 accumulation; p and ds * scale
// split like any operand, so they keep f32 accuracy.  .tf32 operands are
// K-major only, so the products that contract over rows take them
// transposed: K^T [D][keys] in the dq pass, Q^T and dO^T [D][rows] in the
// dk/dv pass, keys and rows permuted within each group of 8 to match the
// accumulator's fragments (wgmma.cuh, "3 x TF32 attention tiles").  dq
// pass: Q's split as register fragments (in shared memory at D = 128), dO
// and the key tiles K, V, K^T as hi and lo tiles; S = Q K^T, dP = dO V^T,
// dQ += (dS scale) K.  dk/dv pass: K and V as hi and lo tiles, per query
// tile Q, dO, Q^T, dO^T; S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK +=
// (dS^T scale) Q.  Shared memory holds it all: 64-key tiles in pass 1 (32
// at D = 128), query tiles of 64 rows at D <= 64, 32 at D = 96, 16 at D =
// 128 in pass 2.  Where there is room beside them (pass 1 at D <= 64, pass
// 2 at D >= 64) a raw f32 copy of the next tile arrives by cp.async while
// this tile's products run, and all threads then split it from shared
// memory; elsewhere a tile is loaded (16-byte loads, all issued before the
// first store) and split before its products.  At D = 64 and 96 two
// warpgroups a CTA split each streamed tile (pass 1 its keys, pass 2 its
// query rows) and add their partial sums at the end in a fixed order, so
// two runs still give the same bits; at D = 32 one, so that two CTAs fit
// on an SM (measured faster).
//   What bounds it.  Seven products of 3 x 4 D flops a score at 495 TFLOP/s
//   (5 counted in the bound, as the TPU kernel's), against two exps.  Within
//   a CTA the tile's split, its score products, the elementwise p and ds
//   and its gradient products run one after another (PERF.md).
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

constexpr int kB = 64;            // query rows of a dq CTA, keys of a dk/dv CTA

// ---------------------------------------------------------------- f32 ----

// Both f32 passes run NWG warpgroups a CTA, which split each streamed tile
// between them (pass 1 its keys, pass 2 its query rows): twice the threads
// for the tile's copies and two independent chains of products, in the
// same shared memory.  Each warpgroup keeps partial sums of the CTA's
// outputs; at the end warpgroup 1 hands its sums over through shared
// memory and warpgroup 0 adds them, always in that order.

// Pass 1 (f32)'s shared memory: dO [kB][D] (and at D = 128 Q too, whose
// fragments would not fit in registers beside the rest), and per key tile
// K and V [kBK][D] and K^T [D][kBK], each as TF32 hi and lo tiles; then the
// rows' lse and delta.  At D = 128 the key tiles hold 32 keys, so that the
// whole fits in 227 KB.
template <int D, int NWG>
struct Tf32Dq {
  static constexpr bool kQRegs = D <= 96;
  static constexpr int kBK = D <= 96 ? 64 : 32;
  static constexpr int kWK = kBK / NWG;            // keys a warpgroup takes
  static constexpr int kRowBytes = kB * D * 4;     // dO's (Q's) hi or lo
  static constexpr int kKeyBytes = kBK * D * 4;    // one hi or lo key tile
  // at D <= 64 raw f32 copies of the next K and V tiles, which cp.async
  // fills while this tile's products run (there is no room at D >= 96)
  static constexpr bool kStage = D <= 64;
  static constexpr int kRawBytes = kStage ? kBK * raw_ld<D>() * 4 : 0;
  static constexpr int kSmem = 2 * kRowBytes * (kQRegs ? 1 : 2)
      + 6 * kKeyBytes + 2 * kRawBytes + 2 * kB * 4;
  static_assert(kSmem <= 232448, "shared memory");
  // warpgroup 1's dq sums (128 threads x D / 2) go where the K tile was
  static_assert(NWG == 1 || 128 * D / 2 * 4 <= 2 * kKeyBytes,
                "reduction space");
};

// Pass 2 (f32)'s shared memory: the CTA's K and V [kB][D], and per query
// tile Q and dO [kBQ][D] and Q^T and dO^T [D][kBQ], each as hi and lo; then
// the tile's lse and delta.  The query tiles shrink with D to fit 227 KB.
template <int D, int NWG>
struct Tf32Dkv {
  static constexpr int kBQ = D <= 64 ? 64 : D <= 96 ? 32 : 16;
  static constexpr int kWQ = kBQ / NWG;            // rows a warpgroup takes
  static constexpr int kKeyBytes = kB * D * 4;     // K's or V's hi or lo
  static constexpr int kRowBytes = kBQ * D * 4;    // one hi or lo query tile
  // at D >= 64 raw f32 copies of the next query tile's Q, dO, lse and
  // delta, which cp.async fills while this tile's products run (at D = 32
  // they would cost the second CTA an SM)
  static constexpr bool kStage = D >= 64;
  static constexpr int kRawBytes = kStage ? kBQ * raw_ld<D>() * 4 : 0;
  static constexpr int kSmem = 4 * kKeyBytes + 8 * kRowBytes
      + 2 * kRawBytes + (kStage ? 4 : 2) * kBQ * 4;
  static_assert(kSmem <= 232448, "shared memory");
  // warpgroup 1's dk and dv sums (128 threads x D) and bias gradient sums
  // (128 x 2) go where the query tiles were
  static_assert(NWG == 1 || 128 * (D + 2) * 4 <= 8 * kRowBytes,
                "reduction space");
};

// Pass 1 (f32): delta and dq for 64 query rows of one (head, batch).
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
attn_bwd_dq_tf32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ bias,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq,
                        int Tq, int Tk, int H, float scale) {
  using L = Tf32Dq<D, NWG>;
  constexpr int NT = NWG * 128;
  constexpr int kBK = L::kBK, kWK = L::kWK;
  constexpr int NS = kWK / 2;      // S and dP accumulator floats a thread
  constexpr int KS = D / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sdOh = smem_u32(tc_smem), sdOl = sdOh + L::kRowBytes;
  const uint32_t sKh = sdOl + L::kRowBytes, sKl = sKh + L::kKeyBytes;
  const uint32_t sVh = sKl + L::kKeyBytes, sVl = sVh + L::kKeyBytes;
  const uint32_t sTh = sVl + L::kKeyBytes, sTl = sTh + L::kKeyBytes;
  const uint32_t sQh = sTl + L::kKeyBytes, sQl = sQh + L::kRowBytes;
  const uint32_t sRK = sQh + (L::kQRegs ? 0 : 2 * L::kRowBytes);
  const uint32_t sRV = sRK + L::kRawBytes;
  const float* rawK = reinterpret_cast<const float*>(tc_smem + (sRK - sdOh));
  const float* rawV = reinterpret_cast<const float*>(tc_smem + (sRV - sdOh));
  float* Ls = reinterpret_cast<float*>(
      tc_smem + L::kSmem - 2 * kB * 4);                        // [64]
  float* Ds = Ls + kB;                                         // [64]

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qn = min(kB, Tq - q0);
  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  const int warp = t128 / 32, lane = threadIdx.x % 32;
  const int tig = lane % 4;
  const int r0 = 16 * warp + lane / 4;   // accumulator rows r0, r0 + 8
  const int c0 = 2 * tig;                // columns c0, c0 + 1 of every 8
  const long long ld = (long long)H * D;                  // row stride
  const long long qoff = ((long long)b * Tq + q0) * ld + (long long)h * D;
  const long long koff = (long long)b * Tk * ld + (long long)h * D;
  const long long row0 = ((long long)b * H + h) * Tq + q0;   // lse/delta
  const float scale_log2 = scale * kLog2e;
  const float* biasb = bias != nullptr ? bias + (long long)b * Tk : nullptr;
  // this warpgroup's keys of a tile: its rows of the K and V tiles, its K
  // steps of K^T
  const uint32_t wK = wg * kWK * D * 4, wT = wg * (kWK / 8) * 256;

  if constexpr (L::kStage) {   // key tile 0's copies fly meanwhile
    stage_raw<kBK, D, NT>(sRK, k + koff, ld, Tk);
    stage_raw<kBK, D, NT>(sRV, v + koff, ld, Tk);
    cp_async_commit();
  }
  uint32_t qh[L::kQRegs ? KS : 1][4], ql[L::kQRegs ? KS : 1][4];
  if constexpr (L::kQRegs)
    load_a_tf32<D>(q + qoff, ld, qn, r0, tig, qh, ql);
  else
    split_kmajor<kB, D, NT>(sQh, sQl, q + qoff, ld, qn);
  split_kmajor<kB, D, NT>(sdOh, sdOl, dout + qoff, ld, qn);

  if (threadIdx.x < 128) {   // delta = rowsum(do * o): two threads a row
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    float acc = 0.f;
    if (r < qn) {
      const long long off = qoff + r * ld + half * (D / 2);
#pragma unroll
      for (int d = 0; d < D / 2; d += 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(dout + off + d));
        const float4 y = __ldg(reinterpret_cast<const float4*>(o + off + d));
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
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
  const int ntiles = (Tk + kBK - 1) / kBK;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBK;
    if constexpr (L::kStage) {
      cp_async_wait<0>();
      __syncthreads();   // the raw tiles are in; the last products done
      {
        using N = Kmajor<kBK, D, NT>;
        float4 xk[N::kN], xv[N::kN];
        load_kmajor<kBK, D, NT, false>(xk, rawK, raw_ld<D>(), kBK);
        load_kmajor<kBK, D, NT, false>(xv, rawV, raw_ld<D>(), kBK);
        store_kmajor<kBK, D, NT>(sKh, sKl, xk);
        store_kmajor<kBK, D, NT>(sVh, sVl, xv);
      }
      {
        float4 x[Transposed<kBK, D, NT>::kN][4];
        load_transposed<kBK, D, NT, false>(x, rawK, raw_ld<D>(), kBK);
        store_transposed<kBK, D, NT>(sTh, sTl, x);
      }
      fence_async_smem();
      __syncthreads();   // the tiles are in; the raw panels are free
      if (it + 1 < ntiles) {
        const long long next = koff + (k0 + kBK) * ld;
        stage_raw<kBK, D, NT>(sRK, k + next, ld, Tk - k0 - kBK);
        stage_raw<kBK, D, NT>(sRV, v + next, ld, Tk - k0 - kBK);
        cp_async_commit();
      }
    } else {
      const float* kt = k + koff + k0 * ld;
      __syncthreads();   // every warp's products of the last tile are done
      split_kmajor<kBK, D, NT>(sKh, sKl, kt, ld, Tk - k0);
      split_kmajor<kBK, D, NT>(sVh, sVl, v + koff + k0 * ld, ld, Tk - k0);
      split_transposed<kBK, D, NT>(sTh, sTl, kt, ld, Tk - k0);
      fence_async_smem();
      __syncthreads();
    }

    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    if constexpr (L::kQRegs)
      mma3_rs<D>(s, qh, ql, sKh + wK, sKl + wK, 0);
    else
      mma3_ss<D>(s, sQh, sQl, sKh + wK, sKl + wK, 0);
    mma3_ss<D>(dp, sdOh, sdOl, sVh + wK, sVl + wK, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // s <- ds * scale, from p = exp2(s scale log2e + bias log2e - lse log2e)
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + wg * kWK + 8 * j + c0 + e;
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
    uint32_t fh[NS / 4][4], fl[NS / 4][4];
    acc_to_tf32(s, fh, fl);
    wgmma_fence();
    mma3_rs<kBK>(acc, fh, fl, sTh + wT, sTl + wT, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  if constexpr (NWG == 2) {   // warpgroup 0 adds warpgroup 1's sums
    float* red = reinterpret_cast<float*>(tc_smem + (sKh - sdOh));
    __syncthreads();   // the K tile is no longer read
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) red[i * 128 + t128] = acc[i];
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += red[i * 128 + t128];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rok[r]) {
      float* row = dq + qoff + (r0 + 8 * r) * ld;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(row + 8 * j + c0) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// Pass 2 (f32): dk, dv and the per-head bias gradient for 64 keys of one
// (head, batch).  Reads the delta that pass 1 wrote.
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
attn_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ bias,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         float* __restrict__ dbias_h, int Tq, int Tk, int H,
                         float scale) {
  using L = Tf32Dkv<D, NWG>;
  constexpr int NT = NWG * 128;
  constexpr int kBQ = L::kBQ, kWQ = L::kWQ;
  constexpr int NS = kWQ / 2;      // S^T and dP^T accumulator floats
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sKh = smem_u32(tc_smem), sKl = sKh + L::kKeyBytes;
  const uint32_t sVh = sKl + L::kKeyBytes, sVl = sVh + L::kKeyBytes;
  const uint32_t sQh = sVl + L::kKeyBytes, sQl = sQh + L::kRowBytes;
  const uint32_t sOh = sQl + L::kRowBytes, sOl = sOh + L::kRowBytes;
  const uint32_t sQTh = sOl + L::kRowBytes, sQTl = sQTh + L::kRowBytes;
  const uint32_t sOTh = sQTl + L::kRowBytes, sOTl = sOTh + L::kRowBytes;
  const uint32_t sRQ = sOTl + L::kRowBytes, sRO = sRQ + L::kRawBytes;
  const float* rawQ = reinterpret_cast<const float*>(tc_smem + (sRQ - sKh));
  const float* rawO = reinterpret_cast<const float*>(tc_smem + (sRO - sKh));
  float* Ls = reinterpret_cast<float*>(
      tc_smem + 4 * L::kKeyBytes + 8 * L::kRowBytes
      + 2 * L::kRawBytes);                                     // [kBQ]
  float* Ds = Ls + kBQ;                                        // [kBQ]
  float* rawL = Ds + kBQ;          // [kBQ] staged lse, then delta
  float* rawD = rawL + kBQ;

  const int k0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kn = min(kB, Tk - k0);
  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  const int warp = t128 / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4;   // accumulator rows (keys) r0, r0 + 8
  const int c0 = 2 * (lane % 4);         // columns (q rows) c0, c0 + 1 of 8
  const long long ld = (long long)H * D;
  const long long koff = ((long long)b * Tk + k0) * ld + (long long)h * D;
  const long long qbase = (long long)b * Tq * ld + (long long)h * D;
  const long long rowb = ((long long)b * H + h) * Tq;
  const float scale_log2 = scale * kLog2e;
  // this warpgroup's rows of a query tile: its rows of the Q and dO tiles,
  // its K steps of Q^T and dO^T
  const uint32_t wQ = wg * kWQ * D * 4, wT = wg * (kWQ / 8) * 256;

  // the copies of query tile `it` into the raw panels (kStage)
  auto stage_rows = [&](int it) {
    const int q0 = it * kBQ;
    stage_raw<kBQ, D, NT>(sRQ, q + qbase + q0 * ld, ld, Tq - q0);
    stage_raw<kBQ, D, NT>(sRO, dout + qbase + q0 * ld, ld, Tq - q0);
    for (int i = threadIdx.x; i < 2 * kBQ; i += NT) {
      const int r = i % kBQ;
      const float* src = i < kBQ ? lse : delta;
      const bool ok = q0 + r < Tq;
      cp_async4(smem_u32((i < kBQ ? rawL : rawD) + r),
                ok ? src + rowb + q0 + r : src, ok);
    }
    cp_async_commit();
  };
  if constexpr (L::kStage) stage_rows(0);   // in flight meanwhile
  split_kmajor<kB, D, NT>(sKh, sKl, k + koff, ld, kn);
  split_kmajor<kB, D, NT>(sVh, sVl, v + koff, ld, kn);

  float bk[2];   // this thread's keys' bias, log2 units
  bool kok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kok[r] = r0 + 8 * r < kn;
    bk[r] = (bias != nullptr && kok[r])
        ? bias[(long long)b * Tk + k0 + r0 + 8 * r] * kLog2e : 0.f;
  }
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float db[2] = {0.f, 0.f};   // this thread's part of the keys' bias gradient

  const int ntiles = (Tq + kBQ - 1) / kBQ;
  for (int it = 0; it < ntiles; ++it) {
    const int q0 = it * kBQ;
    if constexpr (L::kStage) {
      cp_async_wait<0>();
      __syncthreads();   // the raw tile is in; the last products done
      {  // Q and dO into the natural, then the transposed tiles
        using N = Kmajor<kBQ, D, NT>;
        using T = Transposed<kBQ, D, NT>;
        float4 xq[N::kN], xo[N::kN];
        load_kmajor<kBQ, D, NT, false>(xq, rawQ, raw_ld<D>(), kBQ);
        load_kmajor<kBQ, D, NT, false>(xo, rawO, raw_ld<D>(), kBQ);
        store_kmajor<kBQ, D, NT>(sQh, sQl, xq);
        store_kmajor<kBQ, D, NT>(sOh, sOl, xo);
        float4 tq[T::kN][4], to[T::kN][4];
        load_transposed<kBQ, D, NT, false>(tq, rawQ, raw_ld<D>(), kBQ);
        load_transposed<kBQ, D, NT, false>(to, rawO, raw_ld<D>(), kBQ);
        store_transposed<kBQ, D, NT>(sQTh, sQTl, tq);
        store_transposed<kBQ, D, NT>(sOTh, sOTl, to);
      }
      for (int i = threadIdx.x; i < kBQ; i += NT) {
        Ls[i] = rawL[i] * kLog2e;
        Ds[i] = rawD[i];
      }
      fence_async_smem();
      __syncthreads();   // the tiles are in; the raw panels are free
      if (it + 1 < ntiles) stage_rows(it + 1);
    } else {
      const float* qt = q + qbase + q0 * ld;
      const float* ot = dout + qbase + q0 * ld;
      __syncthreads();   // every warp's products of the last tile are done
      {  // Q and dO: both panels' loads, then their stores; then the same
         // rows again (from L1) into the transposed tiles
        using N = Kmajor<kBQ, D, NT>;
        using T = Transposed<kBQ, D, NT>;
        float4 xq[N::kN], xo[N::kN];
        load_kmajor<kBQ, D, NT>(xq, qt, ld, Tq - q0);
        load_kmajor<kBQ, D, NT>(xo, ot, ld, Tq - q0);
        store_kmajor<kBQ, D, NT>(sQh, sQl, xq);
        store_kmajor<kBQ, D, NT>(sOh, sOl, xo);
        float4 tq[T::kN][4], to[T::kN][4];
        load_transposed<kBQ, D, NT>(tq, qt, ld, Tq - q0);
        load_transposed<kBQ, D, NT>(to, ot, ld, Tq - q0);
        store_transposed<kBQ, D, NT>(sQTh, sQTl, tq);
        store_transposed<kBQ, D, NT>(sOTh, sOTl, to);
      }
      for (int i = threadIdx.x; i < kBQ; i += NT) {
        const bool ok = q0 + i < Tq;
        Ls[i] = ok ? lse[rowb + q0 + i] * kLog2e : 0.f;
        Ds[i] = ok ? delta[rowb + q0 + i] : 0.f;
      }
      fence_async_smem();
      __syncthreads();
    }

    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    mma3_ss<D>(s, sKh, sKl, sQh + wQ, sQl + wQ, 0);    // S^T = K Q^T
    mma3_ss<D>(dp, sVh, sVl, sOh + wQ, sOl + wQ, 0);   // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // s <- p^T, dp <- ds^T * scale; the bias gradient takes ds^T unscaled
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wg * kWQ + 8 * j + c0 + e;
        const bool ok = q0 + col < Tq;
        const float lq = Ls[col];
        const float dlt = Ds[col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          const float p = (ok && kok[r])
              ? ex2(fmaf(s[i], scale_log2, bk[r] - lq)) : 0.f;
          const float ds = p * (dp[i] - dlt);
          db[r] += ds;
          s[i] = p;
          dp[i] = ds * scale;
        }
      }
    }
    uint32_t ph[NS / 4][4], pl[NS / 4][4], dh[NS / 4][4], dlo[NS / 4][4];
    acc_to_tf32(s, ph, pl);
    acc_to_tf32(dp, dh, dlo);
    wgmma_fence();
    mma3_rs<kBQ>(dv_acc, ph, pl, sOTh + wT, sOTl + wT, 1);    // dV += P^T dO
    mma3_rs<kBQ>(dk_acc, dh, dlo, sQTh + wT, sQTl + wT, 1);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
  }

  if constexpr (NWG == 2) {   // warpgroup 0 adds warpgroup 1's sums
    float* red = reinterpret_cast<float*>(tc_smem + (sQh - sKh));
    __syncthreads();   // the query tiles are no longer read
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        red[i * 128 + t128] = dk_acc[i];
        red[(D / 2 + i) * 128 + t128] = dv_acc[i];
      }
      red[D * 128 + t128] = db[0];
      red[(D + 1) * 128 + t128] = db[1];
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dk_acc[i] += red[i * 128 + t128];
      dv_acc[i] += red[(D / 2 + i) * 128 + t128];
    }
    db[0] += red[D * 128 + t128];
    db[1] += red[(D + 1) * 128 + t128];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
    const int key = r0 + 8 * r;
    if (kok[r]) {
      float* dkr = dk + koff + key * ld;
      float* dvr = dv + koff + key * ld;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(dkr + 8 * j + c0) =
            make_float2(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
        *reinterpret_cast<float2*>(dvr + 8 * j + c0) =
            make_float2(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
      if (dbias_h != nullptr && lane % 4 == 0)
        dbias_h[((long long)b * H + h) * Tk + k0 + key] = db[r];
    }
  }
}

// Two warpgroups a CTA in both passes at D = 64 and 96.  At D = 32 one,
// since two 128-thread CTAs then fit on an SM and run out of step, which
// measured faster; at D = 128 one, whose tiles are already narrow (16
// query rows, 32 keys).
template <int D>
constexpr int bwd_tf32_nwg() { return D == 64 || D == 96 ? 2 : 1; }

template <int D>
cudaError_t launch_tf32(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* bias,
                        const void* lse, void* dq, void* dk, void* dv,
                        void* dbias_h, void* delta, int B, int Tq, int Tk,
                        int H, float scale, cudaStream_t stream) {
  constexpr int NWG = bwd_tf32_nwg<D>();
  static unsigned long long configured_dq = 0, configured_dkv = 0;
  constexpr int smem_dq = Tf32Dq<D, NWG>::kSmem;
  constexpr int smem_dkv = Tf32Dkv<D, NWG>::kSmem;
  auto kdq = attn_bwd_dq_tf32_kernel<D, NWG>;
  auto kdkv = attn_bwd_dkv_tf32_kernel<D, NWG>;
  cudaError_t err = opt_in(kdq, smem_dq, &configured_dq);
  if (err != cudaSuccess) return err;
  err = opt_in(kdkv, smem_dkv, &configured_dkv);
  if (err != cudaSuccess) return err;
  dim3 gq((Tq + kB - 1) / kB, H, B);
  kdq<<<gq, NWG * 128, smem_dq, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(bias),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<float*>(dq), Tq, Tk, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gk((Tk + kB - 1) / kB, H, B);
  kdkv<<<gk, NWG * 128, smem_dkv, stream>>>(
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
      case 32: return launch_tf32<32>(PTTS_BWD_ARGS);
      case 64: return launch_tf32<64>(PTTS_BWD_ARGS);
      case 96: return launch_tf32<96>(PTTS_BWD_ARGS);
      case 128: return launch_tf32<128>(PTTS_BWD_ARGS);
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
// f32 scratch) and then the dk/dv pass.  dtype: 0 = float32 (3 x TF32),
// 1 = bfloat16; every pointer 16-byte aligned, which the wrapper checks.  Every tensor is contiguous: q, o, dout, dq [B,Tq,H,D];
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

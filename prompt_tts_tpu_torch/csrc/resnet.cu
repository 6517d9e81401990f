// Fused UNet ResnetBlock1D for Hopper (sm_90a), inference only.
//
// Replaces the TPU kernel prompt_tts_tpu/ops/pallas/resnet.py:
// fused_resnet_block (_resnet_kernel).  Same contract: for x [B,T,Cin]
// (bf16 or f32, channels-last)
//   h   = conv3(silu(GN1(x))) + b1 + temb_proj[b]       (rounded to x's type)
//   out = conv3(silu(GN2(h))) + b2 + shortcut(x)        (1x1 conv or identity)
// GroupNorm statistics in f32 (f64 where partial sums are combined), "same"
// k3 convolutions with zero edges applied to silu(GN(.)), silu(GN(.))
// rounded to the input type before each product, f32 accumulation.  No
// atomics: every sum is taken in a fixed order, so two runs give the same
// bits.
//
// The TPU kernel held a whole [T, C] panel per batch element in VMEM; at
// T = 900, Cin = 768 a bf16 panel is 1.4 MB, far beyond an SM's 227 KB, and
// GroupNorm needs statistics over all of T before any row can be
// normalised.  So the block runs as several launches.  GroupNorm's sums
// are shifted (x - K with K the group's first channel at t = 0 for GN1,
// b1 + temb_proj at that channel for GN2) so that E[(x-K)^2] - E[x-K]^2
// does not cancel.
//
// bf16: five launches, the products on wgmma.
//   1. resnet_stats_kernel: per (128-row chunk, 64-channel slab, batch) the
//      column sums of x - K and their squares, 16-byte loads of whole
//      128-byte row segments.
//   2. resnet_act_kernel: reduces the partial sums of its slab's groups in
//      f64 (fixed order) to mean and rstd, then writes a =
//      bf16(silu(GN1(x))) once, [B, T, Cin].  Normalising once here, and
//      not in every output-channel tile of the product, is what the
//      wmma version this replaces did not do (12 times per element at
//      Cout = 768).
//   3. resnet_conv_tc_kernel<.., false>: conv1 as an implicit GEMM: M = T
//      rows of one batch element, N = Cout, K = 3 taps x Cin.  A 3-D TMA
//      map over a [B, T, Cin] with a 64-channel x BM-row box and the
//      128-byte swizzle: tap s in {-1, 0, 1} is one box at row t0 + s, and
//      TMA zero-fills rows outside [0, T) -- exactly the convolution's zero
//      padding of the activated input -- and channels past Cin.  The
//      weights, packed once as [3, Cout, Cin] (K-major), under a second map.
//      A 4-stage ring in shared memory with full/empty mbarriers, kept full
//      by one producer warp; one or two consumer warpgroups (BM = 64 or
//      128) run wgmma m64nBNk16 (BN = 64 or 128) with both operands
//      in shared memory and f32 accumulators in registers.  Epilogue from
//      registers: + b1 + temb_proj[b], h rounded to bf16 and stored, and
//      the column sums of the rounded h - K2 for GN2, per (row tile,
//      channel).
//   4. resnet_act_kernel again: a2 = bf16(silu(GN2(h))) (reusing a's
//      buffer).
//   5. resnet_conv_tc_kernel<.., true>: conv2 the same way over a2; a 1x1
//      shortcut is more K steps over the raw x (its own map) against ws
//      [Cout, Cin]; an identity shortcut adds x in the epilogue; + b2, + bs.
//   The tile shape (BM, BN) comes from the caller (ops/cuda/resnet.py:
//   resnet_tiles).
//   What bounds it.  A block is 2 B T (3 Cin Cout + 3 Cout^2 [+ Cin Cout])
//   flops against a few MB of activations: the tensor-core rate bounds it.
//   The activation passes add one write and about three reads of a and a2,
//   mostly from L2.
//
// f32: three launches on the CUDA cores (kept for the f32 contracts, 1e-4
// on the kernel and 5e-4 on the model, which TF32 would miss):
//   1. resnet_gn_stats_f32_kernel: one CTA per (group, batch row) writes
//      GN1's mean and rstd.
//   2./3. resnet_conv_f32_kernel: a 64-row x 64-channel implicit GEMM over
//      K = 3 * Cmain, GN + SiLU applied in the prologue to each loaded tile
//      and its +-1-row halo; conv1's epilogue writes per-(T-tile,
//      channel-tile, group) partial sums of h - K2, which conv2 reduces in
//      f64.  f32 FMAs, 8x4 micro-tiles a thread, tiles staged through
//      registers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C interface,
// loaded with ctypes by prompt_tts_tpu_torch/ops/cuda/resnet.py).  The TMA
// maps are encoded on the host by cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (tma_host.cuh), so nothing links libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <initializer_list>

#include "tma_host.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace ptts;

constexpr int kMaxGroups = 128;
constexpr int kMaxCpg = 256;   // channels a group may hold

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// ------------------------------------------------------------------ f32

constexpr int kBM = 64;       // rows (time steps) per tile
constexpr int kBN = 64;       // output channels per tile
constexpr int kBK = 32;       // input channels per K step
constexpr int kThreads = 128;
constexpr int kStatsThreads = 256;

struct F32Tile {
  static constexpr int LDA = kBK + 4;      // A tile row stride (floats)
  static constexpr int LDB = kBN + 4;      // W tile row stride
  static constexpr int LDC = kBN + 4;      // output tile row stride
  static constexpr int kA = ((kBM + 2) * LDA * 4 + 127) / 128 * 128;
  static constexpr int kW = (3 * kBK * LDB * 4 + 127) / 128 * 128;
  static constexpr int kC = kBM * LDC * 4;
  static constexpr int kMain = (kA + kW) > kC ? (kA + kW) : kC;
};

struct F32Args {
  const float* in;       // [B, T, Cmain]: x (conv1) or h (conv2)
  const float* x;        // [B, T, Cin]: the block input (shortcut)
  const float* w;        // [3, Cout, Cmain]
  const float* ws;       // [Cout, Cin] or null (identity shortcut, conv2)
  const float* bias;     // [Cout] (b1 or b2)
  const float* bs;       // [Cout] shortcut bias or null
  const float* temb;     // [B, Cout]
  const float* b1;       // [Cout]: with temb, GN2's shift K2
  const float* gamma;    // [Cmain] the prologue's GroupNorm
  const float* beta;
  const float* stats1;   // [B, G, 2] GN1 mean, rstd (conv1)
  float* part;           // [B, nT, nN, G, 2] GN2 partials (written by conv1)
  float* out;            // [B, T, Cout]
  int B, T, Cin, Cmain, Cout, G;
  float eps;
};

// GroupNorm statistics of x: mean and rstd per (b, g).
__global__ void __launch_bounds__(kStatsThreads)
resnet_gn_stats_f32_kernel(const float* __restrict__ x,
                           float* __restrict__ stats, int T_, int C, int G,
                           float eps) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int cpg = C / G;
  const int rows = kStatsThreads / cpg;   // rows a pass covers
  const int tid = threadIdx.x;
  const float* xb = x + (long long)b * T_ * C + g * cpg;
  const float K = xb[0];
  float s1 = 0.f, s2 = 0.f;
  if (tid < rows * cpg) {
    const int c = tid % cpg;
    for (int t = tid / cpg; t < T_; t += rows) {
      const float v = xb[(long long)t * C + c] - K;
      s1 += v;
      s2 += v * v;
    }
  }
  __shared__ double red[2][kStatsThreads / 32];
  double d1 = s1, d2 = s2;
  for (int o = 16; o > 0; o >>= 1) {
    d1 += __shfl_xor_sync(0xffffffffu, d1, o);
    d2 += __shfl_xor_sync(0xffffffffu, d2, o);
  }
  if ((tid & 31) == 0) { red[0][tid >> 5] = d1; red[1][tid >> 5] = d2; }
  __syncthreads();
  if (tid == 0) {
    double a = 0.0, q = 0.0;
    for (int w = 0; w < kStatsThreads / 32; ++w) { a += red[0][w]; q += red[1][w]; }
    const double n = (double)T_ * cpg;
    const double m = a / n;
    const double var = fmax(q / n - m * m, 0.0);
    stats[(b * G + g) * 2 + 0] = (float)(K + m);
    stats[(b * G + g) * 2 + 1] = (float)(1.0 / sqrt(var + (double)eps));
  }
}

// The k3 convolution as an implicit GEMM over one 64 x 64 output tile.
template <bool kConv2>
__global__ void __launch_bounds__(kThreads)
resnet_conv_f32_kernel(F32Args a) {
  using L = F32Tile;
  __shared__ __align__(128) unsigned char smem[L::kMain];
  __shared__ float mean_s[kMaxGroups], rstd_s[kMaxGroups];
  __shared__ float colsum[2][2][kBN];
  float* As = reinterpret_cast<float*>(smem);
  float* Ws = reinterpret_cast<float*>(smem + L::kA);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kBM, co0 = blockIdx.y * kBN, b = blockIdx.z;
  const int T_ = a.T, Cout = a.Cout, Cm = a.Cmain, G = a.G;
  const int cpg = Cm / G;
  const int nT = gridDim.x, nN = gridDim.y;

  // the prologue's GroupNorm statistics for this batch row
  if (!kConv2) {
    for (int g = tid; g < G; g += kThreads) {
      mean_s[g] = a.stats1[(b * G + g) * 2 + 0];
      rstd_s[g] = a.stats1[(b * G + g) * 2 + 1];
    }
  } else {
    // reduce conv1's partials of h - K2: for group g, every T-tile and
    // the (at most two) channel tiles that hold its channels
    for (int g = tid; g < G; g += kThreads) {
      const int c0 = g * cpg;
      const float K = a.b1[c0] + a.temb[(long long)b * a.Cout + c0];
      double s1 = 0.0, s2 = 0.0;
      const int n_lo = c0 / kBN, n_hi = (c0 + cpg - 1) / kBN;
      for (int tt = 0; tt < nT; ++tt)
        for (int nt = n_lo; nt <= n_hi; ++nt) {
          const float* p = a.part + ((((long long)b * nT + tt) * nN + nt) * G + g) * 2;
          s1 += p[0];
          s2 += p[1];
        }
      const double n = (double)T_ * cpg;
      const double m = s1 / n;
      const double var = fmax(s2 / n - m * m, 0.0);
      mean_s[g] = (float)(K + m);
      rstd_s[g] = (float)(1.0 / sqrt(var + (double)a.eps));
    }
  }
  __syncthreads();

  const int tx = tid & 15, ty = tid >> 4;   // 8 rows x 4 cols a thread
  float facc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) facc[i][j] = 0.f;

  // one K step: A rows [row_off, row_off + 64) against W slot `slot`
  auto kstep = [&](int row_off, int slot) {
    for (int kc = 0; kc < kBK; ++kc) {
      float av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = As[(ty * 8 + i + row_off) * L::LDA + kc];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Ws[(slot * kBK + kc) * L::LDB + tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(av[i], bv[j], facc[i][j]);
    }
  };

  // Operand tiles move in 16-byte vectors (the wrapper checks that every
  // channel count is a multiple of 8 and every pointer 16-byte aligned),
  // staged through registers: the next K step's global loads start
  // before this step's products.
  constexpr int VEC = 4;
  constexpr int VPR = kBK / VEC;                      // vectors per A row
  constexpr int RPP = kThreads / VPR;                 // A rows per pass
  constexpr int kAPass = (kBM + 2 + RPP - 1) / RPP;
  constexpr int KV = kBK / VEC;                       // vectors per W row
  constexpr int kWVec = 3 * kBN * KV / kThreads;      // W vectors a thread
  const int kc = (tid % VPR) * VEC;                   // this thread's channels
  float4 ra[kAPass], rw[kWVec];
  unsigned amask = 0;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // A rows r of the tile hold time t = t0 - 1 + r (halo at r = 0, 65)
  auto load_a = [&](const float* src, int C, int ci0) {
    amask = 0;
#pragma unroll
    for (int i = 0; i < kAPass; ++i) {
      const int r = tid / VPR + i * RPP, t = t0 - 1 + r, c = ci0 + kc;
      const bool ok = r < kBM + 2 && t >= 0 && t < T_ && c < C;
      ra[i] = ok ? __ldg(reinterpret_cast<const float4*>(src + (long long)t * C + c))
                 : zero4;
      amask |= (unsigned)ok << i;
    }
  };
  // GN + SiLU (or, raw, nothing) on the staged rows
  auto store_a = [&](int ci0, bool raw) {
    float sc[VEC], sh[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c = min(ci0 + kc + j, Cm - 1), g = c / cpg;
      sc[j] = raw ? 1.f : a.gamma[c] * rstd_s[g];
      sh[j] = raw ? 0.f : a.beta[c] - mean_s[g] * sc[j];
    }
#pragma unroll
    for (int i = 0; i < kAPass; ++i) {
      const int r = tid / VPR + i * RPP;
      if (r >= kBM + 2) break;
      float4 v = ra[i];
      if (!raw) {
        float* e = reinterpret_cast<float*>(&v);
        const bool ok = (amask >> i) & 1u;
#pragma unroll
        for (int j = 0; j < VEC; ++j) e[j] = ok ? silu(e[j] * sc[j] + sh[j]) : 0.f;
      }
      *reinterpret_cast<float4*>(As + r * L::LDA + kc) = v;
    }
  };
  // W vectors: `slots` taps of [kBN out-channels x kBK in-channels] from a
  // [taps, Cout, C] array (K-major), stored transposed as [tap * kBK + k][n]
  auto load_w = [&](const float* src, int C, int ci0, int slots) {
#pragma unroll
    for (int i = 0; i < kWVec; ++i) {
      const int v = tid + i * kThreads;
      const int tap = v / (kBN * KV), rem = v % (kBN * KV);
      const int co = co0 + rem / KV, c = ci0 + (rem % KV) * VEC;
      rw[i] = (tap < slots && c < C && co < Cout)
                  ? __ldg(reinterpret_cast<const float4*>(
                        src + ((long long)tap * Cout + co) * C + c))
                  : zero4;
    }
  };
  auto store_w = [&]() {
#pragma unroll
    for (int i = 0; i < kWVec; ++i) {
      const int v = tid + i * kThreads;
      const int tap = v / (kBN * KV), rem = v % (kBN * KV);
      const int n = rem / KV, k = (rem % KV) * VEC;
      const float* e = reinterpret_cast<const float*>(&rw[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) Ws[(tap * kBK + k + j) * L::LDB + n] = e[j];
    }
  };

  // main K loop: 3 taps over the normalised, activated input
  const float* in = a.in + (long long)b * T_ * Cm;
  load_a(in, Cm, 0);
  load_w(a.w, Cm, 0, 3);
  for (int ci0 = 0; ci0 < Cm; ci0 += kBK) {
    store_a(ci0, false);
    store_w();
    __syncthreads();
    if (ci0 + kBK < Cm) {
      load_a(in, Cm, ci0 + kBK);
      load_w(a.w, Cm, ci0 + kBK, 3);
    }
    kstep(0, 0);
    kstep(1, 1);
    kstep(2, 2);
    __syncthreads();
  }

  // conv2's 1x1 shortcut: one more K loop over the raw x tile, whose rows
  // 1..64 hold t0..t0+63 (the halo rows are loaded but not used)
  if (kConv2 && a.ws != nullptr) {
    const float* xb = a.x + (long long)b * T_ * a.Cin;
    load_a(xb, a.Cin, 0);
    load_w(a.ws, a.Cin, 0, 1);
    for (int ci0 = 0; ci0 < a.Cin; ci0 += kBK) {
      store_a(ci0, true);
      store_w();
      __syncthreads();
      if (ci0 + kBK < a.Cin) {
        load_a(xb, a.Cin, ci0 + kBK);
        load_w(a.ws, a.Cin, ci0 + kBK, 1);
      }
      kstep(1, 0);
      __syncthreads();
    }
  }

  // accumulators -> the output tile Cs (aliases As/Ws: the loops above
  // ended with a barrier)
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[(ty * 8 + i) * L::LDC + tx * 4 + j] = facc[i][j];
  __syncthreads();

  // epilogue: thread -> one column, every other row
  const int n = tid % kBN, half = tid / kBN;
  const int co = co0 + n;
  float* out = a.out + (long long)b * T_ * Cout;
  float s1 = 0.f, s2 = 0.f;
  if (co < Cout) {
    float add = a.bias[co];
    float K2 = 0.f;
    if (!kConv2) {
      add += a.temb[(long long)b * Cout + co];
      const int c0 = (co / (Cout / G)) * (Cout / G);
      K2 = a.b1[c0] + a.temb[(long long)b * Cout + c0];
    } else if (a.bs != nullptr) {
      add += a.bs[co];
    }
    const float* xb = a.x + (long long)b * T_ * a.Cin;
    for (int r = half; r < kBM; r += 2) {
      const int t = t0 + r;
      if (t >= T_) break;
      float v = Cs[r * L::LDC + n] + add;
      if (kConv2 && a.ws == nullptr) v += xb[(long long)t * a.Cin + co];
      out[(long long)t * Cout + co] = v;
      if (!kConv2) {   // GN2 statistics of h
        const float d = v - K2;
        s1 += d;
        s2 += d * d;
      }
    }
  }
  if (!kConv2) {
    colsum[half][0][n] = s1;
    colsum[half][1][n] = s2;
    __syncthreads();
    const int cpg2 = Cout / G;
    const int g_lo = co0 / cpg2;
    const int g_hi = (min(co0 + kBN, Cout) - 1) / cpg2;
    for (int g = g_lo + tid; g <= g_hi; g += kThreads) {
      const int c_lo = max(g * cpg2, co0) - co0;
      const int c_hi = min((g + 1) * cpg2, min(co0 + kBN, Cout)) - co0;
      float p1 = 0.f, p2 = 0.f;
      for (int c = c_lo; c < c_hi; ++c) {
        p1 += colsum[0][0][c] + colsum[1][0][c];
        p2 += colsum[0][1][c] + colsum[1][1][c];
      }
      float* p = a.part + ((((long long)b * nT + blockIdx.x) * nN + blockIdx.y) * G + g) * 2;
      p[0] = p1;
      p[1] = p2;
    }
  }
}

// ----------------------------------------------------------------- bf16

constexpr int kSlab = 64;       // channels a stats / activation CTA covers
constexpr int kChunk = 128;     // rows a stats / activation CTA covers
constexpr int kSAThreads = 256;
constexpr int kLanes = kSAThreads / 8;   // row lanes (8 vectors a row)
constexpr int kRows = kChunk / kLanes;   // rows a thread loads
constexpr int kBoxK = 64;       // channels per K step: one 128-byte row

// GN1's partial sums: per (128-row chunk, channel) the sum of x - K and of
// its square, part[b][chunk][c].
__global__ void __launch_bounds__(kSAThreads)
resnet_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ part,
                    int T_, int C, int cpg) {
  const int chunk = blockIdx.x, c0 = blockIdx.y * kSlab, b = blockIdx.z;
  const int v = threadIdx.x % 8, lr = threadIdx.x / 8;
  const int c = c0 + 8 * v;
  const bf16* xb = x + (long long)b * T_ * C;
  float s1[8], s2[8], K[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = K[j] = 0.f;
  if (c < C) {
#pragma unroll
    for (int j = 0; j < 8; ++j) K[j] = __bfloat162float(xb[((c + j) / cpg) * cpg]);
    uint4 raw[kRows];   // this thread's rows, loaded first
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = chunk * kChunk + lr + i * kLanes;
      raw[i] = t < T_ ? __ldg(reinterpret_cast<const uint4*>(xb + (long long)t * C + c))
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (chunk * kChunk + lr + i * kLanes >= T_) break;
      const bf16* e = reinterpret_cast<const bf16*>(&raw[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = __bfloat162float(e[j]) - K[j];
        s1[j] += d;
        s2[j] += d * d;
      }
    }
  }
  __shared__ float2 red[kLanes][kSlab];
#pragma unroll
  for (int j = 0; j < 8; ++j) red[lr][8 * v + j] = make_float2(s1[j], s2[j]);
  __syncthreads();
  const int col = threadIdx.x;
  if (col < kSlab && c0 + col < C) {
    float p1 = 0.f, p2 = 0.f;
    for (int r = 0; r < kLanes; ++r) {
      p1 += red[r][col].x;
      p2 += red[r][col].y;
    }
    part[((long long)b * gridDim.x + chunk) * C + c0 + col] = make_float2(p1, p2);
  }
}

struct ActArgs {
  const bf16* src;       // [B, T, C]: x (GN1) or h (GN2)
  bf16* dst;             // [B, T, C]: silu(GN(src)) rounded
  const float2* part;    // [B, nrt, C]: column sums of src - K and squares
  const float* gamma;    // [C]
  const float* beta;
  const float* kb1;      // GN2: K_g = kb1[c_g] + ktemb[b][c_g]; null (GN1):
  const bf16* ktemb;     //   K_g = src[b][0][c_g]
  int nrt, T, C, cpg;
  float eps;
};

// a = bf16(silu(GN(src))) over a 128-row x 64-channel block, GroupNorm's
// statistics reduced from the partial sums of its groups in f64, in order.
__global__ void __launch_bounds__(kSAThreads)
resnet_act_kernel(ActArgs a) {
  const int t0 = blockIdx.x * kChunk, c0 = blockIdx.y * kSlab, b = blockIdx.z;
  const int C = a.C, cpg = a.cpg, tid = threadIdx.x;
  const int c_end = min(c0 + kSlab, C);
  const int g_lo = c0 / cpg, g_hi = (c_end - 1) / cpg;
  // this thread's rows (16 bytes each) are loaded first: they fly while
  // the statistics are reduced
  const int v = tid % 8, lr = tid / 8;
  const int c = c0 + 8 * v;
  const long long base = (long long)b * a.T * C + c;
  uint4 raw[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = t0 + lr + i * kLanes;
    raw[i] = t < a.T && c < C
                 ? __ldg(reinterpret_cast<const uint4*>(a.src + base + (long long)t * C))
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  __shared__ float mean_s[kSlab + 1], rstd_s[kSlab + 1];
  __shared__ float sc[kSlab], sh[kSlab];
  // 1. each of this block's groups, one warp a group: its (row tile,
  // column) partial sums, lane i taking pairs i, i + 32, ..., then summed
  // over the warp's lanes
  const int warp = tid / 32, lane = tid % 32;
  for (int gi = warp; gi <= g_hi - g_lo; gi += kSAThreads / 32) {
    const int cg = (g_lo + gi) * cpg;
    const float2* p = a.part + (long long)b * a.nrt * C + cg;
    double s1 = 0.0, s2 = 0.0;
#pragma unroll 8
    for (int i = lane; i < a.nrt * cpg; i += 32) {
      const int r = i / cpg;
      const float2 v = p[(long long)r * C + (i - r * cpg)];
      s1 += v.x;
      s2 += v.y;
    }
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) {   // 2. the group's mean and rstd
      const float K = a.kb1 != nullptr
                          ? a.kb1[cg] + __bfloat162float(a.ktemb[(long long)b * C + cg])
                          : __bfloat162float(a.src[(long long)b * a.T * C + cg]);
      const double n = (double)a.T * cpg;
      const double m = s1 / n;
      const double var = fmax(s2 / n - m * m, 0.0);
      mean_s[gi] = (float)(K + m);
      rstd_s[gi] = (float)(1.0 / sqrt(var + (double)a.eps));
    }
  }
  __syncthreads();
  // 3. per channel, GN as one FMA: y = x * sc + sh
  for (int j = tid; j < c_end - c0; j += kSAThreads) {
    const int c = c0 + j, gi = c / cpg - g_lo;
    sc[j] = a.gamma[c] * rstd_s[gi];
    sh[j] = a.beta[c] - mean_s[gi] * sc[j];
  }
  __syncthreads();
  // 4. normalise, activate, round, store
  if (c >= C) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = t0 + lr + i * kLanes;
    if (t >= a.T) break;
    bf16* e = reinterpret_cast<bf16*>(&raw[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16(silu(__bfloat162float(e[j]) * sc[8 * v + j] + sh[8 * v + j]));
    *reinterpret_cast<uint4*>(a.dst + base + (long long)t * C) = raw[i];
  }
}

struct TcArgs {
  const float* bias;     // [Cout]: b1 (conv1) or b2 (conv2)
  const float* bs;       // [Cout] shortcut bias, or null
  const bf16* temb;      // [B, Cout] (conv1; with b1, GN2's shift K2)
  const bf16* x;         // [B, T, Cout]: the identity shortcut (conv2)
  bf16* out;             // [B, T, Cout]: h (conv1) or the block's output
  float2* part;          // conv1: GN2's partial sums [B][row tiles][Cout]
  int T, Cout, cpg2;     // cpg2 = Cout / G
  int nk_main;           // K steps over the main input: 3 taps x chunks
  int nk_short;          // K steps of the 1x1 shortcut (conv2), or 0
  int identity;          // conv2: add x (Cin == Cout)
};

template <int NWG, int BN>
struct TcTile {
  static constexpr int BM = 64 * NWG;
  static constexpr int kStages = 4;                   // the ring's depth
  static constexpr int kA = BM * 128;                 // A box: BM rows x 128 B
  static constexpr int kW = BN * 128;                 // W box: BN rows x 128 B
  static constexpr int kStage = kA + kW;
  static constexpr int kThreads = NWG * 128 + 32;     // + one producer warp
  static constexpr int kRed = NWG * 4 * BN * 8;       // conv1's column sums
  // 1024 bytes to align the ring (the 128-byte swizzle's period)
  static constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8 + kRed;
};

// One BM x BN output tile of a k3 convolution (+ the 1x1 shortcut) on the
// tensor cores.  Warps 0 .. 4 NWG - 1 consume, warp 4 NWG produces.
template <int NWG, int BN, bool kConv2>
__global__ void __launch_bounds__(TcTile<NWG, BN>::kThreads)
resnet_conv_tc_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_ws, TcArgs a) {
  using L = TcTile<NWG, BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_full = base + L::kStages * L::kStage;
  const uint32_t bar_empty = bar_full + L::kStages * 8;
  float2* red = reinterpret_cast<float2*>(smem_raw + (base - raw) + L::kStages * L::kStage +
                                          2 * L::kStages * 8);

  const int m0 = blockIdx.x * L::BM, n0 = blockIdx.y * BN, b = blockIdx.z;
  const int nk = a.nk_main + a.nk_short;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NWG * 4);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // producer: K step `it` = (64-channel chunk, tap), taps innermost so
    // the three shifted boxes of a chunk follow one another in L2
    if (lane == 0) {
      tma_prefetch_map(&tm_a);
      tma_prefetch_map(&tm_w);
      for (int it = 0; it < nk; ++it) {
        const int s = it % L::kStages;
        mbar_wait(bar_empty + 8 * s, ((it / L::kStages) & 1) ^ 1);
        const uint32_t sa = base + s * L::kStage, sw = sa + L::kA;
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, L::kStage);
        if (it < a.nk_main) {
          const int chunk = it / 3, tap = it % 3;
          tma_load_3d(sa, &tm_a, chunk * kBoxK, m0 + tap - 1, b, full);
          tma_load_3d(sw, &tm_w, chunk * kBoxK, n0, tap, full);
        } else {
          const int chunk = it - a.nk_main;
          tma_load_3d(sa, &tm_x, chunk * kBoxK, m0, b, full);
          tma_load_2d(sw, &tm_ws, chunk * kBoxK, n0, full);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64)
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int s = it % L::kStages;
    mbar_wait(bar_full + 8 * s, (it / L::kStages) & 1);
    const uint32_t sa = base + s * L::kStage + wg * 64 * 128;
    const uint32_t sw = base + s * L::kStage + L::kA;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBoxK / 16; ++ks)
      wgmma_ss(acc, sw128_desc(sa + 32 * ks), sw128_desc(sw + 32 * ks), 1);
    wgmma_commit();
    // the previous step's products are done: its stage is free
    wgmma_wait<1>();
    if (it > 0 && lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % L::kStages));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: this thread holds rows rr, rr + 8 and columns cq, cq + 1 of
  // every 8 (wgmma's accumulator layout)
  const int w4 = warp % 4;
  const int rr = m0 + wg * 64 + 16 * w4 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int T_ = a.T, Cout = a.Cout;
  bf16* outb = a.out + (long long)b * T_ * Cout;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int co = n0 + 8 * j + cq;
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
    if (co < Cout) {
      float add0 = a.bias[co], add1 = a.bias[co + 1];
      float K0 = 0.f, K1 = 0.f;
      if (!kConv2) {
        const bf16* tb = a.temb + (long long)b * Cout;
        add0 += __bfloat162float(tb[co]);
        add1 += __bfloat162float(tb[co + 1]);
        const int g0 = (co / a.cpg2) * a.cpg2, g1 = ((co + 1) / a.cpg2) * a.cpg2;
        K0 = a.bias[g0] + __bfloat162float(tb[g0]);
        K1 = a.bias[g1] + __bfloat162float(tb[g1]);
      } else if (a.bs != nullptr) {
        add0 += a.bs[co];
        add1 += a.bs[co + 1];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = rr + 8 * hh;
        if (t < T_) {
          float v0 = acc[4 * j + 2 * hh] + add0, v1 = acc[4 * j + 2 * hh + 1] + add1;
          if (kConv2 && a.identity) {
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
                a.x + ((long long)b * T_ + t) * Cout + co);
            v0 += __low2float(xv);
            v1 += __high2float(xv);
          }
          const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(outb + (long long)t * Cout + co) = o;
          if (!kConv2) {   // GN2's sums of the rounded h
            const float d0 = __low2float(o) - K0, d1 = __high2float(o) - K1;
            s1[0] += d0;
            s2[0] += d0 * d0;
            s1[1] += d1;
            s2[1] += d1 * d1;
          }
        }
      }
    }
    if (!kConv2) {
      // over the 8 lanes that hold these two columns (lane / 4 = row)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], o);
          s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], o);
        }
      if (lane < 4) {
        red[(wg * 4 + w4) * BN + 8 * j + cq] = make_float2(s1[0], s2[0]);
        red[(wg * 4 + w4) * BN + 8 * j + cq + 1] = make_float2(s1[1], s2[1]);
      }
    }
  }
  if (!kConv2) {
    bar_sync(1, NWG * 128);   // the consumers only: the producer has left
    for (int col = threadIdx.x; col < BN; col += NWG * 128) {
      const int co = n0 + col;
      if (co >= Cout) continue;
      float p1 = 0.f, p2 = 0.f;
      for (int w = 0; w < NWG * 4; ++w) {
        const float2 v = red[w * BN + col];
        p1 += v.x;
        p2 += v.y;
      }
      a.part[((long long)b * gridDim.x + blockIdx.x) * Cout + co] = make_float2(p1, p2);
    }
  }
}

// ------------------------------------------------------------ host side

// A tensor map over a bf16 array of `rank` (2 or 3) dims d0 (innermost),
// d1, d2, with a 64-element x `rows` (x 1) box and the 128-byte swizzle.
bool encode(CUtensorMap* m, const void* p, int rank, long long d0, long long d1,
            long long d2, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)(d0 * 2), (cuuint64_t)(d0 * d1 * 2)};
  const cuuint32_t box[3] = {(cuuint32_t)kBoxK, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(p), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap a, w, x, ws;
};

template <int NWG, int BN, bool kConv2>
cudaError_t launch_tc(const Maps& m, const TcArgs& a, int B, cudaStream_t s) {
  using L = TcTile<NWG, BN>;
  static unsigned long long configured = 0;
  auto kern = resnet_conv_tc_kernel<NWG, BN, kConv2>;
  cudaError_t err = opt_in(kern, L::kSmem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + L::BM - 1) / L::BM, (a.Cout + BN - 1) / BN, B);
  kern<<<grid, L::kThreads, L::kSmem, s>>>(m.a, m.w, m.x, m.ws, a);
  return cudaGetLastError();
}

// The tile shapes the wrapper's rule may pick (ops/cuda/resnet.py: TILES).
bool tile_ok(int bm, int bn) {
  return (bm == 64 && (bn == 64 || bn == 128)) || (bm == 128 && bn == 128);
}

template <bool kConv2>
cudaError_t launch_conv(int bm, int bn, const Maps& m, const TcArgs& a, int B,
                        cudaStream_t s) {
  if (bm == 64 && bn == 64) return launch_tc<1, 64, kConv2>(m, a, B, s);
  if (bm == 64 && bn == 128) return launch_tc<1, 128, kConv2>(m, a, B, s);
  if (bm == 128 && bn == 128) return launch_tc<2, 128, kConv2>(m, a, B, s);
  return cudaErrorInvalidValue;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
long long up256(long long n) { return (n + 255) / 256 * 256; }

// The scratch buffer's regions (byte offsets): bf16: the activated input
// (a, then a2), h and the partial sums; f32: h, GN1's statistics and GN2's
// partials.
struct Layout {
  long long act, h, stats, part, bytes;
};

Layout layout(int B, int T, int Cin, int Cout, int G, int dtype, int bm) {
  Layout l{};
  if (dtype == 1) {
    const long long parts = cdiv(T, kChunk) * Cin > cdiv(T, bm) * Cout
                                ? cdiv(T, kChunk) * Cin
                                : cdiv(T, bm) * Cout;
    l.act = 0;
    l.h = up256(2LL * B * T * (Cin > Cout ? Cin : Cout));
    l.part = l.h + up256(2LL * B * T * Cout);
    l.bytes = l.part + up256(8LL * B * parts);
  } else {
    l.h = 0;
    l.stats = up256(4LL * B * T * Cout);
    l.part = l.stats + up256(8LL * B * G);
    l.bytes = l.part + up256(8LL * B * cdiv(T, kBM) * cdiv(Cout, kBN) * G);
  }
  return l;
}

cudaError_t run_f32(const float* x, const float* temb, const float* g1w,
                    const float* g1b, const float* w1, const float* b1,
                    const float* g2w, const float* g2b, const float* w2,
                    const float* b2, const float* ws, const float* bs,
                    char* scratch, const Layout& l, float* out, int B, int T_,
                    int Cin, int Cout, int G, float eps,
                    cudaStream_t s) {
  float* h = reinterpret_cast<float*>(scratch + l.h);
  float* stats1 = reinterpret_cast<float*>(scratch + l.stats);
  float* part = reinterpret_cast<float*>(scratch + l.part);
  resnet_gn_stats_f32_kernel<<<dim3(G, B), kStatsThreads, 0, s>>>(x, stats1, T_, Cin,
                                                                  G, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((T_ + kBM - 1) / kBM, (Cout + kBN - 1) / kBN, B);
  F32Args a{};
  a.x = x; a.temb = temb; a.b1 = b1; a.part = part; a.stats1 = stats1;
  a.B = B; a.T = T_; a.Cin = Cin; a.Cout = Cout; a.G = G;
  a.eps = eps;
  // conv1: x -> h
  a.in = x; a.Cmain = Cin; a.w = w1; a.bias = b1; a.gamma = g1w; a.beta = g1b;
  a.ws = nullptr; a.bs = nullptr; a.out = h;
  resnet_conv_f32_kernel<false><<<grid, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // conv2: h -> out (+ shortcut of x)
  a.in = h; a.Cmain = Cout; a.w = w2; a.bias = b2; a.gamma = g2w; a.beta = g2b;
  a.ws = ws; a.bs = bs; a.out = out;
  resnet_conv_f32_kernel<true><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

cudaError_t run_bf16(const bf16* x, const bf16* temb, const float* g1w,
                     const float* g1b, const bf16* w1, const float* b1,
                     const float* g2w, const float* g2b, const bf16* w2,
                     const float* b2, const bf16* ws, const float* bs,
                     char* scratch, const Layout& l, bf16* out, int B, int T_,
                     int Cin, int Cout, int G, float eps, int bm,
                     int bn, cudaStream_t s) {
  bf16* act = reinterpret_cast<bf16*>(scratch + l.act);
  bf16* h = reinterpret_cast<bf16*>(scratch + l.h);
  float2* part = reinterpret_cast<float2*>(scratch + l.part);
  const int nch = (int)cdiv(T_, kChunk);
  const int nmt = (int)cdiv(T_, bm);

  // conv1's maps (a over [B, T, Cin], w1 [3, Cout, Cin]) and conv2's (a2
  // over [B, T, Cout], w2 [3, Cout, Cout], x [B, T, Cin], ws [Cout, Cin])
  Maps m1, m2;
  if (!encode(&m1.a, act, 3, Cin, T_, B, bm) || !encode(&m1.w, w1, 3, Cin, Cout, 3, bn) ||
      !encode(&m2.a, act, 3, Cout, T_, B, bm) || !encode(&m2.w, w2, 3, Cout, Cout, 3, bn))
    return cudaErrorNotSupported;
  m1.x = m1.a;
  m1.ws = m1.w;
  m2.x = m2.a;
  m2.ws = m2.w;
  if (ws != nullptr &&
      (!encode(&m2.x, x, 3, Cin, T_, B, bm) || !encode(&m2.ws, ws, 2, Cin, Cout, 1, bn)))
    return cudaErrorNotSupported;

  // 1./2. GN1: partial sums, then a = silu(GN1(x))
  resnet_stats_kernel<<<dim3(nch, (int)cdiv(Cin, kSlab), B), kSAThreads, 0, s>>>(
      x, part, T_, Cin, Cin / G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ActArgs aa{x, act, part, g1w, g1b, nullptr, nullptr, nch, T_, Cin, Cin / G, eps};
  resnet_act_kernel<<<dim3(nch, (int)cdiv(Cin, kSlab), B), kSAThreads, 0, s>>>(aa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 3. conv1: a -> h, GN2's partial sums
  TcArgs c{};
  c.bias = b1; c.temb = temb; c.out = h; c.part = part;
  c.T = T_; c.Cout = Cout; c.cpg2 = Cout / G;
  c.nk_main = 3 * (int)cdiv(Cin, kBoxK);
  err = launch_conv<false>(bm, bn, m1, c, B, s);
  if (err != cudaSuccess) return err;
  // 4. a2 = silu(GN2(h)), into a's buffer
  ActArgs a2{h, act, part, g2w, g2b, b1, temb, nmt, T_, Cout, Cout / G, eps};
  resnet_act_kernel<<<dim3(nch, (int)cdiv(Cout, kSlab), B), kSAThreads, 0, s>>>(a2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 5. conv2: a2 -> out, + the shortcut
  c = TcArgs{};
  c.bias = b2; c.bs = bs; c.x = x; c.out = out;
  c.T = T_; c.Cout = Cout; c.cpg2 = Cout / G;
  c.nk_main = 3 * (int)cdiv(Cout, kBoxK);
  c.nk_short = ws != nullptr ? (int)cdiv(Cin, kBoxK) : 0;
  c.identity = ws == nullptr;
  return launch_conv<true>(bm, bn, m2, c, B, s);
}

}  // namespace

// Bytes of the scratch buffer the wrapper allocates for one call.
extern "C" long long ptts_resnet_scratch_bytes(int B, int T, int Cin, int Cout,
                                               int G, int dtype, int bm) {
  return layout(B, T, Cin, Cout, G, dtype, bm).bytes;
}

// x [B,T,Cin], temb [B,Cout] and out [B,T,Cout] in `dtype` (0 f32, 1 bf16);
// w1 [3,Cout,Cin], w2 [3,Cout,Cout], ws [Cout,Cin] or null (Cin == Cout) in
// `dtype`; norms and biases f32; `scratch` ptts_resnet_scratch_bytes bytes.
// All contiguous on one device, 16-byte aligned.  bf16 takes the tile shape
// (bm, bn) of its products; f32 ignores it.  Launches on `stream`; returns
// the first error.
extern "C" int ptts_resnet_block(const void* x, const void* temb,
                                 const float* g1w, const float* g1b,
                                 const void* w1, const float* b1,
                                 const float* g2w, const float* g2b,
                                 const void* w2, const float* b2,
                                 const void* ws, const float* bs,
                                 void* scratch, void* out, int B, int T,
                                 int Cin, int Cout, int G,
                                 float eps, int dtype, int bm, int bn,
                                 void* stream) {
  if (B <= 0 || T <= 0 || Cin <= 0 || Cout <= 0 || G <= 0 || G > kMaxGroups ||
      Cin % G != 0 || Cout % G != 0 || Cin / G > kMaxCpg ||
      (ws == nullptr && Cin != Cout) || Cin % 8 != 0 ||
      Cout % 8 != 0 || (dtype == 1 && !tile_ok(bm, bn)))
    return cudaErrorInvalidValue;
  for (const void* p : {x, w1, w2, ws, (const void*)scratch, (const void*)out})
    if (reinterpret_cast<unsigned long long>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(B, T, Cin, Cout, G, dtype, bm);
  char* sc = static_cast<char*>(scratch);
  if (dtype == 0)
    return run_f32(static_cast<const float*>(x), static_cast<const float*>(temb), g1w, g1b,
                   static_cast<const float*>(w1), b1, g2w, g2b,
                   static_cast<const float*>(w2), b2,
                   static_cast<const float*>(ws), bs, sc, l,
                   static_cast<float*>(out), B, T, Cin, Cout, G, eps, s);
  if (dtype == 1)
    return run_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(temb), g1w, g1b,
                    static_cast<const bf16*>(w1), b1, g2w, g2b,
                    static_cast<const bf16*>(w2), b2,
                    static_cast<const bf16*>(ws), bs, sc, l,
                    static_cast<bf16*>(out), B, T, Cin, Cout, G, eps, bm,
                    bn, s);
  return cudaErrorInvalidValue;
}

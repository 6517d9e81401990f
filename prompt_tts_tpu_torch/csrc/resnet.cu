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
// Both types make the same five launches, the products on wgmma:
//   1. resnet_stats_kernel: per (128-row chunk, 64-channel slab, batch) the
//      column sums of x - K and their squares, 16-byte loads of whole
//      128-byte row segments.
//   2. resnet_act_kernel: reduces the partial sums of its slab's groups in
//      f64 (fixed order) to mean and rstd, then writes a = silu(GN1(x))
//      once, [B, T, Cin].  Normalising once here, and not in every
//      output-channel tile of the product, is what the kernels this
//      replaces did not do (12 times per element at Cout = 768).
//   3. resnet_conv_tc_kernel<.., false>: conv1 as an implicit GEMM: M = T
//      rows of one batch element, N = Cout, K = 3 taps x Cin.  A TMA map
//      over a [B, T, Cin] whose box is one 128-byte row of channels x BM
//      rows, with the 128-byte swizzle: tap s in {-1, 0, 1} is one box at
//      row t0 + s, and TMA zero-fills rows outside [0, T) -- exactly the
//      convolution's zero padding of the activated input -- and channels
//      past Cin.  The weights, packed once as [3, Cout, Cin] (K-major),
//      under a second map.  A ring of stages in shared memory with
//      full/empty mbarriers, kept full by one producer warp; one or two
//      consumer warpgroups (BM = 64 or 128) run wgmma m64nBN (BN = 64 or
//      128) with both operands in shared memory and f32 accumulators in
//      registers.  Epilogue from registers: + b1 + temb_proj[b], h rounded
//      to x's type and stored, and the column sums of the stored h - K2
//      for GN2, per (row tile, channel).
//   4. resnet_act_kernel again: a2 = silu(GN2(h)) (reusing a's buffer).
//   5. resnet_conv_tc_kernel<.., true>: conv2 the same way over a2; a 1x1
//      shortcut is more K steps over x (its own map) against ws [Cout,
//      Cin]; an identity shortcut adds x in the epilogue; + b2, + bs.
//   The tile shape (BM, BN) comes from the caller (ops/cuda/resnet.py:
//   resnet_tiles).
//
// bf16: a and a2 rounded to bf16; a stage is one 64-channel box of a (BM
// rows) and of w (BN rows), four wgmma m64nBNk16; four stages.
//
// f32: every product in 3 x TF32, which holds the f32 contracts (1e-4 on
// the kernel, 5e-4 on the model) that one TF32 product would miss.  Each
// operand is split once into hi = rna(v) and lo = rna(v - hi) (cvt.rna:
// TF32, the low 13 bits zero), kept as two planes [2][...] of one array:
// the weights when the wrapper packs them (ops/cuda/resnet.py:
// split_planes, the same bits as cvt.rna), a and a2 by the activation
// pass as it writes them, and x (for a 1x1 shortcut) by the first
// activation pass beside a.  A stage holds the hi and lo boxes
// of one 32-channel row of a and of w, fetched by one 4-D TMA load each
// (the plane is the box's outer dimension); its products are wgmma
// m64nBNk8 .tf32, a_hi w_lo, then a_lo w_hi, then a_hi w_hi, four k8 steps
// each (the small terms first, as rvq.cu and the attention kernels take
// them; a_lo w_lo, ~2^-22 of |a||w|, is dropped).  The tensor cores add
// each k8 step's products to the accumulator with truncation, not
// rounding, so one accumulator over the 3 x 3 Cin / 8 steps of a K loop
// drifts toward zero: its error grew with Cin, to ten times the f32 FMA
// kernel's at Cin = 1536, and took the prompt model's f32 card-against-CPU
// check past its 5e-4.  So the products of kFold = 3 stages (one chunk's
// three taps, 36 steps) go to a partial accumulator, which is added to an
// f32 total (rounded to nearest) once its products are done.  Three stages; the tile is 128 x
// 128 (64 KB a stage) or 64 x 64 (32 KB: two CTAs share an SM).
//
// What bounds it.  A block is 2 B T (3 Cin Cout + 3 Cout^2 [+ Cin Cout])
// flops against a few MB of activations: the tensor-core rate bounds it,
// three times over in f32 (three TF32 products at 495 TFLOP/s).  The
// activation passes add one write and about three reads of a and a2,
// mostly from L2.  In f32 a stage brings 256 bytes a tile row for 32
// channels of K where bf16 brings 128 for 64: L2's rate may set the pace
// before the tensor cores do.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C interface,
// loaded with ctypes by prompt_tts_tpu_torch/ops/cuda/resnet.py).  The TMA
// maps are encoded on the host by cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (tma_host.cuh), so nothing links libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <initializer_list>
#include <type_traits>

#include "tma_host.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace ptts;

constexpr int kMaxGroups = 128;
constexpr int kMaxCpg = 256;   // channels a group may hold

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// Two neighbouring values of a row, as floats.
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return make_float2(__low2float(v), __high2float(v));
}

// Store two neighbouring values rounded to the element type; returns what
// was stored.
__device__ __forceinline__ float2 st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
  return make_float2(a, b);
}
__device__ __forceinline__ float2 st2(bf16* p, float a, float b) {
  const __nv_bfloat162 o = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(p) = o;
  return make_float2(__low2float(o), __high2float(o));
}

constexpr int kSlab = 64;       // channels a stats / activation CTA covers
constexpr int kChunk = 128;     // rows a stats / activation CTA covers
constexpr int kSAThreads = 256;

// How a stats / activation CTA cuts its 128 x 64 block: a thread takes one
// 16-byte vector (V elements) of each of ROWS rows, LANES rows apart.
template <typename E>
struct Slab {
  static constexpr int V = 16 / sizeof(E);
  static constexpr int VPR = kSlab / V;              // vectors a row
  static constexpr int LANES = kSAThreads / VPR;     // row lanes
  static constexpr int ROWS = kChunk / LANES;        // rows a thread loads
};

// GN1's partial sums: per (128-row chunk, channel) the sum of x - K and of
// its square, part[b][chunk][c].
template <typename E>
__global__ void __launch_bounds__(kSAThreads)
resnet_stats_kernel(const E* __restrict__ x, float2* __restrict__ part,
                    int T_, int C, int cpg) {
  using S = Slab<E>;
  const int chunk = blockIdx.x, c0 = blockIdx.y * kSlab, b = blockIdx.z;
  const int v = threadIdx.x % S::VPR, lr = threadIdx.x / S::VPR;
  const int c = c0 + S::V * v;
  const E* xb = x + (long long)b * T_ * C;
  float s1[S::V], s2[S::V], K[S::V];
#pragma unroll
  for (int j = 0; j < S::V; ++j) s1[j] = s2[j] = K[j] = 0.f;
  if (c < C) {
#pragma unroll
    for (int j = 0; j < S::V; ++j) K[j] = to_f(xb[((c + j) / cpg) * cpg]);
    uint4 raw[S::ROWS];   // this thread's rows, loaded first
#pragma unroll
    for (int i = 0; i < S::ROWS; ++i) {
      const int t = chunk * kChunk + lr + i * S::LANES;
      raw[i] = t < T_ ? __ldg(reinterpret_cast<const uint4*>(xb + (long long)t * C + c))
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < S::ROWS; ++i) {
      if (chunk * kChunk + lr + i * S::LANES >= T_) break;
      const E* e = reinterpret_cast<const E*>(&raw[i]);
#pragma unroll
      for (int j = 0; j < S::V; ++j) {
        const float d = to_f(e[j]) - K[j];
        s1[j] += d;
        s2[j] += d * d;
      }
    }
  }
  __shared__ float2 red[S::LANES][kSlab];
#pragma unroll
  for (int j = 0; j < S::V; ++j) red[lr][S::V * v + j] = make_float2(s1[j], s2[j]);
  __syncthreads();
  const int col = threadIdx.x;
  if (col < kSlab && c0 + col < C) {
    float p1 = 0.f, p2 = 0.f;
    for (int r = 0; r < S::LANES; ++r) {
      p1 += red[r][col].x;
      p2 += red[r][col].y;
    }
    part[((long long)b * gridDim.x + chunk) * C + c0 + col] = make_float2(p1, p2);
  }
}

struct ActArgs {
  const void* src;       // [B, T, C]: x (GN1) or h (GN2)
  void* dst;             // [B, T, C]: silu(GN(src)), bf16; f32: its TF32 hi
  float* dst_lo;         //   plane (dst) and lo plane (dst_lo)
  float* src_hi;         // f32, or null: src's own split, hi and lo planes
  float* src_lo;         //   (x, for the 1x1 shortcut)
  const float2* part;    // [B, nrt, C]: column sums of src - K and squares
  const float* gamma;    // [C]
  const float* beta;
  const float* kb1;      // GN2: K_g = kb1[c_g] + ktemb[b][c_g]; null (GN1):
  const void* ktemb;     //   K_g = src[b][0][c_g]
  int nrt, T, C, cpg;
  float eps;
};

// Four values split (split_tf32) and stored as 16 bytes at hi and at lo.
__device__ __forceinline__ void store_split(float* hi, float* lo, float a, float b,
                                            float c, float d) {
  uint32_t h[4], l[4];
  split_tf32(a, h[0], l[0]);
  split_tf32(b, h[1], l[1]);
  split_tf32(c, h[2], l[2]);
  split_tf32(d, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// a = silu(GN(src)) over a 128-row x 64-channel block, GroupNorm's
// statistics reduced from the partial sums of its groups in f64, in order;
// bf16 rounds a, f32 splits it (and src, where asked).
template <typename E>
__global__ void __launch_bounds__(kSAThreads)
resnet_act_kernel(ActArgs a) {
  using S = Slab<E>;
  const E* src = static_cast<const E*>(a.src);
  const int t0 = blockIdx.x * kChunk, c0 = blockIdx.y * kSlab, b = blockIdx.z;
  const int C = a.C, cpg = a.cpg, tid = threadIdx.x;
  const int c_end = min(c0 + kSlab, C);
  const int g_lo = c0 / cpg, g_hi = (c_end - 1) / cpg;
  // this thread's rows (16 bytes each) are loaded first: they fly while
  // the statistics are reduced
  const int v = tid % S::VPR, lr = tid / S::VPR;
  const int c = c0 + S::V * v;
  const long long base = (long long)b * a.T * C + c;
  uint4 raw[S::ROWS];
#pragma unroll
  for (int i = 0; i < S::ROWS; ++i) {
    const int t = t0 + lr + i * S::LANES;
    raw[i] = t < a.T && c < C
                 ? __ldg(reinterpret_cast<const uint4*>(src + base + (long long)t * C))
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
      const float K =
          a.kb1 != nullptr
              ? a.kb1[cg] + to_f(static_cast<const E*>(a.ktemb)[(long long)b * C + cg])
              : to_f(src[(long long)b * a.T * C + cg]);
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
  // 4. normalise, activate, round or split, store
  if (c >= C) return;
  const float* scv = sc + S::V * v;
  const float* shv = sh + S::V * v;
#pragma unroll
  for (int i = 0; i < S::ROWS; ++i) {
    const int t = t0 + lr + i * S::LANES;
    if (t >= a.T) break;
    const long long off = base + (long long)t * C;
    if constexpr (std::is_same_v<E, bf16>) {
      bf16* e = reinterpret_cast<bf16*>(&raw[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16(silu(__bfloat162float(e[j]) * scv[j] + shv[j]));
      *reinterpret_cast<uint4*>(static_cast<bf16*>(a.dst) + off) = raw[i];
    } else {
      const float* e = reinterpret_cast<const float*>(&raw[i]);
      store_split(static_cast<float*>(a.dst) + off, a.dst_lo + off,
                  silu(e[0] * scv[0] + shv[0]), silu(e[1] * scv[1] + shv[1]),
                  silu(e[2] * scv[2] + shv[2]), silu(e[3] * scv[3] + shv[3]));
      if (a.src_hi != nullptr)
        store_split(a.src_hi + off, a.src_lo + off, e[0], e[1], e[2], e[3]);
    }
  }
}

// The products' element type: a K step's box is one 128-byte row of
// channels, kBoxK of them; f32 keeps every operand as two planes (hi, lo).
template <typename E>
struct Prod {
  static constexpr bool kF32 = std::is_same_v<E, float>;
  static constexpr int kBoxK = 128 / sizeof(E);
  static constexpr int kPlanes = kF32 ? 2 : 1;
};

template <typename E>
struct TcArgs {
  const float* bias;     // [Cout]: b1 (conv1) or b2 (conv2)
  const float* bs;       // [Cout] shortcut bias, or null
  const E* temb;         // [B, Cout] (conv1; with b1, GN2's shift K2)
  const E* x;            // [B, T, Cout]: the identity shortcut (conv2)
  E* out;                // [B, T, Cout]: h (conv1) or the block's output
  float2* part;          // conv1: GN2's partial sums [B][row tiles][Cout]
  int T, Cout, cpg2;     // cpg2 = Cout / G
  int nk_main;           // K steps over the main input: 3 taps x chunks
  int nk_short;          // K steps of the 1x1 shortcut (conv2), or 0
  int identity;          // conv2: add x (Cin == Cout)
};

// f32: the stages whose products the tensor cores sum in one partial
// accumulator before it is added to the f32 total (one 32-channel chunk's
// three taps).
constexpr int kFold = 3;

template <typename E, int NWG, int BN>
struct TcTile {
  static constexpr int BM = 64 * NWG;
  static constexpr int kA = Prod<E>::kPlanes * BM * 128;   // A box: BM rows x 128 B a plane
  static constexpr int kW = Prod<E>::kPlanes * BN * 128;   // W box: BN rows x 128 B a plane
  static constexpr int kStage = kA + kW;
  // the ring's depth: bf16 4 (at most 128 KB); f32 3 (192 KB at 128 x 128,
  // one CTA an SM; 96 KB at 64 x 64, two)
  static constexpr int kStages = Prod<E>::kF32 ? 3 : 4;
  static constexpr int kThreads = NWG * 128 + 32;     // + one producer warp
  static constexpr int kRed = NWG * 4 * BN * 8;       // conv1's column sums
  // 1024 bytes to align the ring (the 128-byte swizzle's period)
  static constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8 + kRed;
};

static_assert(TcTile<float, 2, 128>::kSmem <= 232448, "shared memory");

// One stage's products into acc: bf16, four k16 steps; f32, 3 x TF32 over
// four k8 steps each, the hi planes at sa and sw, the lo planes one plane
// (BM or BN rows) on.  accumulate = 0 starts acc afresh.
template <typename E, int BN, int BM>
__device__ __forceinline__ void stage_products(float (&acc)[BN / 2], uint32_t sa,
                                               uint32_t sw, int accumulate) {
  if constexpr (!Prod<E>::kF32) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss(acc, sw128_desc(sa + 32 * ks), sw128_desc(sw + 32 * ks),
               ks > 0 || accumulate);
  } else {
    const uint32_t sa_lo = sa + BM * 128, sw_lo = sw + BN * 128;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_tf32_ss(acc, sw128_desc(sa + 32 * ks), sw128_desc(sw_lo + 32 * ks),
                    ks > 0 || accumulate);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_tf32_ss(acc, sw128_desc(sa_lo + 32 * ks), sw128_desc(sw + 32 * ks), 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_tf32_ss(acc, sw128_desc(sa + 32 * ks), sw128_desc(sw + 32 * ks), 1);
  }
}

// One BM x BN output tile of a k3 convolution (+ the 1x1 shortcut) on the
// tensor cores.  Warps 0 .. 4 NWG - 1 consume, warp 4 NWG produces.
template <typename E, int NWG, int BN, bool kConv2>
__global__ void __launch_bounds__(TcTile<E, NWG, BN>::kThreads)
resnet_conv_tc_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_ws, TcArgs<E> a) {
  using L = TcTile<E, NWG, BN>;
  using P = Prod<E>;
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
    // producer: K step `it` = (channel chunk, tap), taps innermost so the
    // three shifted boxes of a chunk follow one another in L2.  f32's maps
    // have the plane (hi, lo) as their outer dimension: one load brings
    // both.
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
          const int k0 = (it / 3) * P::kBoxK, tap = it % 3;
          if constexpr (P::kF32) {
            tma_load_4d(sa, &tm_a, k0, m0 + tap - 1, b, 0, full);
            tma_load_4d(sw, &tm_w, k0, n0, tap, 0, full);
          } else {
            tma_load_3d(sa, &tm_a, k0, m0 + tap - 1, b, full);
            tma_load_3d(sw, &tm_w, k0, n0, tap, full);
          }
        } else {
          const int k0 = (it - a.nk_main) * P::kBoxK;
          if constexpr (P::kF32) {
            tma_load_4d(sa, &tm_x, k0, m0, b, 0, full);
            tma_load_3d(sw, &tm_ws, k0, n0, 0, full);
          } else {
            tma_load_3d(sa, &tm_x, k0, m0, b, full);
            tma_load_2d(sw, &tm_ws, k0, n0, full);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64).
  // bf16 accumulates in acc; f32 in part, folded into acc every kFold
  // stages (the header says why)
  const int wg = warp / 4;
  float acc[BN / 2];
  float part[P::kF32 ? BN / 2 : 1];   // f32 only
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  if constexpr (P::kF32) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;
  }
  for (int it = 0; it < nk; ++it) {
    const int s = it % L::kStages;
    mbar_wait(bar_full + 8 * s, (it / L::kStages) & 1);
    const uint32_t sa = base + s * L::kStage + wg * 64 * 128;
    const uint32_t sw = base + s * L::kStage + L::kA;
    wgmma_fence();
    if constexpr (P::kF32)
      stage_products<E, BN, L::BM>(part, sa, sw, it % kFold != 0);
    else
      stage_products<E, BN, L::BM>(acc, sa, sw, 1);
    wgmma_commit();
    // the previous step's products are done: its stage is free
    wgmma_wait<1>();
    if (it > 0 && lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % L::kStages));
    if constexpr (P::kF32) {
      if (it % kFold == kFold - 1 || it == nk - 1) {
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: this thread holds rows rr, rr + 8 and columns cq, cq + 1 of
  // every 8 (wgmma's accumulator layout)
  const int w4 = warp % 4;
  const int rr = m0 + wg * 64 + 16 * w4 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int T_ = a.T, Cout = a.Cout;
  E* outb = a.out + (long long)b * T_ * Cout;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int co = n0 + 8 * j + cq;
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
    if (co < Cout) {
      float add0 = a.bias[co], add1 = a.bias[co + 1];
      float K0 = 0.f, K1 = 0.f;
      if (!kConv2) {
        const E* tb = a.temb + (long long)b * Cout;
        add0 += to_f(tb[co]);
        add1 += to_f(tb[co + 1]);
        const int g0 = (co / a.cpg2) * a.cpg2, g1 = ((co + 1) / a.cpg2) * a.cpg2;
        K0 = a.bias[g0] + to_f(tb[g0]);
        K1 = a.bias[g1] + to_f(tb[g1]);
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
            const float2 xv = ld2(a.x + ((long long)b * T_ + t) * Cout + co);
            v0 += xv.x;
            v1 += xv.y;
          }
          const float2 o = st2(outb + (long long)t * Cout + co, v0, v1);
          if (!kConv2) {   // GN2's sums of the stored h
            const float d0 = o.x - K0, d1 = o.y - K1;
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

// A tensor map over a contiguous bf16 or f32 array of dims (dims[0]
// innermost), with a box of `box` elements (box[0] of them one 128-byte
// row) and the 128-byte swizzle.
bool encode(CUtensorMap* m, const void* p, bool f32, std::initializer_list<long long> dims,
            std::initializer_list<int> box) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const int rank = (int)dims.size();
  cuuint64_t d[4], strides[3];
  cuuint32_t bx[4], elem[4];
  long long stride = f32 ? 4 : 2;
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims.begin()[i];
    bx[i] = (cuuint32_t)box.begin()[i];
    elem[i] = 1;
    if (i > 0) strides[i - 1] = (cuuint64_t)stride;
    stride *= dims.begin()[i];
  }
  return fn(m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            rank, const_cast<void*>(p), d, strides, bx, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap a, w, x, ws;
};

template <typename E, int NWG, int BN, bool kConv2>
cudaError_t launch_tc(const Maps& m, const TcArgs<E>& a, int B, cudaStream_t s) {
  using L = TcTile<E, NWG, BN>;
  static unsigned long long configured = 0;
  auto kern = resnet_conv_tc_kernel<E, NWG, BN, kConv2>;
  cudaError_t err = opt_in(kern, L::kSmem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + L::BM - 1) / L::BM, (a.Cout + BN - 1) / BN, B);
  kern<<<grid, L::kThreads, L::kSmem, s>>>(m.a, m.w, m.x, m.ws, a);
  return cudaGetLastError();
}

// The tile shapes the wrapper's rule may pick (ops/cuda/resnet.py: TILES,
// TILES_F32).
bool tile_ok(int bm, int bn, int dtype) {
  return (bm == 64 && (bn == 64 || (bn == 128 && dtype == 1))) || (bm == 128 && bn == 128);
}

template <typename E, bool kConv2>
cudaError_t launch_conv(int bm, int bn, const Maps& m, const TcArgs<E>& a, int B,
                        cudaStream_t s) {
  if (bm == 64 && bn == 64) return launch_tc<E, 1, 64, kConv2>(m, a, B, s);
  if constexpr (!Prod<E>::kF32) {
    if (bm == 64 && bn == 128) return launch_tc<E, 1, 128, kConv2>(m, a, B, s);
  }
  if (bm == 128 && bn == 128) return launch_tc<E, 2, 128, kConv2>(m, a, B, s);
  return cudaErrorInvalidValue;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
long long up256(long long n) { return (n + 255) / 256 * 256; }

// The scratch buffer's regions (byte offsets): the activated input (a,
// then a2; f32: its hi and lo planes), f32's split of x (a 1x1 shortcut
// only), h and the partial sums.
struct Layout {
  long long act, xs, h, part, bytes;
};

Layout layout(int B, int T, int Cin, int Cout, int dtype, int bm) {
  Layout l{};
  const long long es = dtype == 1 ? 2 : 4;
  const long long planes = dtype == 1 ? 1 : 2;
  const long long rows = (long long)B * T;
  const long long parts = cdiv(T, kChunk) * Cin > cdiv(T, bm) * Cout
                              ? cdiv(T, kChunk) * Cin
                              : cdiv(T, bm) * Cout;
  l.act = 0;
  l.xs = up256(planes * es * rows * (Cin > Cout ? Cin : Cout));
  l.h = l.xs + (dtype == 0 && Cin != Cout ? up256(2 * 4 * rows * Cin) : 0);
  l.part = l.h + up256(es * rows * Cout);
  l.bytes = l.part + up256(8LL * B * parts);
  return l;
}

template <typename E>
cudaError_t run(const E* x, const E* temb, const float* g1w, const float* g1b,
                const E* w1, const float* b1, const float* g2w, const float* g2b,
                const E* w2, const float* b2, const E* ws, const float* bs,
                char* scratch, const Layout& l, E* out, int B, int T_, int Cin,
                int Cout, int G, float eps, int bm, int bn, cudaStream_t s) {
  constexpr bool f32 = Prod<E>::kF32;
  constexpr int kBoxK = Prod<E>::kBoxK;
  E* act = reinterpret_cast<E*>(scratch + l.act);
  E* h = reinterpret_cast<E*>(scratch + l.h);
  float2* part = reinterpret_cast<float2*>(scratch + l.part);
  const long long rows = (long long)B * T_;
  // f32: the lo planes of a (then a2) and of x's split
  float* act_f = reinterpret_cast<float*>(scratch + l.act);
  float* xs = f32 && ws != nullptr ? reinterpret_cast<float*>(scratch + l.xs) : nullptr;
  float* xs_lo = xs != nullptr ? xs + rows * Cin : nullptr;
  const int nch = (int)cdiv(T_, kChunk);
  const int nmt = (int)cdiv(T_, bm);

  // conv1's maps (a over [B, T, Cin], w1 [3, Cout, Cin]) and conv2's (a2
  // over [B, T, Cout], w2 [3, Cout, Cout], x [B, T, Cin], ws [Cout, Cin]);
  // f32's have the plane as their outer dimension
  Maps m1, m2;
  bool ok;
  if (f32)
    ok = encode(&m1.a, act, true, {Cin, T_, B, 2}, {kBoxK, bm, 1, 2}) &&
         encode(&m1.w, w1, true, {Cin, Cout, 3, 2}, {kBoxK, bn, 1, 2}) &&
         encode(&m2.a, act, true, {Cout, T_, B, 2}, {kBoxK, bm, 1, 2}) &&
         encode(&m2.w, w2, true, {Cout, Cout, 3, 2}, {kBoxK, bn, 1, 2});
  else
    ok = encode(&m1.a, act, false, {Cin, T_, B}, {kBoxK, bm, 1}) &&
         encode(&m1.w, w1, false, {Cin, Cout, 3}, {kBoxK, bn, 1}) &&
         encode(&m2.a, act, false, {Cout, T_, B}, {kBoxK, bm, 1}) &&
         encode(&m2.w, w2, false, {Cout, Cout, 3}, {kBoxK, bn, 1});
  if (!ok) return cudaErrorNotSupported;
  m1.x = m1.a;
  m1.ws = m1.w;
  m2.x = m2.a;
  m2.ws = m2.w;
  if (ws != nullptr) {
    if (f32)
      ok = encode(&m2.x, xs, true, {Cin, T_, B, 2}, {kBoxK, bm, 1, 2}) &&
           encode(&m2.ws, ws, true, {Cin, Cout, 2}, {kBoxK, bn, 2});
    else
      ok = encode(&m2.x, x, false, {Cin, T_, B}, {kBoxK, bm, 1}) &&
           encode(&m2.ws, ws, false, {Cin, Cout}, {kBoxK, bn});
    if (!ok) return cudaErrorNotSupported;
  }

  // 1./2. GN1: partial sums, then a = silu(GN1(x)) (f32: split, with x's
  // own split beside it for a 1x1 shortcut)
  resnet_stats_kernel<E><<<dim3(nch, (int)cdiv(Cin, kSlab), B), kSAThreads, 0, s>>>(
      x, part, T_, Cin, Cin / G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ActArgs aa{x, act, act_f + rows * Cin, xs, xs_lo, part, g1w, g1b, nullptr, nullptr,
             nch, T_, Cin, Cin / G, eps};
  resnet_act_kernel<E><<<dim3(nch, (int)cdiv(Cin, kSlab), B), kSAThreads, 0, s>>>(aa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 3. conv1: a -> h, GN2's partial sums
  TcArgs<E> c{};
  c.bias = b1; c.temb = temb; c.out = h; c.part = part;
  c.T = T_; c.Cout = Cout; c.cpg2 = Cout / G;
  c.nk_main = 3 * (int)cdiv(Cin, kBoxK);
  err = launch_conv<E, false>(bm, bn, m1, c, B, s);
  if (err != cudaSuccess) return err;
  // 4. a2 = silu(GN2(h)), into a's buffer
  ActArgs a2{h, act, act_f + rows * Cout, nullptr, nullptr, part, g2w, g2b, b1, temb,
             nmt, T_, Cout, Cout / G, eps};
  resnet_act_kernel<E><<<dim3(nch, (int)cdiv(Cout, kSlab), B), kSAThreads, 0, s>>>(a2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 5. conv2: a2 -> out, + the shortcut
  c = TcArgs<E>{};
  c.bias = b2; c.bs = bs; c.x = x; c.out = out;
  c.T = T_; c.Cout = Cout; c.cpg2 = Cout / G;
  c.nk_main = 3 * (int)cdiv(Cout, kBoxK);
  c.nk_short = ws != nullptr ? (int)cdiv(Cin, kBoxK) : 0;
  c.identity = ws == nullptr;
  return launch_conv<E, true>(bm, bn, m2, c, B, s);
}

}  // namespace

// Bytes of the scratch buffer the wrapper allocates for one call.
extern "C" long long ptts_resnet_scratch_bytes(int B, int T, int Cin, int Cout,
                                               int G, int dtype, int bm) {
  (void)G;
  return layout(B, T, Cin, Cout, dtype, bm).bytes;
}

// x [B,T,Cin], temb [B,Cout] and out [B,T,Cout] in `dtype` (0 f32, 1 bf16).
// bf16: w1 [3,Cout,Cin], w2 [3,Cout,Cout] and ws [Cout,Cin] (or null, Cin ==
// Cout) in bf16; f32: the same as their TF32 planes (hi, lo), [2,3,Cout,Cin],
// [2,3,Cout,Cout], [2,Cout,Cin] (null exactly where Cin == Cout).  Norms
// and biases f32; `scratch` ptts_resnet_scratch_bytes bytes.  All
// contiguous on one device, 16-byte aligned.  (bm, bn) is the products'
// tile shape (tile_ok).  Launches on `stream`; returns the first error.
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
      (ws == nullptr && Cin != Cout) || (dtype == 0 && ws != nullptr && Cin == Cout) ||
      Cin % 8 != 0 || Cout % 8 != 0 || !tile_ok(bm, bn, dtype))
    return cudaErrorInvalidValue;
  for (const void* p : {x, w1, w2, ws, (const void*)scratch, (const void*)out})
    if (reinterpret_cast<unsigned long long>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(B, T, Cin, Cout, dtype, bm);
  char* sc = static_cast<char*>(scratch);
  if (dtype == 0)
    return run<float>(static_cast<const float*>(x), static_cast<const float*>(temb), g1w,
                      g1b, static_cast<const float*>(w1), b1, g2w, g2b,
                      static_cast<const float*>(w2), b2, static_cast<const float*>(ws), bs,
                      sc, l, static_cast<float*>(out), B, T, Cin, Cout, G, eps, bm, bn, s);
  if (dtype == 1)
    return run<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(temb), g1w, g1b,
                     static_cast<const bf16*>(w1), b1, g2w, g2b,
                     static_cast<const bf16*>(w2), b2, static_cast<const bf16*>(ws), bs,
                     sc, l, static_cast<bf16*>(out), B, T, Cin, Cout, G, eps, bm, bn, s);
  return cudaErrorInvalidValue;
}

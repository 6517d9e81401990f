// Fused UNet ResnetBlock1D for Hopper (sm_90a), inference only.
//
// Replaces the TPU kernel prompt_tts_tpu/ops/pallas/resnet.py:
// fused_resnet_block (_resnet_kernel).  Same contract: for x [B,T,Cin]
// (bf16 or f32, channels-last)
//   h   = conv3(silu(GN1(x))) + b1 + temb_proj[b]       (rounded to x's type)
//   out = conv3(silu(GN2(h))) + b2 + shortcut(x)        (1x1 conv or identity)
// GroupNorm statistics in f32 (f64 where tiles are combined), "same" k3
// convolutions with zero edges applied to silu(GN(.)), silu(GN(.)) rounded
// to the input type before each product, f32 accumulation.
//
// Design.  The TPU kernel held a whole [T, C] panel per batch element in
// VMEM; at T = 900, Cin = 768 a bf16 panel is 1.4 MB, far beyond an SM's
// 227 KB, and GroupNorm needs statistics over all of T before any row can be
// normalised.  So the block runs as three launches over T-tiles:
//   1. stats: one CTA per (group, batch row) sums x - K over (T, C/G), K a
//      per-group shift (x[b, 0, first channel of the group]) that keeps
//      E[x^2] - E[x]^2 from cancelling; writes mean and rstd.
//   2. conv1: a 64-row x 64-channel implicit GEMM over K = 3 * Cin.  The
//      prologue applies GN1 + SiLU to each loaded x tile and its +-1-row
//      halo (rows outside [0, T) are zero after the activation, as in the
//      reference's zero padding); the epilogue adds b1 and temb_proj[b],
//      rounds h, writes it, and writes per-(T-tile, channel-tile, group)
//      partial sums of h - K2 for GN2 (no atomics: deterministic).
//   3. conv2: the same GEMM with GN2 + SiLU in the prologue; it first
//      reduces conv1's partials (in f64) to GN2's mean and rstd.  A 1x1
//      shortcut is one more K-loop over the raw x tile in the same CTA; an
//      identity shortcut adds x in the epilogue.
// Products: bf16 tiles go through the tensor cores with nvcuda::wmma
// 16x16x16 bf16 fragments and f32 accumulators (4 warps, 32x32 each); f32
// tiles use f32 FMAs on the CUDA cores (8x4 micro-tiles a thread), so the f32
// path keeps the model's 5e-4 contract.  Channels-last in and out, no
// transposes; weights come packed as [3, Cin, Cout] (and [Cin, Cout] for the
// shortcut) by the wrapper, once.  Tiles move in 16-byte vectors staged
// through registers, the next K step's loads issued before this step's
// products.
//
// What bounds it.  At the UNet's shapes a block is a few GFLOP against a
// few MB of activations, so the tensor-core rate bounds it for bf16; this
// version has no wgmma, no TMA and one shared-memory stage, so it runs well
// below that bound (PERF.md has the times).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C interface,
// loaded with ctypes by prompt_tts_tpu_torch/ops/cuda/resnet.py).

#include <cuda_bf16.h>
#include <initializer_list>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kBM = 64;       // rows (time steps) per tile
constexpr int kBN = 64;       // output channels per tile
constexpr int kBK = 32;       // input channels per K step
constexpr int kThreads = 128;
constexpr int kMaxGroups = 128;
constexpr int kStatsThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

template <typename T> struct Tile {
  static constexpr int kPad = sizeof(T) == 2 ? 16 : 4;
  static constexpr int LDA = kBK + kPad;   // A tile row stride (elements)
  static constexpr int LDB = kBN + kPad;   // W tile row stride (elements)
  static constexpr int LDC = kBN + 4;      // f32 output tile row stride
  static constexpr int kA = ((kBM + 2) * LDA * (int)sizeof(T) + 127) / 128 * 128;
  static constexpr int kW = (3 * kBK * LDB * (int)sizeof(T) + 127) / 128 * 128;
  static constexpr int kC = kBM * LDC * 4;
  static constexpr int kMain = (kA + kW) > kC ? (kA + kW) : kC;
};

struct ConvArgs {
  const void* in;        // [B, T, Cmain]: x (conv1) or h (conv2)
  const void* x;         // [B, T, Cin]: the block input (shortcut)
  const void* w;         // [3, Cmain, Cout]
  const void* ws;        // [Cin, Cout] or null (identity shortcut, conv2)
  const float* bias;     // [Cout] (b1 or b2)
  const float* bs;       // [Cout] shortcut bias or null
  const float* temb;     // [B, Cout] f32
  const float* b1;       // [Cout]: with temb, GN2's shift K2
  const float* gamma;    // [Cmain] the prologue's GroupNorm
  const float* beta;
  const float* stats1;   // [B, G, 2] GN1 mean, rstd (conv1)
  float* part;           // [B, nT, nN, G, 2] GN2 partials (written by conv1)
  void* out;             // [B, T, Cout]
  int B, T, Cin, Cmain, Cout, G;
  float eps;
};

// 1. GroupNorm statistics of x: mean and rstd per (b, g).
template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ stats, int T_,
                int C, int G, float eps) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int cpg = C / G;
  const int rows = kStatsThreads / cpg;   // rows a pass covers
  const int tid = threadIdx.x;
  const T* xb = x + (long long)b * T_ * C + g * cpg;
  const float K = to_f(xb[0]);
  float s1 = 0.f, s2 = 0.f;
  if (tid < rows * cpg) {
    const int c = tid % cpg;
    for (int t = tid / cpg; t < T_; t += rows) {
      const float v = to_f(xb[(long long)t * C + c]) - K;
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

// 2./3. The k3 convolution as an implicit GEMM over one 64 x 64 output tile.
template <typename T, bool kConv2>
__global__ void __launch_bounds__(kThreads)
conv_kernel(ConvArgs a) {
  using L = Tile<T>;
  __shared__ __align__(128) unsigned char smem[L::kMain];
  __shared__ float mean_s[kMaxGroups], rstd_s[kMaxGroups];
  __shared__ float colsum[2][2][kBN];
  T* As = reinterpret_cast<T*>(smem);
  T* Ws = reinterpret_cast<T*>(smem + L::kA);
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
      const float K = a.b1[c0] + a.temb[b * Cm + c0];
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

  // accumulators
  using namespace nvcuda;
  const int warp = tid >> 5;
  const int wr = warp >> 1, wc = warp & 1;        // bf16: 32x32 per warp
  const int tx = tid & 15, ty = tid >> 4;         // f32: 8 rows x 4 cols
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  float facc[8][4];
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) facc[i][j] = 0.f;
  }

  // one K step: A rows [row_off, row_off + 64) against W slot `slot`
  auto kstep = [&](int row_off, int slot) {
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              fa[i], reinterpret_cast<const __nv_bfloat16*>(As) +
                         (wr * 32 + i * 16 + row_off) * L::LDA + kk, L::LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(
              fb[j], reinterpret_cast<const __nv_bfloat16*>(Ws) +
                         (slot * kBK + kk) * L::LDB + wc * 32 + j * 16, L::LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    } else {
      for (int kc = 0; kc < kBK; ++kc) {
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = to_f(As[(ty * 8 + i + row_off) * L::LDA + kc]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = to_f(Ws[(slot * kBK + kc) * L::LDB + tx * 4 + j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(av[i], bv[j], facc[i][j]);
      }
    }
  };

  // Operand tiles move in 16-byte vectors (VEC elements; the wrapper
  // checks that every channel count is a multiple of 8 and every pointer
  // 16-byte aligned), staged through registers: the next K step's global
  // loads are issued before this step's products, so their latency hides
  // behind the tensor cores.
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int VPR = kBK / VEC;                      // vectors per A row
  constexpr int RPP = kThreads / VPR;                 // A rows per pass
  constexpr int kAPass = (kBM + 2 + RPP - 1) / RPP;
  constexpr int NVPR = kBN / VEC;                     // vectors per W row
  constexpr int kWVec = 3 * kBK * NVPR / kThreads;    // W vectors a thread
  const int kc = (tid % VPR) * VEC;                   // this thread's channels
  uint4 ra[kAPass], rw[kWVec];
  unsigned amask = 0;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // A rows r of the tile hold time t = t0 - 1 + r (halo at r = 0, 65)
  auto load_a = [&](const T* src, int C, int ci0) {
    amask = 0;
#pragma unroll
    for (int i = 0; i < kAPass; ++i) {
      const int r = tid / VPR + i * RPP, t = t0 - 1 + r, c = ci0 + kc;
      const bool ok = r < kBM + 2 && t >= 0 && t < T_ && c < C;
      ra[i] = ok ? __ldg(reinterpret_cast<const uint4*>(src + (long long)t * C + c))
                 : zero4;
      amask |= (unsigned)ok << i;
    }
  };
  // GN + SiLU (or, raw, nothing) on the staged rows, rounded to T
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
      uint4 v = ra[i];
      if (!raw) {
        T* e = reinterpret_cast<T*>(&v);
        const bool ok = (amask >> i) & 1u;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          e[j] = from_f<T>(ok ? silu(to_f(e[j]) * sc[j] + sh[j]) : 0.f);
      }
      *reinterpret_cast<uint4*>(As + r * L::LDA + kc) = v;
    }
  };
  // W vectors: `slots` taps of [kBK x kBN] from a [taps, C, Cout] array
  auto load_w = [&](const T* src, int C, int ci0, int slots) {
#pragma unroll
    for (int i = 0; i < kWVec; ++i) {
      const int v = tid + i * kThreads;
      const int tap = v / (kBK * NVPR), rem = v % (kBK * NVPR);
      const int c = ci0 + rem / NVPR, co = co0 + (rem % NVPR) * VEC;
      rw[i] = (tap < slots && c < C && co < Cout)
                  ? __ldg(reinterpret_cast<const uint4*>(
                        src + ((long long)tap * C + c) * Cout + co))
                  : zero4;
    }
  };
  auto store_w = [&]() {
#pragma unroll
    for (int i = 0; i < kWVec; ++i) {
      const int v = tid + i * kThreads;
      const int tap = v / (kBK * NVPR), rem = v % (kBK * NVPR);
      *reinterpret_cast<uint4*>(Ws + (tap * kBK + rem / NVPR) * L::LDB +
                                (rem % NVPR) * VEC) = rw[i];
    }
  };

  // main K loop: 3 taps over the normalised, activated input
  const T* in = static_cast<const T*>(a.in) + (long long)b * T_ * Cm;
  const T* w = static_cast<const T*>(a.w);
  load_a(in, Cm, 0);
  load_w(w, Cm, 0, 3);
  for (int ci0 = 0; ci0 < Cm; ci0 += kBK) {
    store_a(ci0, false);
    store_w();
    __syncthreads();
    if (ci0 + kBK < Cm) {
      load_a(in, Cm, ci0 + kBK);
      load_w(w, Cm, ci0 + kBK, 3);
    }
    kstep(0, 0);
    kstep(1, 1);
    kstep(2, 2);
    __syncthreads();
  }

  // conv2's 1x1 shortcut: one more K loop over the raw x tile, whose rows
  // 1..64 hold t0..t0+63 (the halo rows are loaded but not used)
  if (kConv2 && a.ws != nullptr) {
    const T* xb = static_cast<const T*>(a.x) + (long long)b * T_ * a.Cin;
    const T* ws = static_cast<const T*>(a.ws);
    load_a(xb, a.Cin, 0);
    load_w(ws, a.Cin, 0, 1);
    for (int ci0 = 0; ci0 < a.Cin; ci0 += kBK) {
      store_a(ci0, true);
      store_w();
      __syncthreads();
      if (ci0 + kBK < a.Cin) {
        load_a(xb, a.Cin, ci0 + kBK);
        load_w(ws, a.Cin, ci0 + kBK, 1);
      }
      kstep(1, 0);
      __syncthreads();
    }
  }

  // accumulators -> the f32 tile Cs (aliases As/Ws: the loops above ended
  // with a barrier)
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * L::LDC + wc * 32 + j * 16,
                                acc[i][j], L::LDC, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(ty * 8 + i) * L::LDC + tx * 4 + j] = facc[i][j];
  }
  __syncthreads();

  // epilogue: thread -> one column, every other row
  const int n = tid % kBN, half = tid / kBN;
  const int co = co0 + n;
  T* out = static_cast<T*>(a.out) + (long long)b * T_ * Cout;
  float s1 = 0.f, s2 = 0.f;
  if (co < Cout) {
    float add = a.bias[co];
    float K2 = 0.f;
    if (!kConv2) {
      add += a.temb[b * Cout + co];
      const int c0 = (co / (Cout / G)) * (Cout / G);
      K2 = a.b1[c0] + a.temb[b * Cout + c0];
    } else if (a.bs != nullptr) {
      add += a.bs[co];
    }
    const T* xb = static_cast<const T*>(a.x) + (long long)b * T_ * a.Cin;
    for (int r = half; r < kBM; r += 2) {
      const int t = t0 + r;
      if (t >= T_) break;
      float v = Cs[r * L::LDC + n] + add;
      if (kConv2 && a.ws == nullptr) v += to_f(xb[(long long)t * a.Cin + co]);
      const T o = from_f<T>(v);
      out[(long long)t * Cout + co] = o;
      if (!kConv2) {   // GN2 statistics of the rounded h
        const float d = to_f(o) - K2;
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

template <typename T>
int run(const void* x, const float* temb, const float* g1w, const float* g1b,
        const void* w1, const float* b1, const float* g2w, const float* g2b,
        const void* w2, const float* b2, const void* ws, const float* bs,
        void* h, float* stats1, float* part, void* out, int B, int T_, int Cin,
        int Cout, int G, float eps, cudaStream_t s) {
  gn_stats_kernel<T><<<dim3(G, B), kStatsThreads, 0, s>>>(
      static_cast<const T*>(x), stats1, T_, Cin, G, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((T_ + kBM - 1) / kBM, (Cout + kBN - 1) / kBN, B);
  ConvArgs a{};
  a.x = x; a.temb = temb; a.b1 = b1; a.part = part; a.stats1 = stats1;
  a.B = B; a.T = T_; a.Cin = Cin; a.Cout = Cout; a.G = G; a.eps = eps;
  // conv1: x -> h
  a.in = x; a.Cmain = Cin; a.w = w1; a.bias = b1; a.gamma = g1w; a.beta = g1b;
  a.ws = nullptr; a.bs = nullptr; a.out = h;
  conv_kernel<T, false><<<grid, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // conv2: h -> out (+ shortcut of x)
  a.in = h; a.Cmain = Cout; a.w = w2; a.bias = b2; a.gamma = g2w; a.beta = g2b;
  a.ws = ws; a.bs = bs; a.out = out;
  conv_kernel<T, true><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Floats of the GN2 partials buffer the wrapper allocates.
extern "C" long long ptts_resnet_partials(int B, int T, int Cout, int G) {
  return 2LL * B * ((T + kBM - 1) / kBM) * ((Cout + kBN - 1) / kBN) * G;
}

// x [B,T,Cin], h scratch and out [B,T,Cout] in `dtype` (0 f32, 1 bf16);
// w1 [3,Cin,Cout], w2 [3,Cout,Cout], ws [Cin,Cout] or null (Cin == Cout) in
// `dtype`; temb [B,Cout], norms, biases, stats1 [B,G,2] and part
// (ptts_resnet_partials floats) f32.  All contiguous on one device.  Three
// launches on `stream`; returns the first launch error.
extern "C" int ptts_resnet_block(const void* x, const float* temb,
                                 const float* g1w, const float* g1b,
                                 const void* w1, const float* b1,
                                 const float* g2w, const float* g2b,
                                 const void* w2, const float* b2,
                                 const void* ws, const float* bs, void* h,
                                 float* stats1, float* part, void* out, int B,
                                 int T, int Cin, int Cout, int G, float eps,
                                 int dtype, void* stream) {
  if (B <= 0 || T <= 0 || Cin <= 0 || Cout <= 0 || G <= 0 || G > kMaxGroups ||
      Cin % G != 0 || Cout % G != 0 || Cin / G > kStatsThreads ||
      (ws == nullptr && Cin != Cout) || Cin % 8 != 0 || Cout % 8 != 0)
    return cudaErrorInvalidValue;
  for (const void* p : {x, w1, w2, ws, (const void*)h, (const void*)out})
    if (reinterpret_cast<unsigned long long>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, temb, g1w, g1b, w1, b1, g2w, g2b, w2, b2, ws, bs, h,
                      stats1, part, out, B, T, Cin, Cout, G, eps, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, temb, g1w, g1b, w1, b1, g2w, g2b, w2, b2, ws,
                              bs, h, stats1, part, out, B, T, Cin, Cout, G,
                              eps, s);
  return cudaErrorInvalidValue;
}

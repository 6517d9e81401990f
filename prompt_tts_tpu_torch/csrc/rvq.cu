// Residual vector quantizer, encode side, for Hopper (sm_90a): for each of
// n_q codebooks in turn, score = -(|r|^2 - 2 r.e + |e|^2) over its K codes,
// take the argmax (the lowest index among equal scores), write it, and peel
// the chosen code off the residual: r -= e[idx], in f32.
//
// Replaces the TPU kernel prompt_tts_tpu/ops/pallas/rvq.py:rvq_encode_fused
// (_rvq_kernel).  Same contract: embeddings [N, D] f32 (N = B*T vectors),
// codebooks [n_q, K, D] f32 -> indices [B, n_q, T] int32, all n_q layers in
// one launch, the [N, K] score matrix never written to device memory and the
// residual kept on chip between layers.
//
// Numerics: r.e in 3 x TF32 on the tensor cores.  Both operands are split,
// hi = rna_tf32(x), lo = rna_tf32(x - hi), rounded explicitly, and
// r.e = (hi_r.lo_e + lo_r.hi_e) + hi_r.hi_e is accumulated in f32 in that
// order (wgmma m64n64k8 .tf32, 16 K steps a product).  Dropping lo.lo and
// lo's own rounding leaves ~2^-22 of |r||e| a term: about 1e-7 of
// (|r| + |e|)^2 in the score, as plain f32 (one TF32 product alone is
// ~7e-5, beyond the index contract's NEAR_TIE of 1e-5; see
// ops/cuda/rvq.py).  Then distance = (|r|^2 - 2 r.e) + |e|^2, rounded step
// by step as the plain version rounds it; each thread visits its codes in
// increasing order with a strict '<', and every reduction after that (the
// 4 lanes that share a row, the CTAs of a cluster in rank order) takes the
// lower index among equal distances: the first index wins, as with
// jnp.argmax and torch argmax.  The residual is peeled in f32 from the
// original codebook, the same single subtraction as the plain version, so
// up to the first layer where the two choose differently both hold the same
// residual bits.  Every sum is taken in a fixed order and no atomic touches
// data: two runs give the same bits.
//
// Two launches a call.
//   1. rvq_prep_kernel, one warp a code: |e|^2 (a fixed shuffle tree) and
//      the codebooks' split, cb_hi and cb_lo [n_q, K, D] (f32 bit patterns
//      with the low 13 bits zero), into the caller's scratch, the dims
//      permuted (dim_at) so that each thread's share of a row is 32
//      neighbouring dims.
//   2. rvq_encode_kernel: one CTA owns BM = 64 NWG vectors (NWG consumer
//      warpgroups, 64 rows each) and scans the codes [rank K/c,
//      (rank+1) K/c) of every layer, c the cluster size (1 without one).
//      - Producer (a warpgroup; one thread issues): TMA loads of 64-code
//        tiles, hi and lo (4 boxes of 64 codes x 32 floats each, 128-byte
//        swizzle) and the tile's |e|^2 (a 256-byte bulk copy), into a
//        2-stage mbarrier ring, running straight on from layer q into
//        q + 1: code tiles do not depend on the residual.  It gives its
//        registers to the consumers (setmaxnreg): 2 x 232 + 40 a thread
//        fits an SM sub-partition's 3 warps.
//      - Consumers: each thread holds its rows' residual split as wgmma's
//        register A fragments (rows gid and gid + 8 of its warp's 16, 32
//        of the 128 dims; 16 K steps x 4 x (hi, lo) = 128 registers), the
//        codes come from shared memory (B, K-major, as D is in the
//        codebooks' own layout: no transposed copy).  48 wgmma a tile,
//        then the tile's distances from the accumulator registers; two
//        warpgroups take turns to issue (named barriers), so one scores
//        while the other's products run.  At a layer's end: the argmin
//        over the 4 lanes of a row; with a cluster, each CTA's per-row
//        (distance, index) into a double-buffered slot of its shared
//        memory, barrier.cluster, and every CTA reads all c slots of its
//        rows through distributed shared memory (mapa + ld.shared::cluster)
//        and combines them in rank order, so every CTA peels the same
//        code; then the peel (the chosen rows' 16-byte loads, one round
//        trip to L2), the new split and |r|^2.  The f32 residual itself
//        sits in shared memory, thread-private.
//      The producer takes part in the cluster barriers (it arrives when it
//      has issued a layer's last tile and waits one layer later), so no
//      thread of the cluster is missing from them and none blocks the
//      ring.  The caller's rule (ops/cuda/rvq.py: rvq_plan) picks BM and c:
//      c > 1 splits the code axis when there are too few vector tiles to
//      fill the SMs (the prompt encode's [4, 225] is 15 tiles of 64: c = 8,
//      120 CTAs).
//
// Budget.  Shared memory, NWG = 2 (BM = 128): the ring 2 x 64 KB (hi + lo
// of 64 codes x 128 dims), |e|^2 2 x 256 B, the exchange 2 x 128 x 8 B,
// barriers, the f32 residual 256 threads x 68 x 4 B = 68 KB, 1 KB to align
// the ring: 204,320 B of the 232,448 a block may use (NWG = 1: 168,480 B).
// A third stage does not fit beside the residual.  L2 traffic: each CTA
// reads n_q (K / c) 128 x 8 B of hi + lo, 8 MB at n_q = 8, K = 1024, c = 1
// (1 MB at c = 8), plus 512 B a row a layer for the peel: at [32, 900] 225
// CTAs read 1.8 GB (two warpgroups share every tile; BM = 64 would read
// 3.6 GB).  Registers: the A fragments 128, the accumulator 32.
//
// What bounds it.  3 x 2 N n_q K D operations (3 x 60.4 GFLOP at B = 32,
// T = 900, n_q = 8, K = 1024) at the card's 495 TFLOP/s dense TF32: 0.366
// ms, against ~20 MB of inputs and outputs (6 us): bound by operations
// (0.901 ms in f32 on the CUDA cores, the kernel this replaces).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C interface,
// loaded with ctypes by prompt_tts_tpu_torch/ops/cuda/rvq.py).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "tma_host.cuh"
#include "wgmma.cuh"

namespace {

using namespace ptts;

constexpr int kD = 128;                 // vector and code dim
constexpr int kBN = 64;                 // codes per tile
constexpr int kKSteps = kD / 8;         // K steps of 8 (tf32)
constexpr int kBoxCols = 32;            // floats in a 128-byte swizzled row
constexpr int kBox = kBN * 128;         // one TMA box: 64 codes x 128 B
constexpr int kTile = (kD / kBoxCols) * kBox;   // 64 codes, hi or lo: 32 KB
constexpr int kStage = 2 * kTile;       // hi + lo: 64 KB
constexpr int kStages = 2;
constexpr int kAcc = kBN / 2;           // accumulator registers a thread
// A consumer thread's residual: its 2 rows x 32 dims, a slot of kSlot
// floats (68: 16-byte loads of 8 neighbouring threads hit 32 banks)
constexpr int kSlot = 68;
constexpr int kMaxCluster = 8;

template <int NWG>
struct Layout {
  static constexpr int BM = 64 * NWG;
  // + a producer warpgroup (one thread issues the copies): with two
  // consumer warpgroups, 9 warps would leave 3 on one SM sub-partition and
  // cap a thread at 168 registers; 3 full warpgroups move the producer's
  // registers to the consumers (setmaxnreg)
  static constexpr int kThreads = (NWG + 1) * 128;
  // byte offsets from the 1024-aligned base
  static constexpr int kEs = kStages * kStage;          // [kStages][kBN] f32
  static constexpr int kXch = kEs + kStages * kBN * 4;  // [2][BM] (dist, idx)
  static constexpr int kBars = kXch + 2 * BM * 8;       // full, empty
  static constexpr int kRes = kBars + 2 * kStages * 8;  // [NWG 128][kSlot] f32
  static constexpr int kSmem = 1024 + kRes + NWG * 128 * kSlot * 4;
};

static_assert(Layout<2>::kSmem <= 232448, "shared memory");

struct Args {
  const float* x;      // [N, D]
  const float* cb;     // [n_q, K, D] f32: the peel
  const float* esq;    // [n_q, K] |e|^2
  int* out;            // [B, n_q, T]
  int N, T, n_q, K;
  int cluster;         // CTAs that split each layer's codes
};

// The dims are permuted for the products (r.e does not depend on their
// order): K position p = 8 ks + tig + 4 h of the tensor cores' A fragment
// holds dim 32 tig + 2 ks + h, so that the 32 positions of a thread's A
// fragment (tig = lane % 4) are the 32 neighbouring dims [32 tig, 32 tig +
// 32) of x and of a code row: 16-byte loads for the residual and the peel.
__device__ __forceinline__ int dim_at(int p) {
  return 32 * (p % 4) + 2 * (p / 8) + (p / 4) % 2;
}

// One warp a code: |e|^2 and the split of its 128 values, in product
// order (dim_at).
__global__ void rvq_prep_kernel(const float* __restrict__ cb,
                                float* __restrict__ hi, float* __restrict__ lo,
                                float* __restrict__ esq, int codes) {
  const long long code = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (code >= codes) return;
  const float* row = cb + code * kD;
  uint32_t h[4], l[4];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float e = __ldg(row + dim_at(4 * lane + i));
    split_tf32(e, h[i], l[i]);
    s = fmaf(e, e, s);
  }
  reinterpret_cast<uint4*>(hi + code * kD)[lane] = make_uint4(h[0], h[1], h[2], h[3]);
  reinterpret_cast<uint4*>(lo + code * kD)[lane] = make_uint4(l[0], l[1], l[2], l[3]);
  // a butterfly: every lane ends with the same bits (a + b == b + a)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) esq[code] = s;
}

// The lower distance, the lower index among equal ones.
__device__ __forceinline__ void take_min(float& best, int& bi, float d, int i) {
  if (d < best || (d == best && i < bi)) {
    best = d;
    bi = i;
  }
}

// This thread's residual (rows r0 and r0 + 8, dims [32 tig, 32 tig + 32),
// in its slot `res`: row r0's 32 dims, then row r0 + 8's): kPeel false,
// loaded from x at g0 and g1 (the rows' first dims; null: a row past N,
// zero); kPeel true, the code rows at g0 and g1 peeled off it.  Then split
// into the A fragments (ahi[ks][2 h + row] is dim 2 ks + h of the slice,
// dim_at), with |r|^2 of both rows in xs (summed over the 4 lanes of the
// rows in a fixed order).  All 16 global loads are issued before any
// is used: one round trip to L2.
template <bool kPeel>
__device__ __forceinline__ void update_residual(float* __restrict__ res,
                                                const float* __restrict__ g0,
                                                const float* __restrict__ g1,
                                                uint32_t (&ahi)[kKSteps][4],
                                                uint32_t (&alo)[kKSteps][4],
                                                float (&xs)[2]) {
  float4 v[16];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = g0 != nullptr ? __ldg(reinterpret_cast<const float4*>(g0) + j) : zero;
    v[8 + j] = g1 != nullptr ? __ldg(reinterpret_cast<const float4*>(g1) + j) : zero;
  }
  float4* slot = reinterpret_cast<float4*>(res);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (kPeel) {
      const float4 r = slot[j];
      v[j] = make_float4(__fsub_rn(r.x, v[j].x), __fsub_rn(r.y, v[j].y),
                         __fsub_rn(r.z, v[j].z), __fsub_rn(r.w, v[j].w));
    }
    slot[j] = v[j];
  }
  const float* f = reinterpret_cast<const float*>(v);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a0 = f[2 * ks + h], a1 = f[32 + 2 * ks + h];
      split_tf32(a0, ahi[ks][2 * h], alo[ks][2 * h]);
      split_tf32(a1, ahi[ks][2 * h + 1], alo[ks][2 * h + 1]);
      s0 = fmaf(a0, a0, s0);
      s1 = fmaf(a1, a1, s1);
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  xs[0] = s0;
  xs[1] = s1;
}

// The 48 products of one tile (stage at `hi`, its lo part at `lo`) into
// acc, committed as one group: hi_r.lo_e, then lo_r.hi_e, then hi_r.hi_e,
// the small terms first.
__device__ __forceinline__ void issue_tile(float (&acc)[kAcc],
                                           const uint32_t (&ahi)[kKSteps][4],
                                           const uint32_t (&alo)[kKSteps][4],
                                           uint32_t hi, uint32_t lo) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks)
    wgmma_tf32_rs(acc, ahi[ks], sw128_desc(lo + (ks / 4) * kBox + (ks % 4) * 32), ks > 0);
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks)
    wgmma_tf32_rs(acc, alo[ks], sw128_desc(hi + (ks / 4) * kBox + (ks % 4) * 32), 1);
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks)
    wgmma_tf32_rs(acc, ahi[ks], sw128_desc(hi + (ks / 4) * kBox + (ks % 4) * 32), 1);
  wgmma_commit();
}

// distance = (|r|^2 - 2 r.e) + |e|^2 of the tile's codes k0 + col, col =
// 8 j + 2 tig + e, from acc[4 j + 2 h + e] (row r0 + 8 h); each thread
// visits its codes in increasing order and keeps the first of equal ones.
__device__ __forceinline__ void score_tile(const float (&acc)[kAcc], const float* es,
                                           int k0, int tig, const float (&xs)[2],
                                           float (&best)[2], int (&bi)[2]) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * tig + e;
      const float ev = es[col];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d = __fadd_rn(__fsub_rn(xs[h], __fmul_rn(2.f, acc[4 * j + 2 * h + e])), ev);
        if (d < best[h]) {
          best[h] = d;
          bi[h] = k0 + col;
        }
      }
    }
}

template <int NWG>
__global__ void __launch_bounds__(Layout<NWG>::kThreads, 1)
rvq_encode_kernel(const __grid_constant__ CUtensorMap tm_hi,
                  const __grid_constant__ CUtensorMap tm_lo, const Args a) {
  using L = Layout<NWG>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar_full = base + L::kBars;
  const uint32_t bar_empty = bar_full + kStages * 8;

  const int c = a.cluster;
  const int rank = c > 1 ? (int)cluster_ctarank() : 0;
  const long long m0 = (long long)(blockIdx.x / c) * L::BM;
  const int span = a.K / c;               // codes this CTA scans a layer
  const int kb = rank * span;
  const int ntiles = span / kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NWG * 4);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NWG * 4) {
    // producer: tile `it` counts on across layers, as the consumers count
    if (NWG == 2) setmaxnreg_dec<40>();
    int it = 0;
    for (int q = 0; q < a.n_q; ++q) {
      if (warp == NWG * 4 && lane == 0) {
        if (q == 0) {
          tma_prefetch_map(&tm_hi);
          tma_prefetch_map(&tm_lo);
        }
        for (int t = 0; t < ntiles; ++t, ++it) {
          const int s = it % kStages;
          mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t full = bar_full + 8 * s;
          const uint32_t hi = base + s * kStage, lo = hi + kTile;
          const int row = q * a.K + kb + t * kBN;
          mbar_expect_tx(full, kStage + kBN * 4);
#pragma unroll
          for (int j = 0; j < kD / kBoxCols; ++j) {
            tma_load_2d(hi + j * kBox, &tm_hi, j * kBoxCols, row, full);
            tma_load_2d(lo + j * kBox, &tm_lo, j * kBoxCols, row, full);
          }
          bulk_load(base + L::kEs + s * kBN * 4, a.esq + row, kBN * 4, full);
        }
      }
      __syncwarp();
      if (c > 1) {   // this layer's loads are issued: arrive; wait a layer on
        if (q > 0) cluster_wait();
        cluster_arrive();
      }
    }
    if (c > 1) {     // the last layer's exchange, then the final barrier
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  // consumers: warpgroup wg, warp w4 within it; this thread's rows are
  // r0 = 64 wg + 16 w4 + gid and r0 + 8
  if (NWG == 2) setmaxnreg_inc<232>();
  const int wg = warp / 4, w4 = warp % 4, gid = lane / 4, tig = lane % 4;
  const int r0 = wg * 64 + 16 * w4 + gid;
  const long long n0 = m0 + r0, n1 = n0 + 8;
  float* res = reinterpret_cast<float*>(gbase + L::kRes) + threadIdx.x * kSlot;
  const float* es_s = reinterpret_cast<const float*>(gbase + L::kEs);
  uint2* xch = reinterpret_cast<uint2*>(gbase + L::kXch);

  // the residual: this thread's rows of x (rows past N are zero)
  uint32_t ahi[kKSteps][4], alo[kKSteps][4];
  float xs[2];
  update_residual<false>(res, n0 < a.N ? a.x + n0 * kD + 32 * tig : nullptr,
                         n1 < a.N ? a.x + n1 * kD + 32 * tig : nullptr, ahi, alo, xs);

  // with two warpgroups, they take turns to issue a tile's products
  // (named barriers 1 and 2: "warpgroup w may issue"), so one scores its
  // tile while the other's products run
  const int turn = 1 + wg, other = 2 - wg;
  if (NWG == 2 && wg == 1) bar_arrive(other, 256);
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  int it = 0;
  for (int q = 0; q < a.n_q; ++q) {
    float best[2] = {CUDART_INF_F, CUDART_INF_F};
    int bi[2] = {kb, kb};
    for (int t = 0; t < ntiles; ++t, ++it) {
      const int s = it % kStages;
      mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
      if (NWG == 2) bar_sync(turn, 256);
      issue_tile(acc, ahi, alo, base + s * kStage, base + s * kStage + kTile);
      if (NWG == 2) bar_arrive(other, 256);
      wgmma_wait<0>();
      fence_regs(acc);
      score_tile(acc, es_s + s * kBN, kb + t * kBN, tig, xs, best, bi);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }

#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;   // dead until the next layer

    // the 4 lanes of a row (every lane ends with the same pair)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        take_min(best[h], bi[h], __shfl_xor_sync(0xffffffffu, best[h], o),
                 __shfl_xor_sync(0xffffffffu, bi[h], o));

    if (c > 1) {
      // every CTA of the cluster combines all c pairs in rank order
      uint2* slot = xch + (q & 1) * L::BM;
      if (tig == 0) {
        slot[r0] = make_uint2(__float_as_uint(best[0]), (uint32_t)bi[0]);
        slot[r0 + 8] = make_uint2(__float_as_uint(best[1]), (uint32_t)bi[1]);
      }
      cluster_arrive();
      cluster_wait();
      // all 2 c loads in flight at once, then the combine
      uint2 v[2][kMaxCluster];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t addr = smem_u32(slot + r0 + 8 * h);
#pragma unroll
        for (int p = 0; p < kMaxCluster; ++p)
          if (p < c) v[h][p] = ld_cluster_u32x2(mapa(addr, p));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        best[h] = __uint_as_float(v[h][0].x);
        bi[h] = (int)v[h][0].y;
#pragma unroll
        for (int p = 1; p < kMaxCluster; ++p)
          if (p < c) take_min(best[h], bi[h], __uint_as_float(v[h][p].x), (int)v[h][p].y);
      }
    }
    if (rank == 0 && tig == 0) {
      if (n0 < a.N) a.out[((n0 / a.T) * a.n_q + q) * a.T + n0 % a.T] = bi[0];
      if (n1 < a.N) a.out[((n1 / a.T) * a.n_q + q) * a.T + n1 % a.T] = bi[1];
    }
    if (q + 1 < a.n_q) {
      const float* cq = a.cb + (long long)q * a.K * kD;
      update_residual<true>(res, cq + (long long)bi[0] * kD + 32 * tig,
                            cq + (long long)bi[1] * kD + 32 * tig, ahi, alo, xs);
    }
  }
  if (NWG == 2 && wg == 0) bar_sync(turn, 256);   // warpgroup 1's last turn
  if (c > 1) {   // no CTA leaves while a peer may still read its slots
    cluster_arrive();
    cluster_wait();
  }
}

// A tensor map over the [rows, 128] f32 array p: boxes of 64 rows x 32
// floats (128 bytes), 128-byte swizzle.
bool encode(CUtensorMap* m, const float* p, long long rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)kD, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kD * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kBoxCols, (cuuint32_t)kBN};
  const cuuint32_t elem[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

long long ctas(int N, int bm, int cluster) {
  return ((long long)N + bm - 1) / bm * cluster;
}

template <int NWG>
cudaError_t launch(const CUtensorMap& hi, const CUtensorMap& lo, const Args& a,
                   cudaStream_t s) {
  using L = Layout<NWG>;
  static unsigned long long configured = 0;
  auto kern = rvq_encode_kernel<NWG>;
  cudaError_t err = opt_in(kern, L::kSmem, &configured);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.cluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas(a.N, L::BM, a.cluster));
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = s;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, hi, lo, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The scratch buffer's regions, in floats: |e|^2 [n_q, K], cb_hi and
// cb_lo [n_q, K, D].
struct Scratch {
  long long esq, hi, lo, floats;
};

Scratch scratch_layout(int n_q, int K) {
  Scratch l{};
  const long long codes = (long long)n_q * K;
  l.esq = 0;
  l.hi = (codes + 3) / 4 * 4;
  l.lo = l.hi + codes * kD;
  l.floats = l.lo + codes * kD;
  return l;
}

}  // namespace

// Floats of the scratch buffer the wrapper allocates for one call.
extern "C" long long ptts_rvq_scratch_floats(int N, int n_q, int K, int bm, int cluster) {
  return scratch_layout(n_q, K).floats;
}

// x [N, D], codebooks [n_q, K, D], scratch ptts_rvq_scratch_floats, out
// [B, n_q, T] with N = B*T: float32 (out int32), contiguous, one device,
// codebooks and scratch 16-byte aligned; D must be 128.  bm (64 or 128
// vectors a CTA) and cluster (1, 2, 4 or 8 CTAs splitting the codes, K a
// multiple of 64 cluster) from ops/cuda/rvq.py:rvq_plan.  Launches the prep
// kernel, then the search, on `stream`; returns the first launch error, or
// cudaSuccess.
extern "C" int ptts_rvq_encode(const float* x, const float* codebooks, float* scratch,
                               int* out, int N, int T, int n_q, int K, int D, int bm,
                               int cluster, void* stream) {
  if (N <= 0 || T <= 0 || N % T != 0 || n_q <= 0 || K <= 0 || D != kD ||
      (bm != 64 && bm != 128) ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      K % (kBN * cluster) != 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<unsigned long long>(scratch) % 16 != 0 ||
      reinterpret_cast<unsigned long long>(codebooks) % 16 != 0 ||
      reinterpret_cast<unsigned long long>(x) % 16 != 0)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long codes = (long long)n_q * K;
  const Scratch l = scratch_layout(n_q, K);
  float* hi = scratch + l.hi;
  float* lo = scratch + l.lo;
  float* esq = scratch + l.esq;
  rvq_prep_kernel<<<(unsigned)((codes * 32 + 255) / 256), 256, 0, s>>>(codebooks, hi, lo,
                                                                      esq, (int)codes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap m_hi, m_lo;
  if (!encode(&m_hi, hi, codes) || !encode(&m_lo, lo, codes))
    return cudaErrorNotSupported;
  const Args a{x, codebooks, esq, out, N, T, n_q, K, cluster};
  return bm == 64 ? launch<1>(m_hi, m_lo, a, s) : launch<2>(m_hi, m_lo, a, s);
}

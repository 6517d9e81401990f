// The step of an LSTM recurrence shared by the two schedules (lstm.cu, one
// launch a timestep; lstm_t.cu, one persistent launch): gate order i, f, g,
// o, f32 on the CUDA cores, expf/tanhf.
//
// A CTA owns kUnits hidden units, i.e. kRows = 4 kUnits gate rows, kept in
// shared memory as Ws[r][H] with r = g * kUnits + u (gate g of unit j0 + u).
// A step stages up to kChunk batch rows of h_{t-1} in shared memory with
// 16-byte cp.async copies, all in flight at once (one L2 round trip), then
// computes the chunk's [kRows x rows] gate sums over H from shared memory
// only: the lanes of a warp share one register tile of gate x batch rows
// (4 x 4 at chunks of up to 8 rows, 8 x 8 above: 16 float4 reads of shared
// memory for 256 FMAs), each over its own slice of H, and the lanes' sums
// are reduced in a fixed order (tile_product).  Then one thread per (unit,
// batch row) adds x_proj, applies the gates and updates c and h.

#pragma once

#include "wgmma.cuh"

namespace lstm {

using ptts::cp_async16;
using ptts::smem_u32;

constexpr int kThreads = 256;
constexpr int kUnits = 4;              // hidden units a CTA owns
constexpr int kRows = 4 * kUnits;      // its gate rows
constexpr int kChunk = 32;             // batch rows of h staged at once

// Batch rows staged a chunk: up to 8 rounded up to the 4-row register
// tile, more rounded up to the 8-row tile, at most kChunk.
__host__ __device__ inline int chunk_rows(int B) {
  const int b = B <= 8 ? (B + 3) / 4 * 4 : (B + 7) / 8 * 8;
  return b < kChunk ? b : kChunk;
}

// A thread's register tile: 4 gate rows x 4 batch rows at chunks of up to
// 8 rows (4 or 8 tiles), 8 x 8 above (4, 6 or 8 tiles).
__host__ __device__ inline int tile_rows(int bcp) { return bcp <= 8 ? 4 : 8; }

__host__ __device__ inline int tiles(int bcp) {
  const int t = tile_rows(bcp);
  return (kRows / t) * (bcp / t);
}

// Lanes (slices of H) a tile takes: a warp, or two where there are only 4
// tiles; their sums are added in order by the gate step.
__host__ __device__ inline int partial_sets(int bcp) { return tiles(bcp) <= 4 ? 2 : 1; }

// Shared memory of a CTA, in floats, at batch B and hidden size H: W, the
// staged h chunk, the chunk's x_proj, the partial gate sums, then the cell
// state of `state_rows` batch rows.
struct Layout {
  int bcp;
  size_t hs, xs, gp, cs, total;
};

__host__ __device__ inline Layout layout(int B, int H, int state_rows) {
  Layout L;
  L.bcp = chunk_rows(B);
  L.hs = (size_t)kRows * H;
  L.xs = L.hs + (size_t)L.bcp * H;
  L.gp = L.xs + (size_t)kRows * L.bcp;
  L.cs = L.gp + (size_t)partial_sets(L.bcp) * kRows * L.bcp;
  L.total = L.cs + (size_t)kUnits * state_rows;
  return L;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy n contiguous float4 from global to shared, all in flight at once.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n; e += kThreads)
    cp_async16(smem_u32(dst + 4 * e), src + 4 * e, true);
}

// The chunk's x_proj columns: rows b < nb of x [., 4H], gate g's 4 units
// (16 bytes at g*H + j0) to xs[b][g*kUnits .. +3].
__device__ __forceinline__ void stage_x(float* xs, const float* x, int nb,
                                        int H, int j0) {
  for (int e = threadIdx.x; e < 4 * nb; e += kThreads) {
    const int b = e / 4, g = e % 4;
    cp_async16(smem_u32(xs + b * kRows + g * kUnits),
               x + (size_t)b * 4 * H + g * H + j0, true);
  }
}

// One level of the transposing butterfly at lane distance O, over the n
// values a lane holds (then the next level, at O / 2).
template <int n, int O>
__device__ __forceinline__ void fold(float* v, int lane) {
  if constexpr (n >= 2) {
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[i + n / 2];
      const float keep = up ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
  }
  if constexpr (O > 1) fold<(n >= 2 ? n / 2 : 1), O / 2>(v, lane);
}

// The [TR x TB] tile of gate sums of the thread's warp: the lanes take the
// float4 columns q = lane (+ 32 for the tile's second warp), q + S, ...
// of H, so a quarter-warp reads 128 contiguous bytes of one row (no bank
// conflicts, no padding).  The 32 lanes' sums are then reduced by a
// transposing butterfly: at each level a lane keeps half of its values and
// adds its partner's sums of that half (TR*TB/2 + TR*TB/4 + ... shuffles,
// not 5 TR TB), so that lane l ends with values 2l, 2l + 1 (64 values) or
// l / 2 (16).  A fixed order: two runs give the same bits.
template <int TR, int TB>
__device__ __forceinline__ void tile_product(const float* Ws, const float* hs,
                                             float* gp, int H, int bcp) {
  constexpr int N = TR * TB;
  const int shift = partial_sets(bcp) == 2 ? 6 : 5;   // S = 64 or 32 lanes
  const int S = 1 << shift;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tile = tid >> shift, s = tid & (S - 1);
  const int rg = tile % (kRows / TR), bt = tile / (kRows / TR);
  const int H4 = H / 4;
  const float4* W4 = reinterpret_cast<const float4*>(Ws) + (size_t)rg * TR * H4;
  const float4* h4 = reinterpret_cast<const float4*>(hs) + (size_t)bt * TB * H4;
  float v[N];
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = 0.f;
  for (int q = s; q < H4; q += S) {
    float4 w[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) w[i] = W4[i * H4 + q];
#pragma unroll
    for (int k = 0; k < TB; ++k) {
      const float4 h = h4[k * H4 + q];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        float& a = v[i * TB + k];
        a = fmaf(w[i].x, h.x, a);
        a = fmaf(w[i].y, h.y, a);
        a = fmaf(w[i].z, h.z, a);
        a = fmaf(w[i].w, h.w, a);
      }
    }
  }
  fold<N, 16>(v, lane);
  constexpr int held = N >= 32 ? N / 32 : 1;
  if (N < 32 && lane % (32 / N)) return;
  float* p = gp + (size_t)(s / 32) * kRows * bcp;
#pragma unroll
  for (int i = 0; i < held; ++i) {
    const int n = N >= 32 ? lane * held + i : lane / (32 / N);
    p[(rg * TR + n / TB) * bcp + bt * TB + n % TB] = v[i];
  }
}

// gp[w][r][b] = the sums of Ws[r][j] * hs[b][j] over the slices of H in
// warp w of a tile: the chunk's recurrent gate sums, in partial_sets(bcp)
// parts.  Rows b >= the chunk's rows hold stale values; their sums are
// never read.
__device__ __forceinline__ void chunk_product(const float* Ws, const float* hs,
                                              float* gp, int H, int bcp) {
  if (threadIdx.x >= tiles(bcp) * 32 * partial_sets(bcp)) return;   // whole warps
  if (tile_rows(bcp) == 4)
    tile_product<4, 4>(Ws, hs, gp, H, bcp);
  else
    tile_product<8, 8>(Ws, hs, gp, H, bcp);
}

// One cell: unit u of chunk row b.  Gates = x_proj (xs) plus, after the
// first step, the recurrent sums (gp, its parts in order); c in place;
// returns h.
__device__ __forceinline__ float cell(const float* xs, const float* gp, int bcp,
                                      int u, int b, bool recurrent, float& c) {
  const int parts = recurrent ? partial_sets(bcp) : 0;
  float g4[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int r = g * kUnits + u;
    float s = xs[b * kRows + r];
    for (int w = 0; w < parts; ++w) s += gp[((size_t)w * kRows + r) * bcp + b];
    g4[g] = s;
  }
  c = sigmoidf(g4[1]) * c + sigmoidf(g4[0]) * tanhf(g4[2]);
  return sigmoidf(g4[3]) * tanhf(c);
}

}  // namespace lstm

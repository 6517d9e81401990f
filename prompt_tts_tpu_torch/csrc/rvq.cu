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
// Two launches per call.  The first (rvq_prep_kernel) computes |e|^2 for
// every code, summed over d in order, and a d-major copy of the codebooks,
// [n_q, D, K], so the second can stage code tiles with 16-byte loads.  The
// second (rvq_encode_kernel) does the search: one CTA owns a tile of 64
// vectors, whose residual lives in shared memory (d-major, f32) for all n_q
// layers.  Each layer's codebook (K x D, 512 KB at K = 1024, D = 128: more
// than a CTA's shared memory) streams through shared memory in 64-code
// tiles.  256 threads form a 16 x 16 grid; each owns a 4-vector x 4-code
// micro-tile and accumulates its 16 dot products in f32, over d = 0..D-1 in
// order.  Each thread keeps a running (best distance, best index) per
// vector, scanning its codes upward with a strict '<', and a shuffle
// reduction over the 16 threads that share the vectors takes the lower
// index when distances are equal: the first index wins, as with
// jnp.argmax and torch argmax.  argmax(-s) is argmin(s) exactly, since
// negation is exact.  |r|^2 stays in the score, as in the plain version,
// and is recomputed from the peeled residual after every layer.
//
// Numerics.  f32 on the CUDA cores only: TF32 or bf16 tensor cores would
// round r.e to ~3 decimal digits and move the index of any vector whose two
// best codes lie closer than that.  The dot products are summed in another
// order than cuBLAS sums them, so an index may still differ from the plain
// version's where two codes tie to within f32 rounding of the score; the
// residual update is the same single f32 subtraction as in the plain
// version, so up to the first layer where the two differ both hold the same
// residual bits.
//
// What bounds it.  2 * N * n_q * K * D operations (60.4 GFLOP at
// B = 32, T = 900, n_q = 8): 0.90 ms at the card's 67 TFLOP/s f32 outside
// the tensor cores, against ~20 MB of inputs and outputs (6 us): bound by
// operations.  The micro-tile reads 2 float4 from shared memory per 16
// FMAs, so the loop is FMA-bound, not shared-memory-bound.  Tensor-core
// designs that keep the index contract (3 x TF32) are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C interface,
// loaded with ctypes by prompt_tts_tpu_torch/ops/cuda/rvq.py).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kD = 128;                 // vector and code dim
constexpr int kBM = 64;                 // vectors per CTA
constexpr int kBK = 64;                 // codes per shared-memory tile
constexpr int kTM = 4, kTN = 4;         // micro-tile: vectors x codes
constexpr int kThreads = (kBM / kTM) * (kBK / kTN);   // 256
constexpr int kSmem = sizeof(float) * (kD * kBM + kD * kBK + kBM) + sizeof(int) * kBM;

static_assert(kBM / kTM == 16 && kBK / kTN == 16, "16 x 16 thread grid");

// |e|^2 per code (summed over d in order) and the d-major codebook copy.
__global__ void rvq_prep_kernel(const float* __restrict__ cb,   // [n_q, K, D]
                                float* __restrict__ cb_t,       // [n_q, D, K]
                                float* __restrict__ esq,        // [n_q, K]
                                int n_q, int K) {
  const long long code = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (code >= (long long)n_q * K) return;
  const long long q = code / K, k = code % K;
  const float* e = cb + code * kD;
  float s = 0.f;
  for (int d = 0; d < kD; ++d) {
    const float v = e[d];
    s = fmaf(v, v, s);
    cb_t[(q * kD + d) * K + k] = v;
  }
  esq[code] = s;
}

__global__ void __launch_bounds__(kThreads)
rvq_encode_kernel(const float* __restrict__ x,      // [N, D]
                  const float* __restrict__ cb,     // [n_q, K, D]
                  const float* __restrict__ cb_t,   // [n_q, D, K]
                  const float* __restrict__ esq,    // [n_q, K]
                  int* __restrict__ out,            // [B, n_q, T]
                  int N, int T, int n_q, int K) {
  extern __shared__ float4 smem4[];
  float* r_s = reinterpret_cast<float*>(smem4);     // [kD][kBM] residual
  float* e_s = r_s + kD * kBM;                      // [kD][kBK] code tile
  float* xsq_s = e_s + kD * kBK;                    // [kBM] |r|^2
  int* idx_s = reinterpret_cast<int*>(xsq_s + kBM); // [kBM] chosen codes

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // codes tx*4.., vectors ty*4..
  const long long m0 = (long long)blockIdx.x * kBM;

  // The residual tile, d-major; vectors past N are zero and never written.
  for (int e = tid; e < kBM * kD; e += kThreads) {
    const int m = e % kBM, d = e / kBM;
    const long long n = m0 + m;
    r_s[d * kBM + m] = n < N ? x[n * kD + d] : 0.f;
  }
  __syncthreads();

  for (int q = 0; q < n_q; ++q) {
    if (tid < kBM) {
      float s = 0.f;
      for (int d = 0; d < kD; ++d) {
        const float v = r_s[d * kBM + tid];
        s = fmaf(v, v, s);
      }
      xsq_s[tid] = s;
    }
    __syncthreads();
    float xs[kTM], best[kTM];
    int bidx[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      xs[i] = xsq_s[ty * kTM + i];
      best[i] = CUDART_INF_F;
      bidx[i] = 0;
    }
    const float* ct = cb_t + (long long)q * kD * K;
    const float* eq = esq + (long long)q * K;

    for (int k0 = 0; k0 < K; k0 += kBK) {
      for (int e = tid; e < kD * kBK / 4; e += kThreads) {
        const int d = e / (kBK / 4), c4 = e % (kBK / 4);
        reinterpret_cast<float4*>(e_s)[e] =
            *reinterpret_cast<const float4*>(ct + (long long)d * K + k0 + c4 * 4);
      }
      __syncthreads();

      float acc[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < kD; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(r_s + d * kBM + ty * kTM);
        const float4 b = *reinterpret_cast<const float4*>(e_s + d * kBK + tx * kTN);
        const float av[kTM] = {a.x, a.y, a.z, a.w};
        const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      // distance = (|r|^2 - 2 r.e) + |e|^2, rounded step by step as the
      // plain version rounds it; codes are visited in increasing order
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int k = k0 + tx * kTN + j;
        const float es = eq[k];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float dist = __fadd_rn(__fsub_rn(xs[i], __fmul_rn(2.f, acc[i][j])), es);
          if (dist < best[i]) {
            best[i] = dist;
            bidx[i] = k;
          }
        }
      }
      __syncthreads();  // e_s is refilled by the next tile
    }

    // The 16 threads of a row group are 16 consecutive lanes of one warp.
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, best[i], off, 16);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off, 16);
        if (od < best[i] || (od == best[i] && oi < bidx[i])) {
          best[i] = od;
          bidx[i] = oi;
        }
      }
    }
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int m = ty * kTM + i;
        const long long n = m0 + m;
        idx_s[m] = bidx[i];
        if (n < N) out[((n / T) * n_q + q) * T + n % T] = bidx[i];
      }
    }
    __syncthreads();

    // Peel the chosen codes off the residual: one f32 subtraction each.
    const float* cq = cb + (long long)q * K * kD;
    for (int e = tid; e < kBM * kD; e += kThreads) {
      const int m = e % kBM, d = e / kBM;
      r_s[d * kBM + m] = __fsub_rn(r_s[d * kBM + m], cq[(long long)idx_s[m] * kD + d]);
    }
    __syncthreads();
  }
}

}  // namespace

// x [N, D], codebooks [n_q, K, D], scratch cb_t [n_q, D, K] and esq [n_q, K],
// out [B, n_q, T] with N = B*T: float32 (out int32), contiguous, one device;
// D must be 128 and K a multiple of 64.  Launches the prep kernel, then the
// search, on `stream`; returns the first launch error, or cudaSuccess.
extern "C" int ptts_rvq_encode(const float* x, const float* codebooks, float* cb_t,
                               float* esq, int* out, int N, int T, int n_q, int K,
                               int D, void* stream) {
  if (N <= 0 || T <= 0 || N % T != 0 || n_q <= 0 || K <= 0 || K % kBK != 0 ||
      D != kD)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The shared-memory opt-in (above 48 KB) holds per device: one bit per
  // device it has been set on.
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(configured & bit)) {
    err = cudaFuncSetAttribute(rvq_encode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured |= bit;
  }
  const long long codes = (long long)n_q * K;
  rvq_prep_kernel<<<(unsigned)((codes + 255) / 256), 256, 0, s>>>(codebooks, cb_t,
                                                                  esq, n_q, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rvq_encode_kernel<<<(unsigned)((N + kBM - 1) / kBM), kThreads, kSmem, s>>>(
      x, codebooks, cb_t, esq, out, N, T, n_q, K);
  return cudaGetLastError();
}

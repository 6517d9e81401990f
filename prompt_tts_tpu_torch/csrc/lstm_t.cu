// LSTM recurrence for Hopper (sm_90a), the persistent schedule: one layer,
// gate order i, f, g, o, zero initial state, all f32.
//
// Replaces the TPU kernel prompt_tts_tpu/ops/pallas/lstm.py:
// lstm_recurrence_t (_lstm_kernel_t).  Same contract: x_proj [T,B,4H] (the
// input projection for every timestep, computed outside as one matmul) and
// w_hh_t [4H,H] (recurrent weights in torch layout, NOT transposed):
// gates^T = W_hh h^T -> h [T,B,H].
//
// Design.  ONE cooperative launch runs all T steps; each CTA owns K = 4
// hidden units, whose four gate rows are four contiguous row bands of
// w_hh_t, and keeps that [16 x H] slice resident in shared memory for the
// whole sequence (32 KB at H = 512), with the cell state of its units.
// A step (lstm.cuh):
//   1. h_{t-1} = out[t-1], [B,H] and contiguous (8 KB at B = 4, 64 KB at
//      B = 32), is copied into shared memory by every thread at once with
//      16-byte cp.async.cg copies (L2 only, never a stale L1 line): one L2
//      round trip a step.  cp.async and not TMA: the copy is a flat run of
//      bytes that 256 threads cover in 1-16 copies each, and cp.async reads
//      through the generic proxy, so the barrier's acquire orders it with no
//      proxy fence;
//   2. all 8 warps compute the [16 x B] gate sums from shared memory only,
//      in 4 x 4 or 8 x 8 register tiles over slices of H, summed in a
//      fixed order;
//   3. one thread per (unit, batch row) adds x_proj[t] (copied into shared
//      memory during the previous barrier: it is read-only), applies the
//      gates and writes h_t into out[t], which is the exchange buffer;
//   4. a grid barrier: one monotone arrival counter.  Each CTA adds 1 with
//      red.release.gpu after a __syncthreads (the release covers the
//      CTA's h_t writes), thread 0 spins on ld.acquire.gpu until the
//      counter reaches gridDim.x * (t + 1), then __syncthreads.  No reset,
//      no generation word, no sleep; the host zeroes the counter per call.
// Batches of more than 32 rows are taken 32 rows at a time inside a step.
//
// What bounded the previous design: warp w took batch rows w, w+8, ... and
// its lanes walked H in 16 strides, each starting with a dependent L2 load
// of h (~0.24 us each): 6.23 us a step at B = 4 (4 warps busy, 4 idle),
// 17.8 us at B = 32 (4 row passes a warp), plus a count/reset/generation
// barrier with three fences and a sleeping spin.
//
// What bounds it now: per step the barrier's latency (release, L2 atomic,
// acquire), the L2 round trip of the h copy, and at B = 32 the
// FMAs (2 * B * 4H * H a step: 1.0 us at 67 TFLOP/s on the whole card)
// and the 8 MB of h the 128 CTAs read from L2.  Measured by chip_smoke.py
// on an NVIDIA H100 80GB HBM3 at 700.00 W, H = 512, ms a layer (us a
// step), the previous design in the same call in brackets:
//   T=900 B=4   2.47 (2.74)   [5.58-5.61]  bound 0.113  plain 69.1
//   T=900 B=32  4.27 (4.75)   [15.7-15.8]  bound 0.904  plain 78.0
//   T=225 B=4   0.574 (2.55)  [1.33]       bound 0.028  plain 17.1
// cuDNN's f32 nn.LSTM on the same x_proj: 9.58, 23.9, 1.98 ms.
//
// Co-residency.  A grid barrier deadlocks unless every CTA is resident at
// once.  The host checks that H / 4 CTAs fit the card by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count and raises
// where they do not, and the launch goes through cudaLaunchCooperativeKernel,
// which refuses a grid that cannot be co-resident rather than hanging.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C interface,
// loaded with ctypes by prompt_tts_tpu_torch/ops/cuda/lstm.py).

#include <cuda_runtime.h>

#include "lstm.cuh"

namespace {

using namespace lstm;

__device__ __forceinline__ void arrive(unsigned int* counter) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
               :: "l"(counter) : "memory");
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* counter) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(counter) : "memory");
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
lstm_t_kernel(const float* __restrict__ xp, const float* __restrict__ w,
              float* out, unsigned int* counter, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(B, H, B);
  float* Ws = smem;          // [kRows][H]: row g*kUnits+u = w_hh_t[g*H + j0 + u]
  float* hs = smem + L.hs;   // [bcp][H] h_{t-1}, one chunk of batch rows
  float* xs = smem + L.xs;   // [bcp][kRows] x_proj[t] of this CTA's units
  float* gp = smem + L.gp;   // partial gate sums
  float* cs = smem + L.cs;   // [B][kUnits] cell state

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kUnits;
  const int G = 4 * H, H4 = H / 4;
  for (int e = tid; e < kRows * H4; e += kThreads) {
    const int r = e / H4, q = e % H4;
    cp_async16(smem_u32(Ws + (size_t)r * H + 4 * q),
               w + (size_t)((r / kUnits) * H + j0 + r % kUnits) * H + 4 * q, true);
  }
  for (int e = tid; e < kUnits * B; e += kThreads) cs[e] = 0.f;
  stage_x(xs, xp, min(B, L.bcp), H, j0);

  for (int t = 0; t < T; ++t) {
    const float* x = xp + (size_t)t * B * G;
    const float* hp = out + (size_t)(t > 0 ? t - 1 : 0) * B * H;
    float* ho = out + (size_t)t * B * H;
    for (int b0 = 0; b0 < B; b0 += L.bcp) {
      const int nb = min(L.bcp, B - b0);
      if (b0 > 0) stage_x(xs, x + (size_t)b0 * G, nb, H, j0);
      if (t > 0) stage(hs, hp + (size_t)b0 * H, nb * H4);
      cp_wait_all();
      __syncthreads();
      if (t > 0) {
        chunk_product(Ws, hs, gp, H, L.bcp);
        __syncthreads();
      }
      for (int p = tid; p < kUnits * nb; p += kThreads) {
        const int u = p % kUnits, b = p / kUnits;
        float& c = cs[(b0 + b) * kUnits + u];
        ho[(size_t)(b0 + b) * H + j0 + u] = cell(xs, gp, L.bcp, u, b, t > 0, c);
      }
      __syncthreads();   // xs, hs and gp are restaged by the next chunk
    }
    if (t + 1 < T) {
      // Arrive, then copy the next step's x_proj (read-only) while the
      // barrier completes: issued after the release, the copies do not
      // delay it.
      if (tid == 0) arrive(counter);
      stage_x(xs, x + (size_t)B * G, min(B, L.bcp), H, j0);
      if (tid == 0) {
        const unsigned int target = gridDim.x * (unsigned int)(t + 1);
        while (load_acquire(counter) < target) {
        }
      }
      __syncthreads();
    }
  }
}

size_t smem_bytes(int B, int H) { return sizeof(float) * layout(B, H, B).total; }

}  // namespace

// Shared memory of one CTA at batch B and hidden size H, in bytes.
extern "C" long long ptts_lstm_t_smem_bytes(int B, int H) {
  return (long long)smem_bytes(B, H);
}

// The most CTAs of the kernel at batch B and hidden size H that the current
// device holds at once (0 where one CTA's shared memory does not fit).
extern "C" int ptts_lstm_t_max_ctas(int B, int H, int* max_ctas) {
  *max_ctas = 0;
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(B, H);
  if (smem > (size_t)smem_max) return cudaSuccess;
  err = cudaFuncSetAttribute(lstm_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lstm_t_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  *max_ctas = per_sm * sms;
  return cudaSuccess;
}

// x_proj [T,B,4H], w_hh_t [4H,H], out [T,B,H]: float32, contiguous, 16-byte
// aligned, one device, H a multiple of 4; counter: one unsigned int of
// scratch.  One cooperative launch of H / 4 CTAs on `stream`.
extern "C" int ptts_lstm_recurrence_t(const float* x_proj, const float* w_hh_t,
                                      float* out, unsigned int* counter, int T,
                                      int B, int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H % kUnits != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(B, H);
  void* args[] = {(void*)&x_proj, (void*)&w_hh_t, (void*)&out, (void*)&counter,
                  (void*)&T, (void*)&B, (void*)&H};
  err = cudaFuncSetAttribute(lstm_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel((const void*)lstm_t_kernel, dim3(H / kUnits),
                                    dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

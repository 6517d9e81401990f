// LSTM recurrence for Hopper (sm_90a), the persistent schedule: one layer,
// gate order i, f, g, o, zero initial state, all f32.
//
// Replaces the TPU kernel prompt_tts_tpu/ops/pallas/lstm.py:
// lstm_recurrence_t (_lstm_kernel_t).  Same contract: x_proj [T,B,4H] (the
// input projection for every timestep, computed outside as one matmul) and
// w_hh_t [4H,H] (recurrent weights in torch layout, NOT transposed):
// gates^T = W_hh h^T -> h [T,B,H].
//
// Design.  The step schedule (csrc/lstm.cu) launches one kernel per
// timestep and streams all of W_hh (4 MB at H = 512) from L2 every step.
// Here ONE cooperative launch runs all T steps.  Each CTA owns K = 4 hidden
// units; in torch layout their four gate rows are four contiguous row bands
// of w_hh_t, so the CTA keeps that 4K x H slice resident in shared memory for
// the whole sequence (32 KB at H = 512).  A step: each warp takes one batch
// row at a time and its 32 lanes stride over H (conflict-free shared reads
// of W, coalesced reads of h_{t-1}), 4K dot products a lane, reduced by warp
// shuffles; then one thread per (unit, batch row) adds x_proj, applies the
// gates and updates c (kept in shared memory for the whole sequence) and h,
// and writes h_t straight into out[t], which is the exchange buffer.  A
// grid-wide barrier ends the step: a generation counter with
// __threadfence() before arriving, and h_{t-1} read with ld.global.cg (L2,
// never a stale L1 line) after it.
//
// Co-residency.  A grid barrier deadlocks unless every CTA is resident at
// once.  The host checks that H / K CTAs fit the card by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count (a PCIe H100
// has 114 SMs, the SXM part 132) and raises where they do not, and the
// launch goes through cudaLaunchCooperativeKernel, which refuses a grid
// that cannot be co-resident rather than hanging.
//
// What bounds it.  The FLOPs are 2 * B * 4H * H a step (f32, CUDA cores);
// at B = 4 the step is bound by the barrier's latency (~ a microsecond) and
// at B = 32 by each CTA's 4K x B dot products over H.  expf/tanhf (not the
// fast intrinsics) keep 900 steps within the plain version's tolerance.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C interface,
// loaded with ctypes by prompt_tts_tpu_torch/ops/cuda/lstm.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int K = 4;         // hidden units a CTA owns

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void grid_barrier(unsigned int* count, unsigned int* gen,
                                             unsigned int n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int my_gen = *(volatile unsigned int*)gen;
    __threadfence();   // this CTA's h_t is visible before it arrives
    if (atomicAdd(count, 1u) == n - 1) {
      atomicExch(count, 0u);
      __threadfence();
      atomicAdd(gen, 1u);
    } else {
      while (*(volatile unsigned int*)gen == my_gen) __nanosleep(20);
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
lstm_t_kernel(const float* __restrict__ xp, const float* __restrict__ w,
              float* out, unsigned int* bar, int T, int B, int H) {
  constexpr int R = 4 * K;   // gate rows this CTA owns
  extern __shared__ float smem[];
  float* Ws = smem;                 // [R][H]: row g*K+u = w_hh_t[g*H + j0 + u]
  float* gs = Ws + R * H;           // [R][B] recurrent gate sums
  float* cs = gs + R * B;           // [K][B] cell state

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * K;
  const int G = 4 * H;
  for (int e = tid; e < R * H; e += kThreads) {
    const int r = e / H, j = e % H;
    Ws[e] = w[(long long)((r / K) * H + j0 + r % K) * H + j];
  }
  for (int e = tid; e < K * B; e += kThreads) cs[e] = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (t > 0) {
      const float* hp = out + (long long)(t - 1) * B * H;
      for (int b = warp; b < B; b += kWarps) {
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.f;
        for (int j = lane; j < H; j += 32) {
          const float hv = __ldcg(hp + (long long)b * H + j);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = fmaf(Ws[r * H + j], hv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
          if (lane == (r & 31)) gs[r * B + b] = acc[r];
        }
      }
      __syncthreads();
    }
    const float* x = xp + (long long)t * B * G;
    float* ho = out + (long long)t * B * H;
    for (int p = tid; p < K * B; p += kThreads) {
      const int u = p / B, b = p % B, j = j0 + u;
      float g4[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        g4[g] = x[(long long)b * G + g * H + j] + (t > 0 ? gs[(g * K + u) * B + b] : 0.f);
      const float c = sigmoidf(g4[1]) * cs[p] + sigmoidf(g4[0]) * tanhf(g4[2]);
      cs[p] = c;
      ho[(long long)b * H + j] = sigmoidf(g4[3]) * tanhf(c);
    }
    if (t + 1 < T) grid_barrier(bar, bar + 1, gridDim.x);
  }
}

size_t smem_bytes(int B, int H) {
  return sizeof(float) * ((size_t)4 * K * H + (size_t)4 * K * B + (size_t)K * B);
}

}  // namespace

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

// x_proj [T,B,4H], w_hh_t [4H,H], out [T,B,H]: float32, contiguous, one
// device, H a multiple of K; barrier: 2 unsigned ints of scratch.  One
// cooperative launch of H / K CTAs on `stream`.
extern "C" int ptts_lstm_recurrence_t(const float* x_proj, const float* w_hh_t,
                                      float* out, unsigned int* barrier, int T,
                                      int B, int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H % K != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(barrier, 0, 2 * sizeof(unsigned int), s);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(B, H);
  void* args[] = {(void*)&x_proj, (void*)&w_hh_t, (void*)&out, (void*)&barrier,
                  (void*)&T, (void*)&B, (void*)&H};
  err = cudaFuncSetAttribute(lstm_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel((const void*)lstm_t_kernel, dim3(H / K), dim3(kThreads),
                                    args, smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// LSTM recurrence for Hopper (sm_90a): one layer, gate order i, f, g, o,
// zero initial state, all f32.
//
// Replaces the TPU kernel prompt_tts_tpu/ops/pallas/lstm.py:lstm_recurrence
// (_lstm_kernel).  Same contract: x_proj [T,B,4H] (the input projection
// x @ w_ih^T + b for every timestep, computed outside as one matmul) and
// w_hh [H,4H] (recurrent weights, transposed) -> h [T,B,H].
//
// Design.  The TPU kernel kept w_hh resident in VMEM and carried h/c in
// scratch across sequential grid steps.  An SM has 227 KB of shared memory
// and w_hh is 4 MB at H = 512, and CUDA blocks run in no order, so here the
// time loop runs on the host side of this library: one launch per timestep,
// ordered on the caller's stream.  Each step kernel owns kUnits hidden units
// (4 gate columns each) and computes, for every batch row,
//   gates = x_proj[t] + h_{t-1} . w_hh[:, cols]
// split over kSlices slices of the H-long reduction, then applies
// sigmoid/tanh/sigmoid/sigmoid and updates c and h for its units.  h_{t-1}
// is read back from the previous output row (out[t-1]) and c lives in a
// device scratch updated in place: each (row, unit) is owned by exactly one
// block, and the next step's launch orders every read after every write.
//
// What bounds it.  Each step streams all of w_hh (4 MB), which stays
// resident in the 50 MB L2 across steps, plus one launch of latency; the
// FLOPs (2*B*H*4H per step) are small.  A persistent single launch with a
// grid-wide barrier per step, keeping w_hh slices in shared memory, is a
// later optimisation.  expf/tanhf (not the fast intrinsics) keep 900 steps
// within the plain version's tolerance.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C interface,
// loaded with ctypes by prompt_tts_tpu_torch/ops/cuda/lstm.py).

#include <cuda_runtime.h>

namespace {

constexpr int kUnits = 4;               // hidden units per block
constexpr int kCols = 4 * kUnits;       // gate columns per block
constexpr int kSlices = 16;             // slices of the H-long reduction
constexpr int kThreads = kCols * kSlices;
constexpr int kMaxB = 8;                // batch rows per pass (registers)

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(kThreads)
lstm_step_kernel(const float* __restrict__ xp,      // [B, 4H] at step t
                 const float* __restrict__ w,       // [H, 4H]
                 const float* __restrict__ h_prev,  // [B, H] or null (t = 0)
                 float* __restrict__ h_out,         // [B, H]
                 float* __restrict__ c,             // [B, H], in place
                 int B, int H) {
  extern __shared__ float smem[];
  float* hs = smem;                        // [kMaxB][H]
  float* part = hs + kMaxB * H;            // [kSlices][kCols][kMaxB]

  const int tid = threadIdx.x;
  const int col = tid % kCols;             // gate * kUnits + unit
  const int slice = tid / kCols;
  const int gate = col / kUnits, unit = col % kUnits;
  const int j0 = blockIdx.x * kUnits;
  const int G = 4 * H;
  const int wcol = gate * H + j0 + unit;
  const int klen = H / kSlices;
  const int kbeg = slice * klen;

  for (int b0 = 0; b0 < B; b0 += kMaxB) {
    const int nb = min(kMaxB, B - b0);
    for (int e = tid; e < nb * H; e += kThreads)
      hs[e] = h_prev ? h_prev[(long long)b0 * H + e] : 0.f;
    __syncthreads();

    float acc[kMaxB];
#pragma unroll
    for (int bb = 0; bb < kMaxB; ++bb) acc[bb] = 0.f;
    for (int kk = kbeg; kk < kbeg + klen; ++kk) {
      const float wv = w[(long long)kk * G + wcol];
#pragma unroll
      for (int bb = 0; bb < kMaxB; ++bb)
        if (bb < nb) acc[bb] = fmaf(hs[bb * H + kk], wv, acc[bb]);
    }
#pragma unroll
    for (int bb = 0; bb < kMaxB; ++bb)
      part[(slice * kCols + col) * kMaxB + bb] = acc[bb];
    __syncthreads();

    if (tid < kUnits * nb) {
      const int u = tid % kUnits, bb = tid / kUnits;
      const int j = j0 + u;
      const long long row = (long long)(b0 + bb);
      float g4[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = xp[row * G + g * H + j];
        for (int sl = 0; sl < kSlices; ++sl)
          s += part[(sl * kCols + g * kUnits + u) * kMaxB + bb];
        g4[g] = s;
      }
      const float ig = sigmoidf(g4[0]);
      const float fg = sigmoidf(g4[1]);
      const float gg = tanhf(g4[2]);
      const float og = sigmoidf(g4[3]);
      const float cn = fg * c[row * H + j] + ig * gg;
      c[row * H + j] = cn;
      h_out[row * H + j] = og * tanhf(cn);
    }
    __syncthreads();  // hs / part are reused by the next batch pass
  }
}

}  // namespace

// x_proj [T,B,4H], w_hh [H,4H], out [T,B,H], c_scratch [B,H]: all float32,
// contiguous, on one device.  Launches T step kernels on `stream`; returns
// the first launch error, or cudaGetLastError() after the last launch.
extern "C" int ptts_lstm_recurrence(const float* x_proj, const float* w_hh,
                                    float* out, float* c_scratch, int T, int B,
                                    int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H % kUnits != 0 || H % kSlices != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * ((size_t)kMaxB * H + kSlices * kCols * kMaxB);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // H <= 1280
  cudaError_t err = cudaMemsetAsync(c_scratch, 0, sizeof(float) * (size_t)B * H, s);
  if (err != cudaSuccess) return err;
  const long long xs = 4LL * B * H, hsz = (long long)B * H;
  for (int t = 0; t < T; ++t) {
    lstm_step_kernel<<<H / kUnits, kThreads, smem, s>>>(
        x_proj + t * xs, w_hh, t == 0 ? nullptr : out + (t - 1) * hsz,
        out + t * hsz, c_scratch, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// LSTM recurrence for Hopper (sm_90a), the step schedule: one layer, gate
// order i, f, g, o, zero initial state, all f32.
//
// Replaces the TPU kernel prompt_tts_tpu/ops/pallas/lstm.py:lstm_recurrence
// (_lstm_kernel).  Same contract: x_proj [T,B,4H] (the input projection
// x @ w_ih^T + b for every timestep, computed outside as one matmul) and
// w_hh [H,4H] (recurrent weights, transposed) -> h [T,B,H].
//
// Design.  The TPU kernel kept w_hh resident in VMEM and carried h/c in
// scratch across sequential grid steps.  Here the time loop stays on the
// host side of this library: one kernel a timestep, ordered on the
// caller's stream (the persistent schedule, lstm_t.cu, is the other
// counterpart).  Each step kernel has H / 4 CTAs; a CTA owns 4 hidden units,
// whose 16 gate columns are four runs of 4 consecutive columns of each row
// of w_hh.  A step kernel:
//   1. before griddepcontrol.wait (cudaGridDependencySynchronize), reads
//      what no earlier step writes: its [H,16] slice of w_hh (32 KB at
//      H = 512), as four 16-byte loads a row, all in flight, into shared
//      memory transposed to [16][H], and x_proj[t]'s columns of its units
//      (cp.async);
//   2. then calls griddepcontrol.launch_dependents, so the next step's CTAs
//      launch and read their W and x_proj[t+1] while this step runs;
//   3. after the wait, copies h_{t-1} = out[t-1] and its units' c into
//      shared memory (cp.async, one L2 round trip), computes the [16 x B]
//      gate sums in one pass over every batch row of up to 32 (lstm.cuh:
//      4 x 4 or 8 x 8 register tiles over slices of H, summed in a fixed
//      order),
//      then one thread per (unit, batch row) applies the gates and writes
//      c and h_t.
// Steps after the first are launched with cudaLaunchKernelEx and
// cudaLaunchAttributeProgrammaticStreamSerialization (programmatic
// dependent launch); the first is an ordinary launch, so it and every later
// step read x_proj and w_hh only after the work that wrote them finished.
//
// Shared memory.  With programmatic dependent launch two steps' CTAs share
// an SM (the next one's waiting while this one runs), so a CTA may use at
// most half an SM's shared memory: on an H100, 228 KB an SM less 1 KB
// reserved a CTA, 113 KB.  A CTA holds 16 H floats of W, 32 (or B, if
// fewer) rows of h, and ~2.5 KB more: H <= 576 at B >= 32 (H = 512: 100 KB),
// H <= 1436 at B <= 4.  Larger B is taken 32 rows at a time inside a step.
// ops/cuda/lstm.py:lstm_plan holds the same rule, and the host here
// refuses a launch that would fit fewer than two CTAs an SM.
//
// What bounded the previous design: a thread reduced 32 rows of w_hh with
// dependent scalar loads from L2 (~0.24 us each): 8.34 us a step at B = 4;
// at B = 32 four passes of 8 batch rows each read the CTA's W slice from
// L2 again: 29.1 us a step; plus a launch a step.
//
// What bounds it now: the gap from one step's end to the next step's
// h_{t-1} copy (the grid's completion, the wait, one L2 round trip), and
// at B = 32 the FMAs and the 8 MB of h the 128 CTAs read from L2 a step.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W,
// H = 512, ms a layer (us a step), the previous design in the same call in
// brackets:
//   T=900 B=4   3.59 (3.99)   [7.43-7.45]  bound 0.113  plain 85.3
//   T=900 B=32  6.53 (7.25)   [26.1-26.2]  bound 0.904  plain 73.8
//   T=225 B=4   0.907 (4.03)  [1.83-1.84]  bound 0.028  plain 22.5
// cuDNN's f32 nn.LSTM on the same x_proj: 9.58, 23.9, 1.98 ms.  The host
// enqueues the 900 launches of a layer in 1.6-2.9 ms, less than the card
// takes to run them (chip_smoke.py --lstm-times).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C interface,
// loaded with ctypes by prompt_tts_tpu_torch/ops/cuda/lstm.py).

#include <cuda_runtime.h>

#include "lstm.cuh"

namespace {

using namespace lstm;

__global__ void __launch_bounds__(kThreads, 2)
lstm_step_kernel(const float* __restrict__ xp,      // [B, 4H] at step t
                 const float* __restrict__ w,       // [H, 4H]
                 const float* h_prev,               // [B, H] or null (t = 0)
                 float* h_out,                      // [B, H]
                 float* c,                          // [B, H], in place
                 int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(B, H, chunk_rows(B));
  float* Ws = smem;          // [kRows][H]: row g*kUnits+u = w_hh[:, g*H + j0 + u]
  float* hs = smem + L.hs;   // [bcp][H] h_{t-1}, one chunk of batch rows
  float* xs = smem + L.xs;   // [bcp][kRows] x_proj[t] of this CTA's units
  float* gp = smem + L.gp;   // partial gate sums
  float* cs = smem + L.cs;   // [bcp][kUnits] the chunk's cell state

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kUnits;
  const int G = 4 * H, H4 = H / 4;
  // Read-only inputs first: W (transposed into rows) and x_proj[t].
  for (int e = tid; e < 4 * H; e += kThreads) {
    const int j = e % H, g = e / H;
    const float4 v = __ldg(reinterpret_cast<const float4*>(w + (size_t)j * G + g * H + j0));
    float* row = Ws + (size_t)g * kUnits * H + j;
    row[0] = v.x;
    row[H] = v.y;
    row[2 * H] = v.z;
    row[3 * H] = v.w;
  }
  stage_x(xs, xp, min(B, L.bcp), H, j0);
  // The previous step's h and c are read only after it has finished; let
  // the next step's CTAs start on their W now.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const bool recurrent = h_prev != nullptr;
  for (int b0 = 0; b0 < B; b0 += L.bcp) {
    const int nb = min(L.bcp, B - b0);
    if (b0 > 0) stage_x(xs, xp + (size_t)b0 * G, nb, H, j0);
    if (recurrent) {
      stage(hs, h_prev + (size_t)b0 * H, nb * H4);
      for (int b = tid; b < nb; b += kThreads)   // kUnits = 4: 16 bytes a row
        cp_async16(smem_u32(cs + b * kUnits), c + (size_t)(b0 + b) * H + j0, true);
    }
    cp_wait_all();
    __syncthreads();
    if (recurrent) {
      chunk_product(Ws, hs, gp, H, L.bcp);
      __syncthreads();
    }
    for (int p = tid; p < kUnits * nb; p += kThreads) {
      const int u = p % kUnits, b = p / kUnits;
      const size_t o = (size_t)(b0 + b) * H + j0 + u;
      float cv = recurrent ? cs[b * kUnits + u] : 0.f;
      h_out[o] = cell(xs, gp, L.bcp, u, b, recurrent, cv);
      c[o] = cv;
    }
    __syncthreads();   // xs, hs, gp and cs are restaged by the next chunk
  }
}

size_t smem_bytes(int B, int H) {
  return sizeof(float) * layout(B, H, chunk_rows(B)).total;
}

}  // namespace

// Shared memory of one CTA at batch B and hidden size H, in bytes.
extern "C" long long ptts_lstm_smem_bytes(int B, int H) {
  return (long long)smem_bytes(B, H);
}

// x_proj [T,B,4H], w_hh [H,4H], out [T,B,H], c_scratch [B,H]: all float32,
// contiguous, 16-byte aligned, on one device; H a multiple of 4.  Launches T
// step kernels on `stream`, all but the first with programmatic dependent
// launch; returns the first launch error, cudaErrorInvalidValue where fewer
// than two CTAs fit an SM, or cudaGetLastError() after the last launch.
extern "C" int ptts_lstm_recurrence(const float* x_proj, const float* w_hh,
                                    float* out, float* c_scratch, int T, int B,
                                    int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H % kUnits != 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(B, H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lstm_step_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 2) return cudaErrorInvalidValue;

  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H / kUnits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &pdl;
  const size_t xs = 4 * (size_t)B * H, hsz = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    cfg.numAttrs = t > 0 ? 1 : 0;
    const float* h_prev = t > 0 ? out + (t - 1) * hsz : nullptr;
    err = cudaLaunchKernelEx(&cfg, lstm_step_kernel, x_proj + t * xs, w_hh, h_prev,
                             out + t * hsz, c_scratch, B, H);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// Hopper building blocks shared by the tensor-core kernels: cp.async
// tile copies into the tensor cores' unswizzled shared-memory layout and
// its wgmma descriptors (attention.cu, attention_bwd.cu); TMA tile loads,
// mbarriers and 128-byte-swizzled descriptors (resnet.cu, rvq.cu); the
// bf16 wgmma instructions they run; TF32 products (rvq.cu, resnet.cu's f32
// convolutions, and the f32 attention kernels' 3 x TF32 tiles);
// thread-block cluster barriers and loads (rvq.cu).  sm_90a only.
//
// The tile layout.  A [rows][D] bf16 tile (rows a multiple of 8, D of 16)
// is kept as 8 x 8 "core matrices" of 128 contiguous bytes: element
// (r, d) lies at byte
//     (r / 8) * 16 D  +  (d / 8) * 128  +  (r % 8) * 16  +  (d % 8) * 2,
// wgmma's unswizzled ("interleave") layout.  The same bytes are
//   - a K-major operand whose K is D (the rows are M or N): the next
//     8 columns of K lie 128 bytes on (the leading byte offset), the next
//     8 rows 16 D bytes on (the stride byte offset);
//   - an MN-major operand whose N is D and whose K is the rows (P V,
//     dS K, ...): the next 8 rows of K lie 16 D bytes on (leading), the
//     next 8 columns of N 128 bytes on (stride).
// Any D works (at D = 96 a 192-byte row fits no swizzle atom), a warp's
// 16-byte copies land on 512 contiguous bytes, and wgmma reads whole
// 128-byte core matrices: no bank conflicts on either side.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptts {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; !ok writes 16 zero bytes and
// reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// 4 bytes global -> shared, asynchronous; !ok writes a zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Make this thread's shared-memory writes visible to wgmma's reads (the
// async proxy); a barrier then makes every thread's visible.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// A shared-memory matrix descriptor, unswizzled layout (type 0).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// The tile at `tile` as a K-major operand (K = D), starting at K column
// 16 * ks.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int ks) {
  return make_desc(tile + ks * 256, 128, 16 * D);
}

// The tile at `tile` as an MN-major operand (N = D, K = the rows),
// starting at row 16 * ks.
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int ks) {
  return make_desc(tile + ks * 32 * D, 16 * D, 128);
}

// Two f32 values as one bf16x2 register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Issue the copies of rows [0, nrows) of a [rows][D] bf16 panel (row
// stride ld elements, 16-byte aligned rows) into the tile at `dst`, by the
// NT threads of the block; rows >= valid are zero-filled.  Chunk c (16
// bytes) goes to byte 16 c of the tile: 8 consecutive chunks are the 8
// rows of one core matrix.
template <int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int valid,
                                          int nrows) {
  constexpr int kChunks = D / 8;   // 16-byte chunks a row
  for (int c = threadIdx.x; c < nrows * kChunks; c += NT) {
    const int rest = c >> 3;
    const int row = (rest / kChunks) * 8 + (c & 7);
    const int col = (rest % kChunks) * 8;
    const bool ok = row < valid;
    cp_async16(dst + 16 * c, ok ? src + row * ld + col : src, ok);
  }
}

// 2^x on the special-function unit (one instruction; results below 2^-126
// flush to 0, which a probability that small contributes anyway).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The bf16 A fragments of a 64 x 64 f32 accumulator s (wgmma's layout),
// for its four 16-column K steps: the accumulator layout of a 16-bit
// product is the A-operand register layout.
__device__ __forceinline__ void acc_to_a(const float (&s)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    a[t][0] = pack_bf16(s[8 * t + 0], s[8 * t + 1]);
    a[t][1] = pack_bf16(s[8 * t + 2], s[8 * t + 3]);
    a[t][2] = pack_bf16(s[8 * t + 4], s[8 * t + 5]);
    a[t][3] = pack_bf16(s[8 * t + 6], s[8 * t + 7]);
  }
}

// d[0:32] (+)= A[64x16] B[16x64], both operands in shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:64] (+)= A[64x16] B[16x128], both operands in shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:16] (+)= A[64x16] B[16x32]: A from registers (the bf16 fragment of
// a 64-row accumulator), B in shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d[0:32] (+)= A[64x16] B[16x64]: A from registers (the bf16 fragment of
// a 64-row accumulator), B in shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d[0:48] (+)= A[64x16] B[16x96]: A from registers (the bf16 fragment of
// a 64-row accumulator), B in shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[48],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d[0:64] (+)= A[64x16] B[16x128]: A from registers (the bf16 fragment of
// a 64-row accumulator), B in shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// ---- TMA, mbarriers and the 128-byte swizzle (resnet.cu) ----
//
// A TMA box whose rows are 128 bytes (64 bf16), loaded with
// CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned tile, is wgmma's
// 128-byte-swizzled K-major layout: 8-row groups 1024 bytes apart (the
// stride byte offset), the 16-byte chunks of row r XOR-ed with r % 8.  The
// K step ks (16 columns) starts 32 ks bytes into the tile; the hardware
// applies the swizzle to the address, so the descriptor moves by 32 bytes.

// A shared-memory matrix descriptor, 128-byte swizzle (type 1), K-major.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive, and expect `bytes` more of TMA traffic before the phase ends.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box global -> shared at (c0, c1[, c2]) of the tensor map `map`
// (a __grid_constant__ kernel parameter); elements outside the tensor are
// zero.  Completion is counted in bytes on the mbarrier `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Synchronise the first `n` threads of the block (a multiple of 32) on
// hardware barrier `id` (1-15; __syncthreads uses 0).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Arrive at hardware barrier `id` of `n` threads without waiting.
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}


// One contiguous copy global -> shared of `bytes` (a multiple of 16, both
// addresses 16-byte aligned), counted in bytes on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// ---- TF32 products (rvq.cu, resnet.cu) ----
//
// wgmma's .tf32 operands are K-major only.  An f32 tile whose rows are
// loaded as TMA boxes of 32 floats (128 bytes) with the 128-byte swizzle is
// the same swizzled K-major layout as a 64-wide bf16 box: a K step of 8
// tf32 is 32 bytes, as one of 16 bf16 is, so sw128_desc serves both and
// the step ks (8 columns) within a box starts 32 (ks % 4) bytes in.

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the low 13 bits of the result are zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), both rounded explicitly (the tensor core
// would truncate the low 13 bits of an f32 operand): a product of two
// split values to f32 accuracy is hi.hi + hi.lo + lo.hi.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// d[0:32] (+)= A[64x8] B[8x64] in TF32 with f32 accumulation: A from
// registers (per warp, rows gid and gid + 8 of its 16, columns tig and
// tig + 4: a[0] (gid, tig), a[1] (gid + 8, tig), a[2] (gid, tig + 4),
// a[3] (gid + 8, tig + 4), gid = lane / 4, tig = lane % 4), B in shared
// memory, K-major.  The accumulator layout is the bf16 products'.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d[0:16] (+)= A[64x8] B[8x32] in TF32, f32 accumulation: A from registers
// (the fragment of wgmma_tf32_rs above), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d[0:48] (+)= A[64x8] B[8x96] in TF32, f32 accumulation: A from registers
// (the fragment of wgmma_tf32_rs above), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[48],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d[0:64] (+)= A[64x8] B[8x128] in TF32, f32 accumulation: A from registers
// (the fragment of wgmma_tf32_rs above), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d[0:8] (+)= A[64x8] B[8x16] in TF32, f32 accumulation: both operands in
// shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:16] (+)= A[64x8] B[8x32] in TF32, f32 accumulation: both operands in
// shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:32] (+)= A[64x8] B[8x64] in TF32, f32 accumulation: both operands in
// shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:64] (+)= A[64x8] B[8x128] in TF32, f32 accumulation: both operands
// in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}


// ---- 3 x TF32 attention tiles (attention.cu, attention_bwd.cu) ----
//
// An f32 [rows][kd] tile (rows a multiple of 8, kd of 4) kept in wgmma's
// unswizzled core-matrix layout, element (r, c) at byte
//     (r / 8) * 32 kd  +  (c / 4) * 128  +  (r % 8) * 16  +  (c % 4) * 4:
// the bf16 layout above with 4-byte elements (a core matrix is 8 rows of
// 16 bytes, a K step of 8 tf32 two of them, 128 bytes apart).  It is a
// K-major operand whose K is kd, the only kind .tf32 reads; a product that
// contracts over the rows of a panel (P V, dS K, P^T dO, dS^T Q) takes the
// panel transposed (store_transposed).  Every value is kept as its TF32
// split, a hi and a lo tile.

// The tile at `tile` ([rows][KD]) as a K-major operand, from K column 8 ks.
template <int KD>
__device__ __forceinline__ uint64_t tf32_desc(uint32_t tile, int ks) {
  return make_desc(tile + ks * 256, 128, 32 * KD);
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

// Four values split (split_tf32) and stored as 16 bytes at hi and at lo.
__device__ __forceinline__ void store_split4(uint32_t hi, uint32_t lo,
                                             float a, float b, float c,
                                             float d) {
  uint32_t h[4], l[4];
  split_tf32(a, h[0], l[0]);
  split_tf32(b, h[1], l[1]);
  split_tf32(c, h[2], l[2]);
  split_tf32(d, h[3], l[3]);
  st_shared_v4(hi, h[0], h[1], h[2], h[3]);
  st_shared_v4(lo, l[0], l[1], l[2], l[3]);
}

// Copying a panel into the tiles takes two steps, so that a thread issues
// all of its loads (one round trip to L2) before its first store, whose
// "memory" clobber no load may pass: load_* into registers, then store_*,
// which splits (split_tf32) and writes the hi and lo tiles.  The panel is
// rows [0, ROWS) of an f32 [rows][KD] array, row stride ld floats, rows
// 16-byte aligned; rows >= valid read as 0.  NT threads of the block take
// part.

// 16 bytes from device memory (read-only) or from a raw panel in shared
// memory (stage_raw).
template <bool kGlobal>
__device__ __forceinline__ float4 ld4(const float* p) {
  if constexpr (kGlobal) return __ldg(reinterpret_cast<const float4*>(p));
  else return *reinterpret_cast<const float4*>(p);
}

// A raw f32 panel staged in shared memory has rows raw_ld<KD>() floats
// apart: 4 floats of padding move row r + 1 16 bytes along the banks, so
// the 8 rows that a quarter warp of load_kmajor reads at one column fall on
// 8 distinct bank groups.
template <int KD>
__host__ __device__ constexpr int raw_ld() { return KD + 4; }

// Issue the cp.async copies of rows [0, ROWS) of an f32 panel [rows][KD]
// (row stride ld floats, 16-byte aligned rows; rows >= valid are zero)
// into the raw panel at dst, by the NT threads of the block.
template <int ROWS, int KD, int NT>
__device__ __forceinline__ void stage_raw(uint32_t dst, const float* src,
                                          long long ld, int valid) {
  constexpr int kChunks = KD / 4;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += NT) {
    const int row = c / kChunks, col = (c % kChunks) * 4;
    const bool ok = row < valid;
    cp_async16(dst + 4 * (row * raw_ld<KD>() + col),
               ok ? src + row * ld + col : src, ok);
  }
}

// The loads of a natural tile [ROWS][KD]: chunk c (4 floats) is a 16-byte
// load and goes to byte 16 c of the tile, so 8 consecutive chunks are the 8
// rows of one core matrix and a quarter warp's stores fill 128 contiguous
// bytes.
template <int ROWS, int KD, int NT>
struct Kmajor {
  static constexpr int kChunks = KD / 4;           // chunks a row
  static constexpr int kTotal = ROWS * kChunks;
  static constexpr int kN = (kTotal + NT - 1) / NT;   // chunks a thread
};

template <int ROWS, int KD, int NT, bool kGlobal = true>
__device__ __forceinline__ void load_kmajor(
    float4 (&x)[Kmajor<ROWS, KD, NT>::kN], const float* src, long long ld,
    int valid) {
  using P = Kmajor<ROWS, KD, NT>;
#pragma unroll
  for (int i = 0; i < P::kN; ++i) {
    const int c = threadIdx.x + i * NT;
    const int rest = c >> 3;
    const int row = (rest / P::kChunks) * 8 + (c & 7);
    const int col = (rest % P::kChunks) * 4;
    x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((P::kTotal % NT == 0 || c < P::kTotal) && row < valid)
      x[i] = ld4<kGlobal>(src + row * ld + col);
  }
}

template <int ROWS, int KD, int NT>
__device__ __forceinline__ void store_kmajor(
    uint32_t hi, uint32_t lo, const float4 (&x)[Kmajor<ROWS, KD, NT>::kN]) {
  using P = Kmajor<ROWS, KD, NT>;
#pragma unroll
  for (int i = 0; i < P::kN; ++i) {
    const int c = threadIdx.x + i * NT;
    if (P::kTotal % NT == 0 || c < P::kTotal)
      store_split4(hi + 16 * c, lo + 16 * c, x[i].x, x[i].y, x[i].z, x[i].w);
  }
}

// The transposed tile [KD][ROWS]: a K-major operand whose K is the panel's
// rows.  Within each group of 8 rows, row 8 j + i goes to K position
// 8 j + i / 2 + 4 (i % 2), the order in which acc_to_tf32 hands an
// accumulator's columns to the A fragment.  A thread takes a block of 4
// rows in that order (8 j + e + 2 t, t < 4) by 4 columns (4 c ..): four
// 16-byte loads (neighbouring threads read neighbouring chunks of the same
// rows), then one 16-byte store per column and tile, the 4 rows' values.
// Column 4 c + u lands on byte 16 (4 (c % 2) + u) of a 128-byte bank row,
// so each thread stores its columns starting at u = (c / 2) % 4: the 8
// threads of a quarter warp (8 neighbouring c) then hit 8 distinct 16-byte
// bank groups.
template <int ROWS, int KD, int NT>
struct Transposed {
  static constexpr int kCols = KD / 4;              // 4-column chunks
  static constexpr int kTotal = (ROWS / 4) * kCols;   // 4 x 4 blocks
  static constexpr int kN = (kTotal + NT - 1) / NT;   // blocks a thread
};

template <int ROWS, int KD, int NT, bool kGlobal = true>
__device__ __forceinline__ void load_transposed(
    float4 (&x)[Transposed<ROWS, KD, NT>::kN][4], const float* src,
    long long ld, int valid) {
  using P = Transposed<ROWS, KD, NT>;
#pragma unroll
  for (int i = 0; i < P::kN; ++i) {
    const int b = threadIdx.x + i * NT;
    const int c = b % P::kCols, g = b / P::kCols;
    const int row = 8 * (g >> 1) + (g & 1);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      x[i][t] = make_float4(0.f, 0.f, 0.f, 0.f);
      if ((P::kTotal % NT == 0 || b < P::kTotal) && row + 2 * t < valid)
        x[i][t] = ld4<kGlobal>(src + (row + 2 * t) * ld + 4 * c);
    }
  }
}

// Component u of v (u < 4, not known at compile time) by selects: an
// indexed register array would go to local memory.
__device__ __forceinline__ float pick(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <int ROWS, int KD, int NT>
__device__ __forceinline__ void store_transposed(
    uint32_t hi, uint32_t lo,
    const float4 (&x)[Transposed<ROWS, KD, NT>::kN][4]) {
  using P = Transposed<ROWS, KD, NT>;
#pragma unroll
  for (int i = 0; i < P::kN; ++i) {
    const int b = threadIdx.x + i * NT;
    if (P::kTotal % NT != 0 && b >= P::kTotal) continue;
    const int c = b % P::kCols, g = b / P::kCols;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int u = (s + (c >> 1)) & 3;
      const int col = 4 * c + u;
      const uint32_t off = (col / 8) * (32 * ROWS) + g * 128 + (col % 8) * 16;
      store_split4(hi + off, lo + off, pick(x[i][0], u), pick(x[i][1], u),
                   pick(x[i][2], u), pick(x[i][3], u));
    }
  }
}

// One panel into its natural or its transposed tiles.
template <int ROWS, int KD, int NT>
__device__ __forceinline__ void split_kmajor(uint32_t hi, uint32_t lo,
                                             const float* src, long long ld,
                                             int valid) {
  float4 x[Kmajor<ROWS, KD, NT>::kN];
  load_kmajor<ROWS, KD, NT>(x, src, ld, valid);
  store_kmajor<ROWS, KD, NT>(hi, lo, x);
}

template <int ROWS, int KD, int NT>
__device__ __forceinline__ void split_transposed(uint32_t hi, uint32_t lo,
                                                 const float* src,
                                                 long long ld, int valid) {
  float4 x[Transposed<ROWS, KD, NT>::kN][4];
  load_transposed<ROWS, KD, NT>(x, src, ld, valid);
  store_transposed<ROWS, KD, NT>(hi, lo, x);
}

// The TF32 hi and lo A fragments of a 64 x N f32 accumulator s (s[4 j +
// 2 r + e] is row gid + 8 r, column 8 j + 2 tig + e) for its N / 8 K steps.
// A step's fragment holds K positions tig and tig + 4 (wgmma_tf32_rs); the
// thread has columns 2 tig and 2 tig + 1, so position tig takes column
// 2 tig and position tig + 4 column 2 tig + 1, and no value moves between
// threads: the B operand's rows come in that order (store_transposed).
template <int NS>
__device__ __forceinline__ void acc_to_tf32(const float (&s)[NS],
                                            uint32_t (&hi)[NS / 4][4],
                                            uint32_t (&lo)[NS / 4][4]) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    split_tf32(s[4 * j + 0], hi[j][0], lo[j][0]);
    split_tf32(s[4 * j + 2], hi[j][1], lo[j][1]);
    split_tf32(s[4 * j + 1], hi[j][2], lo[j][2]);
    split_tf32(s[4 * j + 3], hi[j][3], lo[j][3]);
  }
}

// This thread's TF32 hi and lo A fragments of rows r0 and r0 + 8 of a
// [64][D] f32 panel (row stride ld; rows >= valid read as 0): step ks holds
// columns 8 ks + tig and 8 ks + tig + 4.
template <int D>
__device__ __forceinline__ void load_a_tf32(const float* src, long long ld,
                                            int valid, int r0, int tig,
                                            uint32_t (&hi)[D / 8][4],
                                            uint32_t (&lo)[D / 8][4]) {
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 8 * (i & 1);
      const float x = row < valid
          ? __ldg(src + row * ld + 8 * ks + tig + 4 * (i >> 1)) : 0.f;
      split_tf32(x, hi[ks][i], lo[ks][i]);
    }
}

// d (+)= A B over KS steps of 8 in 3 x TF32, A = ah + al and B = bh + bl:
// ah bl, then al bh, then ah bh, the small terms first (the dropped al bl
// is ~2^-22 of |A||B|); accumulate = 0 starts d afresh.  A from registers,
// B the tiles bh and bl, K-major with K extent KB.
template <int KB, int KS, int ND>
__device__ __forceinline__ void mma3_rs(float (&d)[ND],
                                        const uint32_t (&ah)[KS][4],
                                        const uint32_t (&al)[KS][4],
                                        uint32_t bh, uint32_t bl,
                                        int accumulate) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_tf32_rs(d, ah[ks], tf32_desc<KB>(bl, ks), ks > 0 || accumulate);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_tf32_rs(d, al[ks], tf32_desc<KB>(bh, ks), 1);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_tf32_rs(d, ah[ks], tf32_desc<KB>(bh, ks), 1);
}

// The same with A in shared memory too: the tiles ah and al [64][KB].
template <int KB, int ND>
__device__ __forceinline__ void mma3_ss(float (&d)[ND], uint32_t ah,
                                        uint32_t al, uint32_t bh, uint32_t bl,
                                        int accumulate) {
#pragma unroll
  for (int ks = 0; ks < KB / 8; ++ks)
    wgmma_tf32_ss(d, tf32_desc<KB>(ah, ks), tf32_desc<KB>(bl, ks),
                  ks > 0 || accumulate);
#pragma unroll
  for (int ks = 0; ks < KB / 8; ++ks)
    wgmma_tf32_ss(d, tf32_desc<KB>(al, ks), tf32_desc<KB>(bh, ks), 1);
#pragma unroll
  for (int ks = 0; ks < KB / 8; ++ks)
    wgmma_tf32_ss(d, tf32_desc<KB>(ah, ks), tf32_desc<KB>(bh, ks), 1);
}

// Move this warpgroup's register budget to R registers a thread (all its
// warps together): a producer gives registers up, consumers take them.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// ---- Thread-block clusters (rvq.cu) ----

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster-wide barrier, split: every non-exited thread of every CTA
// of the cluster arrives (all 32 lanes of a warp together), then waits.
// The arrival releases this thread's earlier shared-memory writes to the
// cluster; the wait acquires every other thread's.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared-memory address `addr` of this CTA mapped to the same offset
// in the CTA of rank `rank` of the cluster.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Two 32-bit words from distributed shared memory.
__device__ __forceinline__ uint2 ld_cluster_u32x2(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared::cluster.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(addr) : "memory");
  return v;
}

}  // namespace ptts

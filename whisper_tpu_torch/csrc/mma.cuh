// Tensor-core building blocks for the port's bf16 kernels that stage tiles
// in shared memory (fused_step.cu, logits.cu, dtw.cu; the wgmma kernels use
// hopper.cuh):
// mma.sync m16n8k16 (bf16 in, f32 accumulate), ldmatrix, and cp.async with
// zero fill.  Fragment layouts (PTX ISA, mma.m16n8k16 for .bf16), for lane
// = 4 g + t (g the group, t the thread in the group):
//   A (16 x 16, row): a0 = A[g][2t, 2t + 1], a1 = A[g + 8][2t, 2t + 1],
//                     a2 = A[g][2t + 8, 2t + 9], a3 = A[g + 8][2t + 8, 2t + 9];
//   B (16 x 8, col):  b0 = B[2t, 2t + 1][g], b1 = B[2t + 8, 2t + 9][g];
//   C (16 x 8, f32):  c0, c1 = C[g][2t, 2t + 1], c2, c3 = C[g + 8][2t, 2t + 1].
// Two C tiles side by side (16 x 16) hold an A tile's values in the same
// lanes: a0 = (c[0][0], c[0][1]), a1 = (c[0][2], c[0][3]), a2 = (c[1][0],
// c[1][1]), a3 = (c[1][2], c[1][3]), each pair rounded to bf16.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

// d (16 x 8) += a (16 x 16) b (16 x 8), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16_m16n8k16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices from shared memory; lanes 8 i .. 8 i + 7 give
// the row addresses of matrix i (16-byte aligned), lane l receives row
// l / 4, columns 2 (l % 4) and + 1 of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// the same, each matrix transposed: lane l receives rows 2 (l % 4) and + 1
// of column l / 4
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// !valid (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two floats as a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two bf16 of a pair as floats
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// the first `bytes` (0-16) of 16 from global to shared memory,
// asynchronously, the rest zero-filled; src 16-byte aligned (and a valid
// address even where bytes is 0)
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

// Warp-level tile products shared by the hand-written kernels.
//
// A warp computes an (MT*16) x (NT*8) block of C += A * B one k16 step at a
// time, with A rows and B (stored [n][k], k contiguous) in shared memory.
// bf16 operands go through the tensor cores (mma.sync m16n8k16, f32
// accumulators); f32 operands run the same fragment layout on the FP32
// pipes with fmaf, so both element types share every tiling decision of the
// kernels and differ only here.
//
// Fragment layout (PTX ISA, mma.m16n8k16 .bf16), g = lane / 4, t = lane % 4:
//   A: a0 = A[g][2t..2t+1]   a1 = A[g+8][2t..]   a2 = A[g][2t+8..]   a3 = A[g+8][2t+8..]
//   B: b0 = B[2t..2t+1][g]   b1 = B[2t+8..2t+9][g]
//   C: c0, c1 = C[g][2t], C[g][2t+1]     c2, c3 = C[g+8][2t], C[g+8][2t+1]
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace srgan {

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

__device__ __forceinline__ void zero16(void* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One k16 step. alo[m] / ahi[m]: A rows g and g+8 of m-tile m; koff: the
// step's k offset into those rows and into the B rows; b: B row 0 (n = 0),
// row stride ldb.
template <int MT, int NT>
__device__ __forceinline__ void warp_k16(float (&acc)[MT][NT][4],
                                         const __nv_bfloat16* const* alo,
                                         const __nv_bfloat16* const* ahi, int koff,
                                         const __nv_bfloat16* b, int ldb, int g,
                                         int t) {
  uint32_t a[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    a[m][0] = ld32(alo[m] + koff + 2 * t);
    a[m][1] = ld32(ahi[m] + koff + 2 * t);
    a[m][2] = ld32(alo[m] + koff + 2 * t + 8);
    a[m][3] = ld32(ahi[m] + koff + 2 * t + 8);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const __nv_bfloat16* bp = b + (n * 8 + g) * ldb + koff + 2 * t;
    const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
#pragma unroll
    for (int m = 0; m < MT; ++m)
      mma_16816(acc[m][n], a[m][0], a[m][1], a[m][2], a[m][3], b0, b1);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void warp_k16(float (&acc)[MT][NT][4],
                                         const float* const* alo,
                                         const float* const* ahi, int koff,
                                         const float* b, int ldb, int g, int t) {
#pragma unroll 4
  for (int k = 0; k < 16; ++k) {
    float x0[MT], x1[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      x0[m] = alo[m][koff + k];
      x1[m] = ahi[m][koff + k];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float w0 = b[(n * 8 + 2 * t) * ldb + koff + k];
      const float w1 = b[(n * 8 + 2 * t + 1) * ldb + koff + k];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        acc[m][n][0] = fmaf(x0[m], w0, acc[m][n][0]);
        acc[m][n][1] = fmaf(x0[m], w1, acc[m][n][1]);
        acc[m][n][2] = fmaf(x1[m], w0, acc[m][n][2]);
        acc[m][n][3] = fmaf(x1[m], w1, acc[m][n][3]);
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace srgan

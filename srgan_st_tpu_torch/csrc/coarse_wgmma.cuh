// Hopper building blocks of the bf16 kernels A (csrc/coarse_conv.cu) and B
// (csrc/serving_tail.cu), and the doubly coarse tap product both run.
//
// - wgmma: a warpgroup (4 warps) issues m64nNk16 bf16 products with both
//   operands in shared memory, f32 accumulators in registers.
// - Operands use the no-swizzle K-major layout: an operand of R rows is
//   stored as [k group][row][8 bf16], one 16-byte row segment per (row,
//   k group). A core matrix (8 rows x 16 bytes) is then 128 contiguous
//   bytes starting at ANY row, so a window shifted by one row is still a
//   legal descriptor: the shifted-window (im2col) view of a conv costs no
//   copy. LBO is the distance between k groups, SBO between 8-row blocks.
// - cp.async with zero fill stages activations (the image edge is zeros);
//   cp.async.bulk with an mbarrier streams contiguous weight blocks.
//
// The doubly coarse product (`coarse_taps`): for an output row of N
// quarter-resolution columns, D[n][j] += sum over the 18 taps (qy, ry,
// qx) and k of W[tap][n][k] * win[2 qy + ry + row offset][j + qx][k],
// computed transposed (M = the 48 output channels padded to 64, N = the
// columns), so one weight tile feeds every row a warpgroup owns. Rows 48..63
// of each weight tile read the next 256 bytes of shared memory; their
// accumulator rows are never stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace srgan {
namespace hop {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// no-swizzle K-major descriptor: start, LBO (k group stride), SBO (8-row stride)
__device__ __forceinline__ uint64_t desc(uint32_t start, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((start & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy (wgmma, bulk copies); then a barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define SRGAN_R8(i) "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x N, f32) += A (64 x 16, descriptor) * B (N x 16, descriptor)^T
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : SRGAN_R8(0), SRGAN_R8(8)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : SRGAN_R8(0), SRGAN_R8(8), SRGAN_R8(16), SRGAN_R8(24)
      : "l"(a), "l"(b), "r"(1));
}
#undef SRGAN_R8

// 16-byte cp.async; copies zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// one thread: copy `bytes` (a multiple of 16, 16-byte aligned) from global
// to shared memory, completing on `bar` (armed for exactly these bytes)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The weights of the doubly coarse product in shared memory: for tap t and
// k group g, the 48 output channels' 16-byte segments, [tap][g][48][8].
constexpr int N3 = 48;

// One warpgroup's share of the doubly coarse product over a K slab of 8 G
// elements: for each of its ROWS output rows (fine-row offset 2 * row0[r]
// in the window), the taps tap0 .. tap0 + ntap - 1, whose weights sit at
// `w` ([ntap][G][48][8]) and whose window ([fine row][G][COLS][8]) at
// `win`. The caller fences before and commits after.
template <int N, int ROWS, int G, int COLS>
__device__ __forceinline__ void coarse_taps(float (&acc)[ROWS][N / 2], uint32_t w,
                                            uint32_t win, const int (&row0)[ROWS],
                                            int tap0, int ntap) {
  constexpr uint32_t W_LBO = N3 * 16, WIN_LBO = COLS * 16;
  for (int tl = 0; tl < ntap; ++tl) {
    const int tap = tap0 + tl;
    const int qy = tap / 6, ry = (tap / 3) & 1, qx = tap % 3;
#pragma unroll
    for (int s = 0; s < G / 2; ++s) {
      const uint64_t a = desc(w + (uint32_t)((tl * G + 2 * s) * N3 * 16), W_LBO, 128);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int fr = 2 * row0[r] + 2 * qy + ry;
        const uint64_t b =
            desc(win + (uint32_t)(((fr * G + 2 * s) * COLS + qx) * 16), WIN_LBO, 128);
        wgmma_bf16<N>(acc[r], a, b);
      }
    }
  }
}

}  // namespace hop
}  // namespace srgan

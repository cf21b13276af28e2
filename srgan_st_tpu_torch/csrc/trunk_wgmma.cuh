// Hopper tiles of the bf16 residual trunk (csrc/packed_trunk.cu, K4/K5;
// csrc/fused_trunk.cu, K6): the padded-grid geometry of the 3x3 conv tile
// (whose body is csrc/trunk_conv_tile.cuh) and of the weight-gradient tile,
// both on wgmma with operands in shared memory (csrc/coarse_wgmma.cuh),
// and the BatchNorm reductions that ride in their epilogues.
//
// Padded grid. The B x H x W pixels are placed on the zero-padded grid
// B x (H+2) x (W+2), flattened: position q. A conv output at q reads its
// 9 inputs at q + (ky-1)(W+2) + (kx-1), so an M tile of 64 consecutive
// positions reads one window of consecutive positions, and tap (ky, kx)
// is that window moved by a whole number of rows: a descriptor offset, no
// im2col copy. Positions that are padding (or past the grid) load as
// zeros, and the epilogue drops them.
//
// Window. Stored [k group][row][8 bf16] (no-swizzle K-major), `rows` rows
// per 64-channel chunk. When W + 2 <= 66 it is one run of 64 + 2(W+2) + 2
// positions (tap row ky (W+2) + kx); for wider images it is three bands of
// 66 positions, one per kernel row (tap row 66 ky + kx), so that its size
// does not grow with W. Window row r holds position
//   q0 - (W+2) - 1 + (r / band) (W+2) + r % band.
//
// Weight gradient. dW[tap][ci][co] = sum_q src[q + shift(tap)][ci] dy[q][co]
// is a product with K = the positions: src^T (M = ci) and dy (N = co) are
// both MN-major, so the same [channel group][row][8] window serves with
// the transpose flags set (LBO = 128 bytes between 8-position groups, SBO
// = the stride between 8-channel groups), and a tap's shift is again a
// descriptor offset over the padded grid. dy is zero at padding positions,
// so those rows add nothing.
//
// BatchNorm sums. Each conv tile reduces its epilogue values per channel
// (its two rows per thread, then a shuffle butterfly over the 8 lanes of a
// column, then the 4 warps in order) into one partial per tile. The block
// that takes the last integer ticket (__threadfence, then atomicAdd on a
// counter in the workspace, which it resets) sums the partials in tile
// order, in double, and writes the statistics: a fixed order, no float
// atomics, the same bits on every run.
#pragma once

#include "coarse_wgmma.cuh"
#include "trunk_conv.cuh"

namespace srgan {
namespace tw {

constexpr int MT = 64;                     // padded positions per M tile / sub-chunk
constexpr int CK = 64;                     // channels per K chunk and per N tile
constexpr int KG = CK / 8;                 // 16-byte k groups per chunk
constexpr int BAND = MT + 2;               // positions per band of a banded window
constexpr int CONV_THREADS = 128;          // one warpgroup
constexpr int WGRAD_THREADS = 384;         // a warpgroup per kernel row (3 taps)
constexpr int W_BYTES = 9 * KG * CK * 16;  // weights of one (N tile, K chunk)
constexpr int MMA_FLOP = 2 * 64 * 64 * 16; // one wgmma m64n64k16

struct Geom {
  int H, W, C, Wp, HWp;
  long long Q;                    // B (H+2)(W+2) padded positions
  int band, nbands, tapstride;    // window: nbands bands of `band` rows
  int rows;
};

__host__ __device__ inline Geom make_geom(int B, int H, int W, int C) {
  Geom g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.Wp = W + 2;
  g.HWp = (H + 2) * (W + 2);
  g.Q = (long long)B * g.HWp;
  const int run = MT + 2 * g.Wp + 2;
  if (run <= 3 * BAND) {
    g.band = run;
    g.nbands = 1;
    g.tapstride = g.Wp;
  } else {
    g.band = BAND;
    g.nbands = 3;
    g.tapstride = BAND;
  }
  g.rows = g.band * g.nbands;
  return g;
}

// position of window row r of the tile at q0
__device__ __forceinline__ long long win_pos(const Geom& g, long long q0, int r) {
  return q0 - g.Wp - 1 + (long long)(r / g.band) * g.Wp + r % g.band;
}

// the NHWC pixel of padded position q, or -1 for padding and outside the
// grid; 32-bit division (the hosts take grids of fewer than 2^31 padded
// positions: `grid_fits`)
__device__ __forceinline__ long long pixel_of(const Geom& g, long long q) {
  if (q < 0 || q >= g.Q) return -1;
  const int qi = (int)q, b = qi / g.HWp;
  const int r = qi - b * g.HWp, y = r / g.Wp, x = r - y * g.Wp;
  if (y < 1 || y > g.H || x < 1 || x > g.W) return -1;
  return ((long long)b * g.H + y - 1) * g.W + x - 1;
}

// whether a B x H x W grid's padded positions (and one M tile past them)
// fit pixel_of's 32-bit arithmetic
__host__ __device__ inline bool grid_fits(int B, int H, int W) {
  return (long long)B * (H + 2) * (W + 2) + MT < 0x7fffffffLL;
}

// D (64 x 64, f32) += A (64 x 16) * B (64 x 16)^T with both operands
// MN-major (transposed) in shared memory
__device__ __forceinline__ void wgmma_bf16_tt(float (&d)[32], uint64_t a, uint64_t b) {
#define SRGAN_R8(i) "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : SRGAN_R8(0), SRGAN_R8(8), SRGAN_R8(16), SRGAN_R8(24)
      : "l"(a), "l"(b), "r"(1));
#undef SRGAN_R8
}

// Programmatic dependent launch: a kernel launched with programmatic stream
// serialization may start while the kernel before it runs; it waits here
// before it reads that kernel's outputs (and everything before it), and
// lets the kernel after it start its own prologue.
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The sums of K quantities per channel over `ntiles` partials
// part[tile][k][C], each in tile order and in double, a thread per (k, c)
// with U loads in flight (the partials were written by other blocks: read
// past L1), staged in `scratch` (K * C floats of shared memory); then
// fn(c, sums) for channels c = tid, tid + blockDim.x, ... The whole block
// calls it. U changes no bit of the sums.
template <int K, int U = 16, typename Fn>
__device__ __forceinline__ void reduce_partials(const float* part, int ntiles, int C,
                                                float* scratch, Fn fn) {
  for (int idx = threadIdx.x; idx < K * C; idx += blockDim.x) {
    const float* src = part + idx;  // [k][c] of tile 0; tiles K * C apart
    double s = 0.0;
    for (int t0 = 0; t0 < ntiles; t0 += U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u] = t0 + u < ntiles ? __ldcg(src + (size_t)(t0 + u) * K * C) : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) s += (double)v[u];
    }
    scratch[idx] = (float)s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float r[K];
#pragma unroll
    for (int k = 0; k < K; ++k) r[k] = scratch[k * C + c];
    fn(c, r);
  }
}

// After this block wrote its partials: true in the one block that takes
// the last of `total` tickets (it then resets the counter).
__device__ __forceinline__ bool last_ticket(unsigned* ticket, unsigned total) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == total - 1;
    if (last) *ticket = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

}  // namespace tw
}  // namespace srgan

// Device code shared by the residual-trunk kernels (csrc/packed_trunk.cu,
// K4/K5; csrc/fused_trunk.cu, K6): the compute-dtype conversions and
// roundings of the Pallas kernels, the BatchNorm moments and forward
// normalize, and the 3x3 SAME conv tile of the f32 paths of K4/K5 and K6
// (their bf16 paths share a wgmma tile, csrc/trunk_conv_tile.cuh).
//
// A conv tile is 64 pixels x 64 output channels of an implicit GEMM over
// the (B*H*W) pixels of an NHWC activation, 9 taps x C input channels
// deep, computed by 4 warps (2 x 2 over the tile) with the warp tile
// products of csrc/tile_mma.cuh. `src` is not __restrict__: K6 reads
// activations that other blocks of the same launch wrote, which the
// non-coherent read-only path must not serve.
#pragma once

#include "tile_mma.cuh"

namespace srgan {

constexpr int TILE = 64;          // conv: pixels and channels per block tile
constexpr int CONV_THREADS = 128; // 4 warps, 2 x 2 over the 64 x 64 tile

// the K chunk of the f32 conv tile (the bf16 paths run the wgmma tile)
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int KC = 16;
};

// padded shared-memory row of one K chunk
template <typename T>
__host__ __device__ constexpr int chunk_stride() {
  return Chunk<T>::KC + 16 / (int)sizeof(T);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// an f32 value rounded to the compute dtype (identity for f32)
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float inv_std(float v, float eps) {
  return 1.0f / sqrtf(__fadd_rn(v, eps));
}

// ((a - mT) * invT) * gT + bT with each step rounded to T; the *T
// arguments are already T values (the Pallas kernels' cdt normalize)
template <typename T>
__device__ __forceinline__ float bn_affine(float a, float mT, float invT, float gT,
                                           float bT) {
  float t = rnd<T>(__fsub_rn(a, mT));
  t = rnd<T>(__fmul_rn(t, invT));
  t = rnd<T>(__fmul_rn(t, gT));
  return rnd<T>(__fadd_rn(t, bT));
}

// The biased f32 batch moments of `nelem` elements from their sums s and
// ss (of a and a^2): m = s / n, v = max(ss / n - m^2, 0).
__device__ __forceinline__ void bn_moments(float s, float ss, float nelem, float* m,
                                           float* v) {
  *m = __fdiv_rn(s, nelem);
  *v = fmaxf(__fsub_rn(__fdiv_rn(ss, nelem), __fmul_rn(*m, *m)), 0.f);
}

// One forward normalize output in T: BN(a) of channel c (mv = [m (C), v
// (C)]), then with PRELU the PReLU of slope alT (a T value, predicate in
// f32), with RESID + the residual r.
template <typename T, bool PRELU, bool RESID>
__device__ __forceinline__ T bn_out(float a, int c, int C, const float* mv, const float* gam,
                                    const float* bet, float eps, float alT, float r) {
  float y = bn_affine<T>(a, rnd<T>(mv[c]), rnd<T>(inv_std(mv[C + c], eps)), rnd<T>(gam[c]),
                         rnd<T>(bet[c]));
  if constexpr (PRELU) {
    if (!(y >= 0.f)) y = rnd<T>(__fmul_rn(alT, y));
  }
  if constexpr (RESID) y = __fadd_rn(r, y);
  return from_f<T>(y);
}

// The f32 accumulators of the conv tile at pixels [p0, p0 + 64) and output
// channels [n0, n0 + 64) of src (P pixels of a B x H x W grid, C channels)
// with wt [tap][out][in]; As, Bs: the block's shared tiles of
// TILE * chunk_stride<T>() elements each. acc[m][n][e] holds, per the
// fragment layout of tile_mma.cuh, pixel p0 + wm + 16 m + g + 8 (e / 2)
// and channel n0 + wn + 8 n + 2 t + e % 2, with wm = 32 (warp / 2),
// wn = 32 (warp % 2), g = lane / 4, t = lane % 4.
template <typename T>
__device__ __forceinline__ void conv_tile(const T* src, const T* __restrict__ wt, int H,
                                          int W, int C, long long P, long long p0, int n0,
                                          T* As, T* Bs, float (&acc)[2][4][4]) {
  constexpr int KC = Chunk<T>::KC;
  constexpr int EPV = 16 / sizeof(T);
  constexpr int KS = chunk_stride<T>();
  constexpr int VPR = KC / EPV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int k0 = 0; k0 < C; k0 += KC) {
      __syncthreads();  // the previous chunk's products are done with smem
      for (int v = tid; v < TILE * VPR; v += CONV_THREADS) {
        const int r = v / VPR, part = v % VPR;
        const long long p = p0 + r;
        T* dst = As + r * KS + part * EPV;
        bool ok = p < P;
        if (ok) {
          const int w = (int)(p % W), h = (int)((p / W) % H);
          ok = h + dy >= 0 && h + dy < H && w + dx >= 0 && w + dx < W;
        }
        if (ok)
          copy16(dst, src + (p + (long long)dy * W + dx) * C + k0 + part * EPV);
        else
          zero16(dst);
      }
      for (int v = tid; v < TILE * VPR; v += CONV_THREADS) {
        const int r = v / VPR, part = v % VPR;
        copy16(Bs + r * KS + part * EPV,
               wt + ((size_t)tap * C + n0 + r) * C + k0 + part * EPV);
      }
      __syncthreads();
      const T* alo[2] = {As + (wm + g) * KS, As + (wm + 16 + g) * KS};
      const T* ahi[2] = {alo[0] + 8 * KS, alo[1] + 8 * KS};
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks)
        warp_k16<2, 4>(acc, alo, ahi, ks * 16, Bs + wn * KS, KS, g, t);
    }
  }
}

}  // namespace srgan

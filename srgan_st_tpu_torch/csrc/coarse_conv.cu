// Coarse reconstruction conv, space-to-depth(2) factored: kernel A.
//
// Replaces the Pallas kernels srgan_st_tpu/kernels/coarse_conv.py `_kernel`
// (one block per batch element, training scale) and `_kernel_tiled` (H-tiled
// with double-buffered halo DMA, serving scale): both compute
//
//   out[b, i, j, (n2, ry, rx)] = sum_{qy, ry', qx} xpad[b, 2(i+qy)+ry', j+qx, :]
//                                . wb[qy, ry', qx, :, (n2, ry, rx)]
//
// where x (B, H, W, C) is viewed as fine rows x coarse columns with K = 2C
// channels in (rx, c) order (a pure view of NHWC memory), padded by two
// fine rows and one coarse column per side, and wb = _w3_blocks(w2) holds
// the 18 (qy, ry, qx) blocks of K x 48. That is the 5x5 SAME conv of the
// coarse kernel w2 followed by space_to_depth(2), as f32.
//
// What bounds it on an H100: at the 4K serving shape (1, 1080, 1920, 256)
// bf16 the input is 1.06 GB against 0.26-0.46 TFLOP of work, so it is
// memory-bound (~0.35 ms at 3.35 TB/s). The design reads each input element
// from device memory about twice (the row halo of a 2-row tile) and keeps
// the rest on chip: one block computes a tile of 2 x 64 quarter-resolution
// outputs; K is walked in chunks of 32 (bf16) or 16 (f32) channels, each
// chunk's halo window (8 fine rows x 66 coarse columns) and its 18 weight
// blocks staged in shared memory, then the 18 taps run as warp tile
// products (tensor-core mma.sync for bf16, f32 accumulators). One CUDA
// kernel with a (W-tile, H-tile, batch) grid covers both Pallas kernels:
// the VMEM envelope that split them on the TPU has no counterpart here.
// Rows of shared memory are padded by 16 bytes so fragment loads are free
// of bank conflicts. Offsets into x and out are 64-bit.
#include "tile_mma.cuh"

using namespace srgan;

namespace {

constexpr int TH = 2;           // quarter-resolution rows per block
constexpr int TW = 64;          // quarter-resolution columns per block
constexpr int NTHREADS = 128;   // 4 warps: warp w -> row w/2, columns 32*(w%2)..+32
constexpr int N3 = 48;          // output channels (n2, ry, rx), n2 = 12
constexpr int NTAP = 18;        // (qy, ry, qx) blocks
constexpr int WR = 2 * TH + 4;  // window fine rows
constexpr int WC = TW + 2;      // window coarse columns

template <typename T>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int KC = 32;
};
template <>
struct Chunk<float> {
  static constexpr int KC = 16;
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    coarse_conv_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                       float* __restrict__ out, int H, int W, int C) {
  constexpr int KC = Chunk<T>::KC;
  constexpr int EPV = 16 / sizeof(T);       // elements per 16-byte vector
  constexpr int KS = KC + EPV;              // padded smem row
  constexpr int VPR = KC / EPV;             // vectors per chunk row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);  // [WR][WC][KS]
  T* wsm = win + WR * WC * KS;              // [NTAP][N3][KS]

  const int hc = H / 2, wc = W / 2, K = 2 * C;
  const int j0 = blockIdx.x * TW, i0 = blockIdx.y * TH, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int il = warp >> 1, jw = (warp & 1) * 32;
  const T* xb = x + (size_t)b * H * wc * K;  // (H, wc, K) view

  float acc[2][6][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 6; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // the previous chunk's products are done with smem
    for (int v = tid; v < WR * WC * VPR; v += NTHREADS) {
      const int pos = v / VPR, part = v % VPR;
      const int fr = pos / WC, cc = pos % WC;
      const int gr = 2 * i0 - 2 + fr, gc = j0 - 1 + cc;
      T* dst = win + pos * KS + part * EPV;
      if (gr >= 0 && gr < H && gc >= 0 && gc < wc)
        copy16(dst, xb + ((size_t)gr * wc + gc) * K + k0 + part * EPV);
      else
        zero16(dst);
    }
    for (int v = tid; v < NTAP * N3 * VPR; v += NTHREADS) {
      const int row = v / VPR, part = v % VPR;
      copy16(wsm + row * KS + part * EPV, wt + (size_t)row * K + k0 + part * EPV);
    }
    __syncthreads();

    for (int tap = 0; tap < NTAP; ++tap) {
      const int qy = tap / 6, ry = (tap / 3) & 1, qx = tap % 3;
      const T* arow = win + ((2 * il + 2 * qy + ry) * WC + jw + qx) * KS;
      const T* alo[2] = {arow + g * KS, arow + (16 + g) * KS};
      const T* ahi[2] = {alo[0] + 8 * KS, alo[1] + 8 * KS};
      const T* brow = wsm + tap * N3 * KS;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks)
        warp_k16<2, 6>(acc, alo, ahi, ks * 16, brow, KS, g, t);
    }
  }

  const int i = i0 + il;
  if (i >= hc) return;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = j0 + jw + m * 16 + g + 8 * half;
      if (j >= wc) continue;
      float* o = out + (((size_t)b * hc + i) * wc + j) * N3 + 2 * t;
#pragma unroll
      for (int n = 0; n < 6; ++n)
        store2(o + n * 8, acc[m][n][2 * half], acc[m][n][2 * half + 1]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* wt, void* out, int B, int H, int W, int C,
           void* stream) {
  constexpr int KC = Chunk<T>::KC;
  constexpr int KS = KC + 16 / sizeof(T);
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || (2 * C) % KC)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(WR * WC + NTAP * N3) * KS * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      coarse_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W / 2 + TW - 1) / TW, (H / 2 + TH - 1) / TH, B);
  coarse_conv_kernel<T><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), static_cast<float*>(out),
      H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, C) NHWC; wt: (18, 48, 2C) [tap][n][k], k in (rx, c) order;
// out: (B, H/2, W/2, 48) f32. Returns the cudaError_t of the launch.
extern "C" int coarse_conv_s2d_bf16(const void* x, const void* wt, void* out, int B,
                                    int H, int W, int C, void* stream) {
  return launch<__nv_bfloat16>(x, wt, out, B, H, W, C, stream);
}

extern "C" int coarse_conv_s2d_f32(const void* x, const void* wt, void* out, int B,
                                   int H, int W, int C, void* stream) {
  return launch<float>(x, wt, out, B, H, W, C, stream);
}

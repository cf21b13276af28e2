// Fused serving tail: kernel B.
//
// Replaces the Pallas kernel srgan_st_tpu/kernels/serving_tail.py `_kernel`:
// the generator's last upsample conv (3x3, 64 -> 256, + bias, + PReLU with
// one shared slope, rounded to the compute dtype) followed by the doubly
// coarse reconstruction conv of kernel A, with the 256-channel pre-shuffle
// activation kept on chip. Output: (B, H/2, W/2, 48) in the compute dtype,
// channel order (n2, ry, rx) as `_coarse_kernel` / `_w3_blocks` define it.
//
// What bounds it on an H100: at the 4K shape (1, 1080, 1920, 64) bf16 the
// work is 0.61 TFLOP (up-conv) + 0.26 TFLOP (the 9x9 64 -> 3 conv it
// computes), against 0.27 GB in and 0.05 GB out: compute-bound (~0.88 ms at
// 989 TFLOP/s). The unfused path writes and reads the 1.06 GB activation;
// here it never reaches device memory.
//
// Design. One block owns a tile of TH x 16 quarter-resolution outputs
// (TH = 4 for bf16, 2 for f32, to fit shared memory at the real element
// size). It stages the input window (2TH+6 fine rows x 38 fine columns x 64
// channels) once, then walks the 256 up-conv channels in chunks:
//   stage 1: the up-conv for the chunk's channels at the (2TH+4) x 36 fine
//            positions stage 2 needs, + bias + PReLU, rounded to the compute
//            dtype, into shared memory. Positions outside the image are
//            ZEROED rather than computed (they are stage 2's SAME padding;
//            bias + PReLU of a zero input is not zero). This is the TPU
//            kernel's row rule, applied to columns too because the tile is
//            two-dimensional here: the W halo at the image edge is zero.
//   stage 2: the 18 (qy, ry, qx) tap products of kernel A over that chunk,
//            accumulated in registers (f32) across chunks.
// Stage-1 positions in a tile's halo are recomputed by its neighbours
// (about 1.7x the up-conv work for bf16); tensor-core mma.sync for bf16,
// FMA for f32, through the shared warp tile products of tile_mma.cuh.
#include "tile_mma.cuh"

using namespace srgan;

namespace {

constexpr int CIN = 64;       // input channels
constexpr int NUP = 256;      // up-conv output channels (pre-shuffle)
constexpr int N3 = 48;        // stage-2 output channels
constexpr int TW = 16;        // quarter-resolution columns per block (one m16 tile)
constexpr int NTHREADS = 256;

template <typename T>
struct Tail;
template <>
struct Tail<__nv_bfloat16> {
  static constexpr int TH = 4;    // quarter-resolution rows per block
  static constexpr int CCW = 16;  // up-conv channels per chunk
};
template <>
struct Tail<float> {
  static constexpr int TH = 2;
  static constexpr int CCW = 8;
};

template <typename T>
struct Layout {
  static constexpr int TH = Tail<T>::TH, CCW = Tail<T>::CCW;
  static constexpr int EPV = 16 / sizeof(T);
  static constexpr int FR = 2 * TH + 4, FC = 2 * TW + 4;  // stage-1 positions
  static constexpr int YR = FR + 2, YC = FC + 2;          // input window
  static constexpr int YKS = CIN + EPV;                   // padded input row
  static constexpr int TC = TW + 2;                       // stage-1 coarse columns
  static constexpr int TKS = 2 * CCW + EPV;               // padded (rx, c) row
  static constexpr int M1T = FR * FC / 16;                // stage-1 m16 tiles
  static constexpr int Y_ELEMS = YR * YC * YKS;
  static constexpr int W1_ELEMS = 9 * CCW * YKS;
  static constexpr int T_ELEMS = FR * TC * TKS;
  static constexpr int W2_ELEMS = 18 * N3 * TKS;
  static constexpr size_t BYTES =
      (size_t)(Y_ELEMS + W1_ELEMS + T_ELEMS + W2_ELEMS) * sizeof(T);
  static_assert(FR * FC % 16 == 0, "stage-1 positions must fill m16 tiles");
  static_assert(2 * TH <= NTHREADS / 32, "one stage-2 work item per warp");
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    serving_tail_kernel(const T* __restrict__ y, const T* __restrict__ w1t,
                        const float* __restrict__ bias_alpha,
                        const T* __restrict__ w2t, T* __restrict__ out, int H,
                        int W) {
  using L = Layout<T>;
  constexpr int TH = L::TH, CCW = L::CCW, EPV = L::EPV;
  constexpr int NT1 = CCW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ywin = reinterpret_cast<T*>(smem_raw);  // [YR][YC][YKS]
  T* w1s = ywin + L::Y_ELEMS;                // [9][CCW][YKS]
  T* tsm = w1s + L::W1_ELEMS;                // [FR][TC][TKS], (rx, c) per column
  T* w2s = tsm + L::T_ELEMS;                 // [18][N3][TKS]

  const int hc = H / 2, wc = W / 2;
  const int j0 = blockIdx.x * TW, i0 = blockIdx.y * TH, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // input window: window row r <-> fine row 2*i0 - 3 + r, column c <-> 2*j0 - 3 + c
  {
    constexpr int VPY = CIN / EPV;
    const T* yb = y + (size_t)b * H * W * CIN;
    for (int v = tid; v < L::YR * L::YC * VPY; v += NTHREADS) {
      const int pos = v / VPY, part = v % VPY;
      const int r = pos / L::YC, c = pos % L::YC;
      const int gr = 2 * i0 - 3 + r, gc = 2 * j0 - 3 + c;
      T* dst = ywin + pos * L::YKS + part * EPV;
      if (gr >= 0 && gr < H && gc >= 0 && gc < W)
        copy16(dst, yb + ((size_t)gr * W + gc) * CIN + part * EPV);
      else
        zero16(dst);
    }
  }
  const float alpha = bias_alpha[NUP];

  // stage-2 work item of this warp: output row s2_il, n-tiles 3*s2_ng..+3
  const bool s2_active = warp < 2 * TH;
  const int s2_il = warp % TH, s2_ng = warp / TH;
  float acc2[1][3][4];
#pragma unroll
  for (int n = 0; n < 3; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[0][n][e] = 0.f;

  for (int c0 = 0; c0 < NUP; c0 += CCW) {
    __syncthreads();  // input window staged; previous chunk done with smem
    {
      constexpr int VPY = CIN / EPV;
      for (int v = tid; v < 9 * CCW * VPY; v += NTHREADS) {
        const int row = v / VPY, part = v % VPY;
        const int tap = row / CCW, n = row % CCW;
        copy16(w1s + row * L::YKS + part * EPV,
               w1t + ((size_t)tap * NUP + c0 + n) * CIN + part * EPV);
      }
      constexpr int VPS = CCW / EPV;  // vectors per (rx) segment
      for (int v = tid; v < 18 * N3 * 2 * VPS; v += NTHREADS) {
        const int row = v / (2 * VPS), rem = v % (2 * VPS);
        const int rx = rem / VPS, part = rem % VPS;
        copy16(w2s + row * L::TKS + rx * CCW + part * EPV,
               w2t + (size_t)row * (2 * NUP) + rx * NUP + c0 + part * EPV);
      }
    }
    __syncthreads();

    // stage 1: position p <-> (fr, fc), fine row 2*i0 - 2 + fr, column 2*j0 - 2 + fc
    for (int m = warp; m < L::M1T; m += NTHREADS / 32) {
      float acc1[1][NT1][4];
#pragma unroll
      for (int n = 0; n < NT1; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[0][n][e] = 0.f;
      const int p0 = m * 16 + g, p1 = p0 + 8;
      const int fr0 = p0 / L::FC, fc0 = p0 % L::FC;
      const int fr1 = p1 / L::FC, fc1 = p1 % L::FC;
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const T* alo[1] = {ywin + ((fr0 + dy) * L::YC + fc0 + dx) * L::YKS};
        const T* ahi[1] = {ywin + ((fr1 + dy) * L::YC + fc1 + dx) * L::YKS};
        const T* bb = w1s + tap * CCW * L::YKS;
#pragma unroll
        for (int ks = 0; ks < CIN / 16; ++ks)
          warp_k16<1, NT1>(acc1, alo, ahi, ks * 16, bb, L::YKS, g, t);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int fr = half ? fr1 : fr0, fc = half ? fc1 : fc0;
        const int gr = 2 * i0 - 2 + fr, gc = 2 * j0 - 2 + fc;
        const bool valid = gr >= 0 && gr < H && gc >= 0 && gc < W;
        T* dst = tsm + (fr * L::TC + (fc >> 1)) * L::TKS + (fc & 1) * CCW;
#pragma unroll
        for (int n = 0; n < NT1; ++n) {
          const int cl = n * 8 + 2 * t;
          float v0 = acc1[0][n][2 * half] + bias_alpha[c0 + cl];
          float v1 = acc1[0][n][2 * half + 1] + bias_alpha[c0 + cl + 1];
          v0 = v0 >= 0.f ? v0 : alpha * v0;
          v1 = v1 >= 0.f ? v1 : alpha * v1;
          store2(dst + cl, valid ? v0 : 0.f, valid ? v1 : 0.f);
        }
      }
    }
    __syncthreads();

    // stage 2: output (i0 + s2_il, j0 + r) reads stage-1 row 2*s2_il + 2qy + ry,
    // coarse column r + qx
    if (s2_active) {
      for (int tap = 0; tap < 18; ++tap) {
        const int qy = tap / 6, ry = (tap / 3) & 1, qx = tap % 3;
        const T* alo[1] = {tsm + ((2 * s2_il + 2 * qy + ry) * L::TC + g + qx) * L::TKS};
        const T* ahi[1] = {alo[0] + 8 * L::TKS};
        const T* bb = w2s + (tap * N3 + s2_ng * 24) * L::TKS;
#pragma unroll
        for (int ks = 0; ks < 2 * CCW / 16; ++ks)
          warp_k16<1, 3>(acc2, alo, ahi, ks * 16, bb, L::TKS, g, t);
      }
    }
  }

  const int i = i0 + s2_il;
  if (!s2_active || i >= hc) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + g + 8 * half;
    if (j >= wc) continue;
    T* o = out + (((size_t)b * hc + i) * wc + j) * N3 + s2_ng * 24 + 2 * t;
#pragma unroll
    for (int n = 0; n < 3; ++n)
      store2(o + n * 8, acc2[0][n][2 * half], acc2[0][n][2 * half + 1]);
  }
}

template <typename T>
int launch(const void* y, const void* w1t, const void* bias_alpha, const void* w2t,
           void* out, int B, int H, int W, void* stream) {
  using L = Layout<T>;
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(serving_tail_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W / 2 + TW - 1) / TW, (H / 2 + L::TH - 1) / L::TH, B);
  serving_tail_kernel<T><<<grid, NTHREADS, L::BYTES, (cudaStream_t)stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(w1t),
      static_cast<const float*>(bias_alpha), static_cast<const T*>(w2t),
      static_cast<T*>(out), H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// y: (B, H, W, 64) NHWC; w1t: (9, 256, 64) [tap][n][c_in]; bias_alpha: 257 f32
// (256 up-conv biases, then the PReLU slope); w2t: (18, 48, 512) [tap][n][k],
// k in (rx, c) order; out: (B, H/2, W/2, 48) in the input's dtype.
extern "C" int serving_tail_bf16(const void* y, const void* w1t, const void* bias_alpha,
                                 const void* w2t, void* out, int B, int H, int W,
                                 void* stream) {
  return launch<__nv_bfloat16>(y, w1t, bias_alpha, w2t, out, B, H, W, stream);
}

extern "C" int serving_tail_f32(const void* y, const void* w1t, const void* bias_alpha,
                                const void* w2t, void* out, int B, int H, int W,
                                void* stream) {
  return launch<float>(y, w1t, bias_alpha, w2t, out, B, H, W, stream);
}

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
// coarse kernel w2 followed by space_to_depth(2), as f32. One CUDA kernel
// with a (W-tile, H-tile, batch) grid covers both Pallas kernels: the VMEM
// envelope that split them on the TPU has no counterpart here.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at the 4K serving shape
// (1, 1080, 1920, 256) bf16 the function reads 1.06 GB and writes 0.10 GB
// f32 for 0.26 TFLOP (the 9x9 64 -> 3 conv): 0.347 ms, bound by bytes.
//
// bf16 design (coarse_conv_wgmma). The s2d factoring itself costs
// 2 * 518,400 * 18 * 512 * 48 = 0.46 TFLOP on the tensor cores (0.46 ms at
// peak), above the byte bound, so the kernel must both stream the input once
// and keep the tensor cores fed:
//   - a block owns 8 quarter rows x 64 quarter columns (512 outputs). Its
//     input window, 20 fine rows x 66 coarse columns, is read once per
//     block: 1.29x the input (the 2-row halo of 16 rows, 2 columns of 64);
//   - K (512) is walked in chunks of 16 through a 3-stage ring in shared
//     memory: the window by 16-byte cp.async with zero fill (the image
//     edge), the chunk's weights (18 x 48 x 16, laid out in the ring's
//     image by the wrapper) by one cp.async.bulk on an mbarrier. Two chunks
//     are in flight while the tensor cores run the current one, and each
//     chunk's products stay in flight while the next chunk's are issued;
//   - the 18 tap products are wgmma m64n64k16, transposed: M = the 48
//     output channels (padded to 64), N = 64 columns, both operands in
//     shared memory. The window is stored [fine row][k group][column][8],
//     so each tap's shifted window is a legal no-swizzle descriptor (a
//     start 16 * qx bytes further): no im2col copy. One weight tile serves
//     the 4 rows of each of the 2 warpgroups (csrc/coarse_wgmma.cuh
//     `coarse_taps`, shared with kernel B's stage 2);
//   - weight traffic: 0.88 MB per block x 1,020 blocks = 0.90 GB, from L2.
// Its own floor at 4K: 1,020 blocks x 32 chunks x 144 wgmma of 131 kFLOP =
// 0.62 TFLOP (the 64/48 padding of M and the half-empty last row tile),
// 0.62 ms at the bf16 peak; it moves ~1.37 GB of input and 0.10 GB of
// output through DRAM (0.44 ms) and 0.90 GB of weights from L2. The f32
// output tile is staged in shared memory and written in coalesced rows.
//
// f32 (coarse_conv_kernel<float>): the SIMT tile code (fmaf through
// tile_mma.cuh), kept for the 1e-4 max|ref| gate that f32 is held to: a
// 2 x 64 tile, K in chunks of 16, staged synchronously.
#include "coarse_wgmma.cuh"
#include "tile_mma.cuh"

using namespace srgan;

namespace {

// ---------------------------------------------------------------- bf16
namespace wg {
constexpr int TH = 8;                 // quarter rows per block
constexpr int TW = 64;                // quarter columns per block (wgmma N)
constexpr int WROWS = 2 * TH + 4;     // window fine rows
constexpr int WCOLS = TW + 2;         // window coarse columns
constexpr int KC = 16;                // K chunk: one k16 step
constexpr int G = KC / 8;             // 16-byte k groups per chunk
constexpr int STAGES = 3;
constexpr int NTHREADS = 256;         // two warpgroups, 4 rows each
constexpr int ROWS = TH / 2;
constexpr int WIN_BYTES = WROWS * G * WCOLS * 16;
constexpr int W_BYTES = 18 * G * hop::N3 * 16;  // one chunk of the weight stream
constexpr size_t SMEM = (size_t)STAGES * (WIN_BYTES + W_BYTES) + 256 + STAGES * 8;
static_assert((size_t)TH * TW * hop::N3 * 4 <= (size_t)STAGES * WIN_BYTES,
              "the output tile reuses the window ring");
}  // namespace wg

__global__ void __launch_bounds__(wg::NTHREADS, 1)
    coarse_conv_wgmma(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ wk, float* __restrict__ out, int H,
                      int W, int C) {
  using namespace wg;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* win = smem;                         // [STAGES][WROWS][G][WCOLS][8]
  unsigned char* wsm = smem + STAGES * WIN_BYTES;    // [STAGES][18][G][48][8]
  uint64_t* bar = reinterpret_cast<uint64_t*>(wsm + STAGES * W_BYTES + 256);

  const int hc = H / 2, wc = W / 2, K = 2 * C, nk = K / KC;
  const int j0 = blockIdx.x * TW, i0 = blockIdx.y * TH, b = blockIdx.z;
  const int tid = threadIdx.x;
  const __nv_bfloat16* xb = x + (size_t)b * H * wc * K;  // (H, wc, K) view

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) hop::mbar_init(&bar[s], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();

  // chunk kc -> stage kc % STAGES: the window (k group fastest, so two
  // threads read one 32-byte sector) and, from thread 0, the weights
  auto load = [&](int kc) {
    const int st = kc % STAGES, k0 = kc * KC;
    unsigned char* dst = win + st * WIN_BYTES;
    for (int v = tid; v < WROWS * WCOLS * G; v += NTHREADS) {
      const int g = v % G, pos = v / G, col = pos % WCOLS, fr = pos / WCOLS;
      const int gr = 2 * i0 - 2 + fr, gc = j0 - 1 + col;
      const bool ok = gr >= 0 && gr < H && gc >= 0 && gc < wc;
      hop::cp_async16(dst + ((fr * G + g) * WCOLS + col) * 16,
                      ok ? xb + ((size_t)gr * wc + gc) * K + k0 + g * 8 : xb, ok);
    }
    if (tid == 0)
      hop::bulk_load(wsm + st * W_BYTES, wk + (size_t)kc * (W_BYTES / 2), W_BYTES, &bar[st]);
  };

  const int wgi = tid / 128;
  const int row0[ROWS] = {ROWS * wgi, ROWS * wgi + 1, ROWS * wgi + 2, ROWS * wgi + 3};
  float acc[ROWS][32];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[r][e] = 0.f;

  load(0);
  hop::cp_async_commit();
  if (nk > 1) load(1);
  hop::cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    const int st = kc % STAGES;
    hop::cp_async_wait<1>();  // this thread's copies of chunk kc have landed
    hop::fence_async_smem();
    hop::mbar_wait(&bar[st], (kc / STAGES) & 1);
    __syncthreads();  // every copy of chunk kc visible
    hop::wg_fence();
    hop::coarse_taps<TW, ROWS, G, WCOLS>(acc, hop::smem_addr(wsm + st * W_BYTES),
                                         hop::smem_addr(win + st * WIN_BYTES), row0, 0, 18);
    hop::wg_commit();
    hop::wg_wait<1>();  // chunk kc - 1's products are done here ...
    __syncthreads();    // ... and in the other warpgroup; chunk kc's run on
    if (kc + 2 < nk) load(kc + 2);  // into the stage chunk kc - 1 used
    hop::cp_async_commit();
  }
  hop::wg_wait<0>();
  __syncthreads();  // the ring is free: stage the f32 tile [TH][TW][48] there

  float* tile = reinterpret_cast<float*>(smem);
  const int warp = (tid & 127) >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int t = 0; t < TW / 8; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 16 * warp + g + 8 * h;
        if (n < hop::N3) {
          const int j = 8 * t + 2 * q;
          tile[(row0[r] * TW + j) * hop::N3 + n] = acc[r][4 * t + 2 * h];
          tile[(row0[r] * TW + j + 1) * hop::N3 + n] = acc[r][4 * t + 2 * h + 1];
        }
      }
  __syncthreads();
  const int nj = min(TW, wc - j0);
  constexpr int V4 = hop::N3 / 4;
  for (int v = tid; v < TH * TW * V4; v += NTHREADS) {
    const int il = v / (TW * V4), rem = v % (TW * V4), j = rem / V4;
    if (i0 + il < hc && j < nj)
      *reinterpret_cast<float4*>(out + (((size_t)b * hc + i0 + il) * wc + j0 + j) * hop::N3 +
                                 (rem % V4) * 4) =
          *reinterpret_cast<const float4*>(tile + (il * TW + j) * hop::N3 + (rem % V4) * 4);
  }
}

int launch_bf16(const void* x, const void* wk, void* out, int B, int H, int W, int C,
                void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || (2 * C) % wg::KC)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      coarse_conv_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wg::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W / 2 + wg::TW - 1) / wg::TW, (H / 2 + wg::TH - 1) / wg::TH, B);
  coarse_conv_wgmma<<<grid, wg::NTHREADS, wg::SMEM, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wk),
      static_cast<float*>(out), H, W, C);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- f32
constexpr int TH = 2;           // quarter-resolution rows per block
constexpr int TW = 64;          // quarter-resolution columns per block
constexpr int NTHREADS = 128;   // 4 warps: warp w -> row w/2, columns 32*(w%2)..+32
constexpr int N3 = 48;          // output channels (n2, ry, rx), n2 = 12
constexpr int NTAP = 18;        // (qy, ry, qx) blocks
constexpr int WR = 2 * TH + 4;  // window fine rows
constexpr int WC = TW + 2;      // window coarse columns
constexpr int KC = 16;          // K chunk

__global__ void __launch_bounds__(NTHREADS)
    coarse_conv_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                       float* __restrict__ out, int H, int W, int C) {
  constexpr int EPV = 4;                    // elements per 16-byte vector
  constexpr int KS = KC + EPV;              // padded smem row
  constexpr int VPR = KC / EPV;             // vectors per chunk row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* win = reinterpret_cast<float*>(smem_raw);  // [WR][WC][KS]
  float* wsm = win + WR * WC * KS;                  // [NTAP][N3][KS]

  const int hc = H / 2, wc = W / 2, K = 2 * C;
  const int j0 = blockIdx.x * TW, i0 = blockIdx.y * TH, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int il = warp >> 1, jw = (warp & 1) * 32;
  const float* xb = x + (size_t)b * H * wc * K;  // (H, wc, K) view

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
      float* dst = win + pos * KS + part * EPV;
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
      const float* arow = win + ((2 * il + 2 * qy + ry) * WC + jw + qx) * KS;
      const float* alo[2] = {arow + g * KS, arow + (16 + g) * KS};
      const float* ahi[2] = {alo[0] + 8 * KS, alo[1] + 8 * KS};
      const float* brow = wsm + tap * N3 * KS;
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

int launch_f32(const void* x, const void* wt, void* out, int B, int H, int W, int C,
               void* stream) {
  constexpr int KS = KC + 4;
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || (2 * C) % KC)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(WR * WC + NTAP * N3) * KS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      coarse_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W / 2 + TW - 1) / TW, (H / 2 + TH - 1) / TH, B);
  coarse_conv_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt), static_cast<float*>(out),
      H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, C) NHWC; out: (B, H/2, W/2, 48) f32. Returns the cudaError_t
// of the launch. bf16: wk is the weight stream (2C/16, 18, 2, 48, 8), chunk
// by chunk in the ring's image (kernels/coarse_conv.py `_stream_weights`);
// f32: wt is (18, 48, 2C) [tap][n][k], k in (rx, c) order.
extern "C" int coarse_conv_s2d_bf16(const void* x, const void* wk, void* out, int B,
                                    int H, int W, int C, void* stream) {
  return launch_bf16(x, wk, out, B, H, W, C, stream);
}

extern "C" int coarse_conv_s2d_f32(const void* x, const void* wt, void* out, int B,
                                   int H, int W, int C, void* stream) {
  return launch_f32(x, wt, out, B, H, W, C, stream);
}

// dynamic shared memory of one block of the bf16 kernel, in bytes
extern "C" int coarse_conv_s2d_bf16_smem() { return (int)wg::SMEM; }

// the MMA work of one bf16 launch in FLOP, counted from the kernel's own
// tiles: per block and K chunk, each warpgroup's rows x 18 taps x KC/16
// wgmma m64nTWk16 (the design's floor, as opposed to the function's work)
extern "C" int coarse_conv_s2d_bf16_mma_flops(int B, int H, int W, int C, double* flops) {
  const double blocks =
      (double)B * ((H / 2 + wg::TH - 1) / wg::TH) * ((W / 2 + wg::TW - 1) / wg::TW);
  *flops = blocks * (2 * C / wg::KC) * (wg::NTHREADS / 128) * wg::ROWS * 18 *
           (wg::KC / 16) * (2.0 * 64 * wg::TW * 16);
  return 0;
}

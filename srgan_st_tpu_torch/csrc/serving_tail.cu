// Fused serving tail: kernel B.
//
// Replaces the Pallas kernel srgan_st_tpu/kernels/serving_tail.py `_kernel`:
// the generator's last upsample conv (3x3, 64 -> 256, + bias, + PReLU with
// one shared slope, rounded to the compute dtype) followed by the doubly
// coarse reconstruction conv of kernel A, with the 256-channel pre-shuffle
// activation kept on chip. Positions outside the image are ZEROED rather
// than computed (they are stage 2's SAME padding; bias + PReLU of a zero
// input is not zero): the TPU kernel's row rule, applied to columns too
// because the tile is two-dimensional here. Output: (B, H/2, W/2, 48) in
// the compute dtype, channel order (n2, ry, rx) as `_coarse_kernel` /
// `_w3_blocks` define it.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at the 4K shape
// (1, 1080, 1920, 64) bf16 the function is 0.61 TFLOP (up-conv) + 0.26
// TFLOP (the 9x9 64 -> 3 conv) against 0.27 GB in and 0.05 GB out:
// 0.879 ms, bound by operations. The unfused path writes and reads the
// 1.06 GB activation; here it never reaches device memory.
//
// bf16 design (serving_tail_wgmma). A block owns 4 quarter rows x 30
// quarter columns; 30 makes its stage-1 positions exactly 64 fine columns,
// one wgmma M tile per fine row. Its input window (14 fine rows x 66 fine
// columns x 64 channels, 118 KB) is read once. The 256 up-conv channels
// are walked in 8 chunks of 32:
//   stage 1: wgmma m64n32k16, M = the 64 fine positions of one of the 12
//            fine rows (6 per warpgroup), N = the chunk's 32 channels, K =
//            64 x 9 taps; each tap's shifted window is a no-swizzle
//            descriptor into the resident input window. The epilogue (f32
//            bias, PReLU, rounding to bf16, zero outside the image) writes
//            the chunk's activation to shared memory as stage 2's operand,
//            [fine row][k group][coarse column][8] with k in (rx, c) order;
//   stage 2: the doubly coarse tap product of kernel A on that chunk
//            (csrc/coarse_wgmma.cuh `coarse_taps`, wgmma m64n32k16, M = the
//            48 outputs padded to 64, N = 32 columns, K = 2 x 32 per tap),
//            accumulated across chunks in registers (2 rows per warpgroup).
// The weights arrive as one stream of 64 units of 18,432 bytes (per chunk:
// w1 for input channels 0-31 and 32-63, then w2 for three taps at a time),
// laid out by the wrapper in the ring's image; thread 0 keeps the next
// units in flight (cp.async.bulk on mbarriers, a 3-slot ring) while the
// tensor cores run the current one, whose products stay in flight while
// the next unit's are issued. Weight traffic: 1.18 MB per block x 4,320
// blocks = 5.1 GB from L2 (the old 16-column tile read 9.6 GB).
// Own floor at 4K: stage 1 computes 12 x 64 fine positions for the 8 x 60 a
// block owns, 1.6x the up-conv (0.98 TFLOP); stage 2 runs 0.64 TFLOP
// (48 of 64 rows, 30 of 32 columns): 1.62 TFLOP, 1.64 ms at the bf16
// peak, against the 0.879 ms bound. What keeps the recompute at 1.6x (the
// 1.25x of an 8 x 32 tile): shared memory. The resident window grows by
// 17 KB per quarter row, and the window, the activation chunk and a
// two-unit-deep weight ring already take 226 KB of the 227 KB.
//
// f32 (serving_tail_kernel<float>): the SIMT tile code through
// tile_mma.cuh, kept for the 1e-4 max|ref| gate f32 is held to.
#include "coarse_wgmma.cuh"
#include "tile_mma.cuh"

using namespace srgan;

namespace {

constexpr int CIN = 64;       // input channels
constexpr int NUP = 256;      // up-conv output channels (pre-shuffle)
constexpr int N3 = 48;        // stage-2 output channels

// ---------------------------------------------------------------- bf16
namespace wg {
constexpr int TH = 4;                  // quarter rows per block
constexpr int TW = 30;                 // quarter columns per block
constexpr int CCW = 32;                // up-conv channels per chunk
constexpr int NCH = NUP / CCW;         // chunks
constexpr int FR = 2 * TH + 4;         // stage-1 fine rows
constexpr int FC = 2 * TW + 4;         // stage-1 fine columns: one M tile
constexpr int YR = FR + 2, YC = FC + 2;  // input window
constexpr int TC = 34;                 // activation coarse columns (32 + 2 read by N = 32)
constexpr int G1 = CIN / 8;            // k groups of the input
constexpr int G2 = 2 * CCW / 8;        // k groups of a chunk's activation
constexpr int UNIT = 18432;            // bytes of one weight unit
constexpr int UNITS = 8;               // per chunk: 2 of w1, 6 of w2
constexpr int NU = NCH * UNITS;
constexpr int NSLOT = 3;
constexpr int NTHREADS = 256;
constexpr int MB = FR / 2;             // stage-1 fine rows per warpgroup
constexpr int ROWS = TH / 2;           // stage-2 output rows per warpgroup
constexpr int Y_BYTES = YR * G1 * YC * 16;
constexpr int T_BYTES = FR * G2 * TC * 16;
constexpr size_t SMEM = (size_t)Y_BYTES + T_BYTES + NSLOT * UNIT + 256 + NSLOT * 8;
static_assert(FC == 64, "one wgmma M tile per stage-1 fine row");
static_assert(9 * (CIN / 2) * CCW * 2 == UNIT && 3 * G2 * N3 * 16 == UNIT,
              "w1 halves and w2 tap triples fill one unit each");
}  // namespace wg

__global__ void __launch_bounds__(wg::NTHREADS, 1)
    serving_tail_wgmma(const __nv_bfloat16* __restrict__ y,
                       const __nv_bfloat16* __restrict__ wstream,
                       const float* __restrict__ bias_alpha, __nv_bfloat16* __restrict__ out,
                       int H, int W) {
  using namespace wg;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ywin = smem;             // [YR][G1][YC][8]
  unsigned char* tsm = ywin + Y_BYTES;    // [FR][G2][TC][8]
  unsigned char* ring = tsm + T_BYTES;    // [NSLOT][UNIT]
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + NSLOT * UNIT + 256);

  const int hc = H / 2, wc = W / 2;
  const int j0 = blockIdx.x * TW, i0 = blockIdx.y * TH, b = blockIdx.z;
  const int tid = threadIdx.x, wgi = tid / 128;
  const int warp = (tid & 127) >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;

  if (tid == 0) {
    for (int s = 0; s < NSLOT; ++s) hop::mbar_init(&bar[s], 1);
    hop::mbar_fence_init();
    for (int u = 0; u < NSLOT; ++u)
      hop::bulk_load(ring + u * UNIT, wstream + (size_t)u * (UNIT / 2), UNIT, &bar[u]);
  }
  // input window: row yr <-> fine row 2*i0 - 3 + yr, column yc <-> 2*j0 - 3 + yc
  {
    const __nv_bfloat16* yb = y + (size_t)b * H * W * CIN;
    for (int v = tid; v < YR * YC * G1; v += NTHREADS) {
      const int gk = v % G1, pos = v / G1, yc = pos % YC, yr = pos / YC;
      const int gr = 2 * i0 - 3 + yr, gc = 2 * j0 - 3 + yc;
      const bool ok = gr >= 0 && gr < H && gc >= 0 && gc < W;
      hop::cp_async16(ywin + ((yr * G1 + gk) * YC + yc) * 16,
                      ok ? yb + ((size_t)gr * W + gc) * CIN + gk * 8 : yb, ok);
    }
    hop::cp_async_commit();
    hop::cp_async_wait<0>();
    hop::fence_async_smem();
  }
  __syncthreads();  // the barriers are initialised and the window is visible
  const float alpha = bias_alpha[NUP];

  // unit u: wait for its bytes; after issuing its products, wait until
  // unit u - 1's are done in both warpgroups (unit u's stay in flight) and
  // refill unit u - 1's slot with unit u + 2
  int u = 0;
  auto unit_begin = [&]() -> uint32_t {
    const int slot = u % NSLOT;
    hop::mbar_wait(&bar[slot], (u / NSLOT) & 1);
    __syncthreads();
    hop::wg_fence();
    return hop::smem_addr(ring + slot * UNIT);
  };
  auto unit_end = [&]() {
    hop::wg_commit();
    hop::wg_wait<1>();
    __syncthreads();
    if (tid == 0 && u >= 1 && u + 2 < NU) {
      const int s2 = (u + 2) % NSLOT;
      hop::bulk_load(ring + s2 * UNIT, wstream + (size_t)(u + 2) * (UNIT / 2), UNIT, &bar[s2]);
    }
    ++u;
  };

  const uint32_t ya = hop::smem_addr(ywin), ta = hop::smem_addr(tsm);
  const int row0[ROWS] = {ROWS * wgi, ROWS * wgi + 1};
  float acc2[ROWS][16];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc2[r][e] = 0.f;

  for (int c = 0; c < NCH; ++c) {
    // stage 1: fine rows MB * wgi .. + MB, the chunk's 32 channels
    float acc1[MB][16];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc1[m][e] = 0.f;
    for (int h = 0; h < 2; ++h) {
      const uint32_t w1 = unit_begin();  // [tap][4 k groups][32 channels][8]
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const uint64_t bd = hop::desc(w1 + (uint32_t)((tap * 4 + 2 * s) * CCW * 16),
                                        CCW * 16, 128);
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            const int fr = MB * wgi + m;
            const uint64_t ad = hop::desc(
                ya + (uint32_t)((((fr + dy) * G1 + 4 * h + 2 * s) * YC + dx) * 16), YC * 16,
                128);
            hop::wgmma_bf16<32>(acc1[m], ad, bd);
          }
        }
      }
      unit_end();
    }
    // epilogue: position (fr, fc) <-> fine (2*i0 - 2 + fr, 2*j0 - 2 + fc);
    // channel cl of the chunk -> k = rx * CCW + cl at coarse column fc / 2.
    // Every product is done (stage 1's, and the last chunk's stage 2, which
    // reads the activation rows the other warpgroup is about to write).
    hop::wg_wait<0>();
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const int fr = MB * wgi + m, gr = 2 * i0 - 2 + fr;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int fc = 16 * warp + g + 8 * hh, gc = 2 * j0 - 2 + fc;
        const bool valid = gr >= 0 && gr < H && gc >= 0 && gc < W;
        __nv_bfloat16* row = reinterpret_cast<__nv_bfloat16*>(tsm) +
                             ((size_t)fr * G2 * TC + (fc >> 1)) * 8;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int cl = 8 * t + 2 * q, k = (fc & 1) * CCW + cl;
          float v0 = acc1[m][4 * t + 2 * hh] + bias_alpha[c * CCW + cl];
          float v1 = acc1[m][4 * t + 2 * hh + 1] + bias_alpha[c * CCW + cl + 1];
          v0 = v0 >= 0.f ? v0 : alpha * v0;
          v1 = v1 >= 0.f ? v1 : alpha * v1;
          store2(row + (k >> 3) * TC * 8 + (k & 7), valid ? v0 : 0.f, valid ? v1 : 0.f);
        }
      }
    }
    hop::fence_async_smem();
    // stage 2: taps (qy, ry, 0..2) of unit 2 + 2 qy + ry
    for (int u2 = 0; u2 < 6; ++u2) {
      const uint32_t w2 = unit_begin();  // [3 taps][G2][48][8]
      hop::coarse_taps<32, ROWS, G2, TC>(acc2, w2, ta, row0, 3 * u2, 3);
      unit_end();
    }
  }

  // acc2[r]: output channel n = 16 warp + g + 8 hh, column j = 8 t + 2 q + e
  hop::wg_wait<0>();
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = i0 + row0[r];
    if (i >= hc) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = 16 * warp + g + 8 * hh;
      if (n >= N3) continue;
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * t + 2 * q + e;
          if (j < TW && j0 + j < wc)
            out[(((size_t)b * hc + i) * wc + j0 + j) * N3 + n] =
                __float2bfloat16_rn(acc2[r][4 * t + 2 * hh + e]);
        }
    }
  }
}

int launch_bf16(const void* y, const void* wstream, const void* bias_alpha, void* out, int B,
                int H, int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      serving_tail_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wg::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W / 2 + wg::TW - 1) / wg::TW, (H / 2 + wg::TH - 1) / wg::TH, B);
  serving_tail_wgmma<<<grid, wg::NTHREADS, wg::SMEM, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(wstream),
      static_cast<const float*>(bias_alpha), static_cast<__nv_bfloat16*>(out), H, W);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- f32
// One block owns a tile of TH x 16 quarter-resolution outputs. It stages the
// input window (2TH+6 fine rows x 38 fine columns x 64 channels) once, then
// walks the 256 up-conv channels in chunks: stage 1 for the chunk's channels
// at the (2TH+4) x 36 fine positions stage 2 needs, into shared memory;
// stage 2 the 18 tap products, accumulated in registers across chunks.
constexpr int TW = 16;        // quarter-resolution columns per block (one m16 tile)
constexpr int NTHREADS = 256;
constexpr int TH = 2;         // quarter-resolution rows per block
constexpr int CCW = 8;        // up-conv channels per chunk
constexpr int EPV = 4;
constexpr int FR = 2 * TH + 4, FC = 2 * TW + 4;  // stage-1 positions
constexpr int YR = FR + 2, YC = FC + 2;          // input window
constexpr int YKS = CIN + EPV;                   // padded input row
constexpr int TC = TW + 2;                       // stage-1 coarse columns
constexpr int TKS = 2 * CCW + EPV;               // padded (rx, c) row
constexpr int M1T = FR * FC / 16;                // stage-1 m16 tiles
constexpr int Y_ELEMS = YR * YC * YKS;
constexpr int W1_ELEMS = 9 * CCW * YKS;
constexpr int T_ELEMS = FR * TC * TKS;
constexpr int W2_ELEMS = 18 * N3 * TKS;
constexpr size_t BYTES = (size_t)(Y_ELEMS + W1_ELEMS + T_ELEMS + W2_ELEMS) * sizeof(float);
static_assert(FR * FC % 16 == 0, "stage-1 positions must fill m16 tiles");
static_assert(2 * TH <= NTHREADS / 32, "one stage-2 work item per warp");

__global__ void __launch_bounds__(NTHREADS)
    serving_tail_kernel(const float* __restrict__ y, const float* __restrict__ w1t,
                        const float* __restrict__ bias_alpha,
                        const float* __restrict__ w2t, float* __restrict__ out, int H,
                        int W) {
  constexpr int NT1 = CCW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ywin = reinterpret_cast<float*>(smem_raw);  // [YR][YC][YKS]
  float* w1s = ywin + Y_ELEMS;                       // [9][CCW][YKS]
  float* tsm = w1s + W1_ELEMS;                       // [FR][TC][TKS], (rx, c) per column
  float* w2s = tsm + T_ELEMS;                        // [18][N3][TKS]

  const int hc = H / 2, wc = W / 2;
  const int j0 = blockIdx.x * TW, i0 = blockIdx.y * TH, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // input window: window row r <-> fine row 2*i0 - 3 + r, column c <-> 2*j0 - 3 + c
  {
    constexpr int VPY = CIN / EPV;
    const float* yb = y + (size_t)b * H * W * CIN;
    for (int v = tid; v < YR * YC * VPY; v += NTHREADS) {
      const int pos = v / VPY, part = v % VPY;
      const int r = pos / YC, c = pos % YC;
      const int gr = 2 * i0 - 3 + r, gc = 2 * j0 - 3 + c;
      float* dst = ywin + pos * YKS + part * EPV;
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
        copy16(w1s + row * YKS + part * EPV,
               w1t + ((size_t)tap * NUP + c0 + n) * CIN + part * EPV);
      }
      constexpr int VPS = CCW / EPV;  // vectors per (rx) segment
      for (int v = tid; v < 18 * N3 * 2 * VPS; v += NTHREADS) {
        const int row = v / (2 * VPS), rem = v % (2 * VPS);
        const int rx = rem / VPS, part = rem % VPS;
        copy16(w2s + row * TKS + rx * CCW + part * EPV,
               w2t + (size_t)row * (2 * NUP) + rx * NUP + c0 + part * EPV);
      }
    }
    __syncthreads();

    // stage 1: position p <-> (fr, fc), fine row 2*i0 - 2 + fr, column 2*j0 - 2 + fc
    for (int m = warp; m < M1T; m += NTHREADS / 32) {
      float acc1[1][NT1][4];
#pragma unroll
      for (int n = 0; n < NT1; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[0][n][e] = 0.f;
      const int p0 = m * 16 + g, p1 = p0 + 8;
      const int fr0 = p0 / FC, fc0 = p0 % FC;
      const int fr1 = p1 / FC, fc1 = p1 % FC;
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const float* alo[1] = {ywin + ((fr0 + dy) * YC + fc0 + dx) * YKS};
        const float* ahi[1] = {ywin + ((fr1 + dy) * YC + fc1 + dx) * YKS};
        const float* bb = w1s + tap * CCW * YKS;
#pragma unroll
        for (int ks = 0; ks < CIN / 16; ++ks)
          warp_k16<1, NT1>(acc1, alo, ahi, ks * 16, bb, YKS, g, t);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int fr = half ? fr1 : fr0, fc = half ? fc1 : fc0;
        const int gr = 2 * i0 - 2 + fr, gc = 2 * j0 - 2 + fc;
        const bool valid = gr >= 0 && gr < H && gc >= 0 && gc < W;
        float* dst = tsm + (fr * TC + (fc >> 1)) * TKS + (fc & 1) * CCW;
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
        const float* alo[1] = {tsm + ((2 * s2_il + 2 * qy + ry) * TC + g + qx) * TKS};
        const float* ahi[1] = {alo[0] + 8 * TKS};
        const float* bb = w2s + (tap * N3 + s2_ng * 24) * TKS;
#pragma unroll
        for (int ks = 0; ks < 2 * CCW / 16; ++ks)
          warp_k16<1, 3>(acc2, alo, ahi, ks * 16, bb, TKS, g, t);
      }
    }
  }

  const int i = i0 + s2_il;
  if (!s2_active || i >= hc) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + g + 8 * half;
    if (j >= wc) continue;
    float* o = out + (((size_t)b * hc + i) * wc + j) * N3 + s2_ng * 24 + 2 * t;
#pragma unroll
    for (int n = 0; n < 3; ++n)
      store2(o + n * 8, acc2[0][n][2 * half], acc2[0][n][2 * half + 1]);
  }
}

int launch_f32(const void* y, const void* w1t, const void* bias_alpha, const void* w2t,
               void* out, int B, int H, int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(serving_tail_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W / 2 + TW - 1) / TW, (H / 2 + TH - 1) / TH, B);
  serving_tail_kernel<<<grid, NTHREADS, BYTES, (cudaStream_t)stream>>>(
      static_cast<const float*>(y), static_cast<const float*>(w1t),
      static_cast<const float*>(bias_alpha), static_cast<const float*>(w2t),
      static_cast<float*>(out), H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// y: (B, H, W, 64) NHWC; bias_alpha: 257 f32 (256 up-conv biases, then the
// PReLU slope); out: (B, H/2, W/2, 48) in the input's dtype. bf16: wstream
// is the weight stream (8 chunks x 8 units x 9,216) of
// kernels/serving_tail.py `_stream_weights`. f32: w1t is (9, 256, 64)
// [tap][n][c_in], w2t (18, 48, 512) [tap][n][k], k in (rx, c) order.
// Returns the cudaError_t of the launch.
extern "C" int serving_tail_bf16(const void* y, const void* wstream, const void* bias_alpha,
                                 void* out, int B, int H, int W, void* stream) {
  return launch_bf16(y, wstream, bias_alpha, out, B, H, W, stream);
}

extern "C" int serving_tail_f32(const void* y, const void* w1t, const void* bias_alpha,
                                const void* w2t, void* out, int B, int H, int W,
                                void* stream) {
  return launch_f32(y, w1t, bias_alpha, w2t, out, B, H, W, stream);
}

// dynamic shared memory of one block of the bf16 kernel, in bytes
extern "C" int serving_tail_bf16_smem() { return (int)wg::SMEM; }

// the MMA work of one bf16 launch in FLOP, counted from the kernel's own
// tiles: per block and chunk, stage 1's FR fine rows x 9 taps x CIN/16
// wgmma m64nCCWk16 and stage 2's TH rows x 18 taps x 2CCW/16 wgmma
// m64n32k16 (the design's floor, as opposed to the function's work)
extern "C" int serving_tail_bf16_mma_flops(int B, int H, int W, double* flops) {
  const double blocks =
      (double)B * ((H / 2 + wg::TH - 1) / wg::TH) * ((W / 2 + wg::TW - 1) / wg::TW);
  *flops = blocks * wg::NCH * 2.0 * 64 * 16 *
           (wg::FR * 9 * (CIN / 16) * wg::CCW + wg::TH * 18 * (2 * wg::CCW / 16) * 32);
  return 0;
}

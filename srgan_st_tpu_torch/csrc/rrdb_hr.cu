// Real-ESRGAN's HR stage in eval: kernel H.
//
// Replaces no TPU kernel: the JAX package has no RRDB generator. The port
// ran the stage after the dense trunk (models/rrdb.py, regions g.upsample
// and g.tail) as torch ops: two nearest x2 copies, four cuDNN convs, each
// with a separate bias pass, three LeakyReLU passes, then the float cast,
// clamp and permute of the output. This kernel computes, from the trunk's
// output feat (B, H, W, 64) NHWC bf16, with lrelu = LeakyReLU(slope):
//
//   u1 = lrelu(conv_up1(nearest2x(feat)) + b)     (B, 2H, 2W, 64) bf16
//   u2 = lrelu(conv_up2(nearest2x(u1)) + b)       (B, 4H, 4W, 64) bf16
//   h  = lrelu(conv_hr(u2) + b)                   (B, 4H, 4W, 64) bf16
//   y  = clamp(conv_last(h) + b, 0, 1)            (B, 4H, 4W, 3) float32
//
// every conv 3x3 SAME, in two host calls: `rrdb_hr_upsample_bf16` (u1 and
// u2) and `rrdb_hr_tail_bf16` (h and y). Each conv accumulates in f32 from
// bf16 operands; the bias, then the LeakyReLU (or conv_last's clamp) run on
// the f32 accumulator, and the result is rounded once: to bf16, or not at
// all for y, written as the float32 frame straight from the accumulator.
//
// The nearest x2 is folded into the read and never stored. Output pixel
// (2y + py, 2x + px) of a nearest x2 followed by a 3x3 conv W is a 2x2 conv
// of the LR input with summed taps: rows {y-1: W[0], y: W[1] + W[2]} for
// py = 0 and {y: W[0] + W[1], y+1: W[2]} for py = 1, columns alike; the
// SAME padding agrees (LR rows -1 and H are the zero rows). The host
// (kernels/rrdb_hr.py `layout`) sums the four phases' 2x2 x 64 x 64 kernels
// in f32 and rounds each once to bf16: K = 256 a phase where the nine taps
// on the upsampled grid have 576.
//
// What bounds it on an H100 at a 960 x 540 frame (benchmark/work_rrdb.py
// `hr_stage`): 1.404 TFLOP as nine-tap convs, 1.42 ms at the bf16 peak;
// 4.94 GB, each conv's input read once before the nearest x2 and its output
// written once, 1.476 ms at 3.35 TB/s. The bytes bound it: u2 and h are
// 1.06 GB each at 4K, written once and read once.
//
// Design: kernel R's conv (csrc/rrdb_dense.cu) with the whole K resident.
// Each map lives in 8 planes of 8 channels over its zero-bordered grid B x
// (H+2) x Wp (16 bytes a pixel, the pixels in order; `padded_width`: the
// stored rows start on 32-byte sectors, so do the stores), so a k group of a
// band row is one contiguous run of its plane, moved by one bulk copy into
// wgmma's no-swizzle K-major layout [k group][pixel][8 channels]; a tap
// (row i, column j) of a tile is then band row r + i moved by j pixels, a
// descriptor offset: no im2col, and no copy of the upsampled grid. A CTA
// (4 warpgroups, one an SM, persistent over a run of steps) loads its
// conv's weights once into shared memory (the four phases' 2x2 taps, 128
// KB; conv_hr's 9 taps, 72 KB; conv_last's, outputs padded to 8, 9 KB),
// then streams the bands of each step (ROWS input rows of one 64-pixel
// column block, with a row above and below) through a ring of S stages
// completing on mbarriers; warp 0 issues the copies of the step S - 1
// ahead. A step's products are m64n64k16 (m64n8k16 for conv_last) with
// M = 64 pixels of a row:
//   up: warpgroup w takes LR row w / 2 and output row parity py = w % 2,
//       its two tiles the column parities px (16 products each);
//   hr: warpgroup w takes row w (36 products);
//   last: warpgroup w takes rows 2w, 2w + 1 (36 products each).
// After a step's products each warpgroup applies its epilogue from the
// accumulator fragments straight to device memory: conv_hr's warp stores
// 8 pixels x 16 bytes of a plane; an up conv's quad holds pixels 2x and 2x
// + 1 in its two tiles and trades values so that a warp stores 256
// contiguous bytes; conv_last's lanes store the frame's three floats a
// pixel. Launches use programmatic dependent launch, as kernel R's; each
// call first zeroes the borders of the maps it writes (and places feat in
// its planes) with one small launch a map.
//
// Measured on one H100 80GB HBM3 at 700 W at (1, 540, 960, 64): 2.93 ms a
// frame (up convs 0.92, conv_hr 1.15, conv_last 0.72, border launches
// 0.07), against 13.8 ms for the torch stage. The loads alone take 1.66
// ms of it (1.6-2.9 TB/s of band rows in 1 KB bulk copies); loading fewer
// bytes did not shorten them (below). Tried and not kept: stores of half sectors (the up
// convs' tiles stored apart, 1.97 ms for the up convs; rows starting 16
// bytes into a sector, conv_hr 1.31 ms); a ring of band rows that loads
// each row once per column walk and prefetches 3 steps ahead (3.16 ms:
// fewer bytes, loads no faster); conv_last's floats gathered by shuffles
// into whole lines (slower); streaming stores and evict-last loads (no
// change).
#include <algorithm>

#include "trunk_wgmma.cuh"

using namespace srgan;

namespace {

using bf16 = __nv_bfloat16;
constexpr int NF = 64;                // channels of every map but the frame
constexpr int NOUT = 8;               // conv_last's outputs, padded to a wgmma width
constexpr int COUT = 3;               // the frame's channels
constexpr int TX = 64;                // pixels of a tile (one row)
constexpr int BAND = TX + 2;          // input pixels of a band row
constexpr int PL = 8;                 // channels of a plane: one 16-byte k group
constexpr int KG = NF / PL;           // k groups (planes) of a map
constexpr int BROW = KG * BAND * 16;  // bytes of one band row, every k group
constexpr int WGS = 4;                // warpgroups a CTA
constexpr int THREADS = 128 * WGS;
constexpr int MAX_ROWS = 8;           // the most input rows a step (conv_last)

enum { M_UP = 0, M_HR = 1, M_LAST = 2 };

// A map's row of W pixels is stored as Wp = padded_width(W) pixels: one
// unused, the zero border x = -1, x = 0 .. W-1, the zero border x = W, and
// one unused where W is odd. Wp is even, so every row and every pixel x of
// an even x starts on a 32-byte sector: a warp's 16-byte-a-pixel stores
// then fill whole sectors.
__host__ __device__ constexpr int padded_width(int W) { return (W + 4) & ~1; }
constexpr int X0 = 2;  // the index in a stored row of pixel x = 0

// a mode's outputs N, input rows a step, ring stages and weight taps
template <int MODE>
struct Cfg {
  static constexpr int N = MODE == M_LAST ? NOUT : NF;
  static constexpr int ROWS = MODE == M_UP ? 2 : MODE == M_HR ? 4 : 8;
  static constexpr int S = MODE == M_HR ? 3 : 2;
  static constexpr int TAPS = MODE == M_UP ? 16 : 9;  // up: [phase py px][row i][column j]
  static constexpr int ACC = MODE == M_HR ? 1 : 2;    // accumulators a thread
  static constexpr int W_BYTES = TAPS * KG * N * 16;  // [tap][k group][out][8 in]
  static constexpr int STAGE = (ROWS + 2) * BROW;
  static constexpr int SMEM = W_BYTES + S * STAGE;
};
static_assert(Cfg<M_UP>::SMEM <= 227 * 1024 - 64, "up: shared memory");
static_assert(Cfg<M_HR>::SMEM <= 227 * 1024 - 64, "hr: shared memory");
static_assert(Cfg<M_LAST>::SMEM <= 227 * 1024 - 64, "last: shared memory");
static_assert(Cfg<M_LAST>::ROWS <= MAX_ROWS && Cfg<M_HR>::ROWS <= MAX_ROWS, "pad rows");

struct Params {
  int B, H, W, Wp;     // the input grid, its stored row
  long long Q;         // pixels of the input's padded grid: a plane
  int Ho, Wo, Wpo;     // the output grid (2H x 2W for an up conv)
  long long Qo;
  int NC, NGY;         // column blocks of TX a row, row groups of ROWS a column
  long long T;         // steps: B * NC * NGY
  const bf16* wimg;    // the conv's weight image
  const float* bias;   // its N biases
  const bf16* src;     // the input map's planes
  void* out;           // the output map's planes (bf16), or the frame (float32 NHWC)
  float slope;
};

// arm `bar` for `bytes` more bytes and arrive on it (one thread)
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   hop::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// copy `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(hop::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(hop::smem_addr(bar))
      : "memory");
}

// D (64 x 8, f32) += A (64 x 16, descriptor) * B (8 x 16, descriptor)^T
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == NOUT)
    wgmma_n8(d, a, b);
  else
    hop::wgmma_bf16<N>(d, a, b);
}

__device__ __forceinline__ float lrelu(float a, float slope) {
  return a >= 0.f ? a : __fmul_rn(slope, a);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) rrdb_hr_conv(const __grid_constant__ Params p) {
  using C = Cfg<MODE>;
  constexpr int N = C::N, ROWS = C::ROWS, S = C::S;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[S];  // a stage's bands have landed
  __shared__ uint64_t wbar;     // the weights have landed
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, gq = lane >> 2, q4 = lane & 3;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) hop::mbar_init(&full[i], 1);
    hop::mbar_init(&wbar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  tw::grid_dep_wait();
  tw::grid_dep_launch();

  // this CTA's run of steps [s0, s0 + units)
  const long long nb = gridDim.x, c = blockIdx.x;
  const long long s0 = c * p.T / nb;
  const int units = (int)((c + 1) * p.T / nb - s0);

  struct Step {
    int b, cb, y0;
  };
  auto step_of = [&](int u) {  // steps number fewer than 2^31 (dims_ok)
    const int st = (int)s0 + u;
    const int col = st / p.NGY;
    Step s;
    s.y0 = (st - col * p.NGY) * ROWS;
    s.cb = col % p.NC;
    s.b = col / p.NC;
    return s;
  };

  // by warp 0: the bulk copies of step u into its stage, the ROWS + 2 band
  // rows y0-1 .. y0+ROWS of pixels x0-1 .. x0+64 (each k group's 66 pixels
  // one contiguous run of its plane; past the grid's last row or column
  // they read what follows, which only masked outputs use)
  auto load = [&](int u) {
    const int st = u % S;
    unsigned char* stage = smem + C::W_BYTES + (size_t)st * C::STAGE;
    const Step s = step_of(u);
    if (lane == 0) mbar_arrive_expect(&full[st], C::STAGE);
    __syncwarp();
    const long long pix0 = ((long long)s.b * (p.H + 2) + s.y0) * p.Wp + s.cb * TX + X0 - 1;
    for (int i = lane; i < (ROWS + 2) * KG; i += 32) {
      const int r = i / KG, kg = i % KG;
      const bf16* src = p.src + ((long long)kg * p.Q + pix0 + (long long)r * p.Wp) * PL;
      bulk_copy(stage + r * BROW + kg * BAND * 16, src, BAND * 16, &full[st]);
    }
  };

  if (tid < 32) {
    // the weights, resident for the launch, in pieces of 4 KB
    constexpr int PIECE = 4096;
    static_assert(C::W_BYTES % 1024 == 0, "weight pieces");
    if (lane == 0) mbar_arrive_expect(&wbar, C::W_BYTES);
    __syncwarp();
    for (int off = lane * PIECE; off < C::W_BYTES; off += 32 * PIECE)
      bulk_copy(smem + off, reinterpret_cast<const unsigned char*>(p.wimg) + off,
                (uint32_t)(C::W_BYTES - off < PIECE ? C::W_BYTES - off : PIECE), &wbar);
    for (int u = 0; u < S - 1 && u < units; ++u) load(u);
  }

  // the operands' descriptors: A at stage 0's first band row, B at the
  // weights; a tap, k step, row or stage is an offset of the start address
  // field (every address stays under 256 KB)
  const uint32_t sbase = hop::smem_addr(smem);
  const uint64_t a0 = hop::desc(sbase + (uint32_t)C::W_BYTES, BAND * 16, 128);
  const uint64_t b0 = hop::desc(sbase, N * 16, 128);
  hop::mbar_wait(&wbar, 0);
  float acc[C::ACC][N / 2];
  for (int u = 0; u < units; ++u) {
    __syncthreads();  // every warpgroup is done with step u - 1: its stage refills
    if (tid < 32 && u + S - 1 < units) load(u + S - 1);
    const Step s = step_of(u);
    hop::mbar_wait(&full[u % S], (uint32_t)(u / S) & 1u);
#pragma unroll
    for (int i = 0; i < C::ACC; ++i)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[i][e] = 0.f;
    const uint64_t so = (uint64_t)((u % S) * C::STAGE) >> 4;
    // A of band row r, pixel shift x, k step kk; B of tap t, k step kk
    auto ad = [&](int r, int x, int kk) {
      return a0 + so + (uint64_t)((r * BROW + (2 * kk * BAND + x) * 16) >> 4);
    };
    auto bd = [&](int t, int kk) { return b0 + (uint64_t)(((t * KG + 2 * kk) * N * 16) >> 4); };
    hop::wg_fence();
    if constexpr (MODE == M_UP) {
      const int lr = wg >> 1, py = wg & 1;
#pragma unroll 1
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int px = 0; px < 2; ++px)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int kk = 0; kk < KG / 2; ++kk)
              mma<N>(acc[px], ad(lr + py + i, px + j, kk), bd(((py * 2 + px) * 2 + i) * 2 + j, kk));
    } else {
#pragma unroll 1
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int kk = 0; kk < KG / 2; ++kk)
#pragma unroll
            for (int rw = 0; rw < C::ACC; ++rw)
              mma<N>(acc[rw], ad(C::ACC * wg + rw + ky, kx, kk), bd(3 * ky + kx, kk));
    }
    hop::wg_commit();
    hop::wg_wait<0>();

    // the step's epilogue: this thread's pixels 16 warp + gq + 8 hh of its
    // tiles and channels 8 t + 2 q4 + e, acc[i][4 t + 2 hh + e]; a warp's
    // stores of a map write whole 32-byte sectors
    if constexpr (MODE == M_UP) {
      // pixels 2x and 2x + 1 of a plane are 32 contiguous bytes, held by a
      // quad in its two tiles: the quad trades values so that lanes q4 < 2
      // store pixel 2x's channels 8 t + 4 q4 .. + 3 and lanes q4 >= 2 pixel
      // 2x + 1's, a warp's store 256 contiguous bytes
      const int y = s.y0 + (wg >> 1), yo = 2 * y + (wg & 1);
      const int half = q4 >> 1, sub = q4 & 1;
      const int src = (lane & ~3) | (2 * sub);
      bf16* dst = static_cast<bf16*>(p.out);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = s.cb * TX + 16 * warp + gq + 8 * hh;
        const long long q = ((long long)s.b * (p.Ho + 2) + yo + 1) * p.Wpo + 2 * x + X0 + half;
#pragma unroll
        for (int t = 0; t < N / 8; ++t) {
          const int ch = 8 * t + 2 * q4;
          const float b0 = __ldg(p.bias + ch), b1 = __ldg(p.bias + ch + 1);
          uint32_t v[2];
#pragma unroll
          for (int px = 0; px < 2; ++px) {
            const __nv_bfloat162 h =
                __floats2bfloat162_rn(lrelu(__fadd_rn(acc[px][4 * t + 2 * hh], b0), p.slope),
                                      lrelu(__fadd_rn(acc[px][4 * t + 2 * hh + 1], b1), p.slope));
            v[px] = *reinterpret_cast<const uint32_t*>(&h);
          }
          const uint32_t a0 = __shfl_sync(0xffffffffu, v[0], src);
          const uint32_t a1 = __shfl_sync(0xffffffffu, v[0], src + 1);
          const uint32_t c0 = __shfl_sync(0xffffffffu, v[1], src);
          const uint32_t c1 = __shfl_sync(0xffffffffu, v[1], src + 1);
          if (y < p.H && x < p.W)
            *reinterpret_cast<uint2*>(dst + ((long long)t * p.Qo + q) * PL + 4 * sub) =
                half ? make_uint2(c0, c1) : make_uint2(a0, a1);
        }
      }
    } else if constexpr (MODE == M_HR) {
      // a warp's store: 8 pixels x 16 bytes of a plane, 128 contiguous bytes
      const int y = s.y0 + wg;
      bf16* dst = static_cast<bf16*>(p.out);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = s.cb * TX + 16 * warp + gq + 8 * hh;
        if (y >= p.H || x >= p.W) continue;
        const long long q = ((long long)s.b * (p.Ho + 2) + y + 1) * p.Wpo + x + X0;
#pragma unroll
        for (int t = 0; t < N / 8; ++t) {
          const int ch = 8 * t + 2 * q4;
          const float v0 = lrelu(__fadd_rn(acc[0][4 * t + 2 * hh], __ldg(p.bias + ch)), p.slope);
          const float v1 =
              lrelu(__fadd_rn(acc[0][4 * t + 2 * hh + 1], __ldg(p.bias + ch + 1)), p.slope);
          *reinterpret_cast<__nv_bfloat162*>(dst + ((long long)t * p.Qo + q) * PL + 2 * q4) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    } else {
      // conv_last: outputs 0..2 of a pixel, held by lanes q4 = 0, 1
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) {
        const int y = s.y0 + C::ACC * wg + i;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = s.cb * TX + 16 * warp + gq + 8 * hh;
          if (y >= p.H || x >= p.W || q4 > 1) continue;
          float* dst = static_cast<float*>(p.out) + (((long long)s.b * p.H + y) * p.W + x) * COUT;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ch = 2 * q4 + e;
            if (ch >= COUT) break;
            const float a = __fadd_rn(acc[i][2 * hh + e], __ldg(p.bias + ch));
            dst[ch] = a < 0.f ? 0.f : (a > 1.f ? 1.f : a);  // a NaN stays NaN, as torch.clamp
          }
        }
      }
    }
  }
}

// Zero every border pixel of a map's 8 planes over the grid B x (H+2) x
// (W+2), and, where x is given, place x (B, H, W, 64) NHWC in the interior:
// 16 bytes (one plane's pixel) a thread
__global__ void rrdb_hr_prep(const bf16* __restrict__ x, bf16* __restrict__ planes, int B,
                             int H, int W) {
  const int Wp = padded_width(W), Wb = W + 2;
  const long long Q = (long long)B * (H + 2) * Wp;
  const long long inner = x != nullptr ? (long long)B * H * W * KG : 0;
  const long long per = 2LL * Wb + 2LL * H;  // border pixels an image
  const long long border = (long long)B * per * KG;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < inner + border;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < inner) {
      const long long px = i / KG;
      const int c = (int)(i % KG);
      const int xx = (int)(px % W);
      const long long r = px / W;
      const int yy = (int)(r % H), b = (int)(r / H);
      const long long q = ((long long)b * (H + 2) + yy + 1) * Wp + xx + X0;
      *reinterpret_cast<uint4*>(planes + (c * Q + q) * PL) =
          *reinterpret_cast<const uint4*>(x + px * NF + PL * c);
      continue;
    }
    const long long j = i - inner;
    const int c = (int)(j % KG);
    const long long e = j / KG;
    const long long r = e % per;
    const int b = (int)(e / per);
    int y, xx;
    if (r < 2 * Wb) {
      y = r < Wb ? -1 : H;
      xx = (int)(r % Wb) - 1;
    } else {
      y = (int)((r - 2 * Wb) >> 1);
      xx = (r & 1) ? W : -1;
    }
    const long long q = ((long long)b * (H + 2) + y + 1) * Wp + xx + X0;
    *reinterpret_cast<uint4*>(planes + (c * Q + q) * PL) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Raise a kernel's dynamic shared memory limit to `bytes`, once per device.
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static size_t done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = bytes;
  return err;
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && count[dev] > 0) return count[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < 64) count[dev] = n;
  return n;
}

// the grids of a conv from the input grid B x H x W (the LR grid of an up conv)
template <int MODE>
Params make_params(int B, int H, int W) {
  constexpr int F = MODE == M_UP ? 2 : 1;
  Params p{};
  p.B = B;
  p.H = H;
  p.W = W;
  p.Wp = padded_width(W);
  p.Q = (long long)B * (H + 2) * p.Wp;
  p.Ho = F * H;
  p.Wo = F * W;
  p.Wpo = padded_width(p.Wo);
  p.Qo = (long long)B * (p.Ho + 2) * p.Wpo;
  p.NC = (W + TX - 1) / TX;
  p.NGY = (H + Cfg<MODE>::ROWS - 1) / Cfg<MODE>::ROWS;
  p.T = (long long)B * p.NC * p.NGY;
  return p;
}

template <int MODE>
cudaError_t launch_conv(int B, int H, int W, const void* wimg, const float* bias,
                        const void* src, void* out, float slope, cudaStream_t s) {
  constexpr int SMEM = Cfg<MODE>::SMEM;
  cudaError_t err = allow_smem<rrdb_hr_conv<MODE>>(SMEM);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  Params p = make_params<MODE>(B, H, W);
  p.wimg = static_cast<const bf16*>(wimg);
  p.bias = bias;
  p.src = static_cast<const bf16*>(src);
  p.out = out;
  p.slope = slope;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)std::min<long long>(sms, p.T));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, rrdb_hr_conv<MODE>, p);
}

cudaError_t prep(const void* x, void* planes, int B, int H, int W, cudaStream_t s) {
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  rrdb_hr_prep<<<2 * sms, 256, 0, s>>>(static_cast<const bf16*>(x), static_cast<bf16*>(planes),
                                       B, H, W);
  return cudaGetLastError();
}

// a call's steps in 32-bit arithmetic, its elements in 64-bit, for the 4x
// grid of an LR frame B x H x W
bool dims_ok(int B, int H, int W) {
  return B > 0 && H > 0 && W > 0 && H < (1 << 27) && W < (1 << 27) &&
         (long long)B * (4LL * H + 2) * (4LL * W + 2) * NF < (1LL << 40) &&
         (long long)B * (4LL * H + 2) * ((4LL * W + TX - 1) / TX) < (1LL << 30);
}

}  // namespace

// the bf16 elements of one map's planes over the grid B x H x W: 8 planes
// of the padded grid, and after them the pixels that the last row group's
// bands read past its end
extern "C" int rrdb_hr_planes(int B, int H, int W, long long* elems) {
  if (B <= 0 || H <= 0 || W <= 0 || !dims_ok(B, (H + 3) / 4, (W + 3) / 4))
    return (int)cudaErrorInvalidValue;
  const long long Wp = padded_width(W), Q = (long long)B * (H + 2) * Wp;
  *elems = (KG * Q + (MAX_ROWS + 2) * Wp + 2 * BAND) * PL;
  return 0;
}

// the largest dynamic shared memory of the three conv shapes
extern "C" int rrdb_hr_smem() {
  return std::max(Cfg<M_UP>::SMEM, std::max(Cfg<M_HR>::SMEM, Cfg<M_LAST>::SMEM));
}

// Call 1, the `g.upsample` region: x (B, H, W, 64) bf16 NHWC, the trunk's
// output; w_up1, w_up2 the up convs' phase images (kernels/rrdb_hr.py
// `layout`), bias the stage's f32 biases [up1 64][up2 64][hr 64][last 8];
// lr, mid, up the planes (`rrdb_hr_planes`) of the B x H x W, 2H x 2W and
// 4H x 4W grids, of any contents. Writes u2 into `up`: 5 launches.
extern "C" int rrdb_hr_upsample_bf16(const void* x, const void* w_up1, const void* w_up2,
                                     const void* bias, void* lr, void* mid, void* up, int B,
                                     int H, int W, float slope, void* stream) {
  if (!dims_ok(B, H, W)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  cudaError_t err = prep(x, lr, B, H, W, s);
  if (err == cudaSuccess) err = prep(nullptr, mid, B, 2 * H, 2 * W, s);
  if (err == cudaSuccess) err = prep(nullptr, up, B, 4 * H, 4 * W, s);
  if (err == cudaSuccess) err = launch_conv<M_UP>(B, H, W, w_up1, b, lr, mid, slope, s);
  if (err == cudaSuccess)
    err = launch_conv<M_UP>(B, 2 * H, 2 * W, w_up2, b + NF, mid, up, slope, s);
  return (int)err;
}

// Call 2, the `g.tail` region: up the planes of u2 over the 4x grid B x H4
// x W4; w_hr, w_last conv_hr's and conv_last's images, bias as above; hr
// the planes of that grid, of any contents. Writes the frame y (B, H4, W4,
// 3) float32 NHWC: 3 launches.
extern "C" int rrdb_hr_tail_bf16(const void* up, const void* w_hr, const void* w_last,
                                 const void* bias, void* hr, void* y, int B, int H4, int W4,
                                 float slope, void* stream) {
  if (H4 % 4 || W4 % 4 || !dims_ok(B, H4 / 4, W4 / 4)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  cudaError_t err = prep(nullptr, hr, B, H4, W4, s);
  if (err == cudaSuccess) err = launch_conv<M_HR>(B, H4, W4, w_hr, b + 2 * NF, up, hr, slope, s);
  if (err == cudaSuccess)
    err = launch_conv<M_LAST>(B, H4, W4, w_last, b + 3 * NF, hr, y, slope, s);
  return (int)err;
}

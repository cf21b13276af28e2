// Real-ESRGAN's dense trunk in eval: kernel R.
//
// Replaces no TPU kernel: the JAX package has no RRDB generator. The port
// ran each residual dense block (models/rrdb.py) as five cuDNN convs, each
// on a `torch.cat` copy of every feature before it, with separate passes
// for the bias, the LeakyReLU and both 0.2-scaled residuals. This kernel
// runs the dense blocks of the generator's `g.trunk` region, n RRDBs of
// three blocks each (nf = 64, growth gc = 32):
//
//   x_k = lrelu(c_k([x, x_1 .. x_{k-1}]) + b_k),  k = 1..4 (32 outputs)
//   block(x) = x + s (c_5([x, x_1 .. x_4]) + b_5)        (64 outputs)
//   RRDB(x)  = x + s block3(block2(block1(x)))
//
// in 5 launches a dense block of one 3x3 bf16 conv (`rrdb_dense_conv`),
// plus one launch that places the input and zeroes the buffers' borders.
// Each dense block keeps its features in one zero-bordered buffer of the
// padded grid B x (H+2) x (W+2) and 192 channels: channels 0..63 hold x,
// channels 64 + 32 (k-1) .. 64 + 32 k - 1 hold x_k. Conv k reads the
// channel prefix [0, 64 + 32 (k-1)) in place and writes its own slice:
// nothing is concatenated. c5 writes channels 0..63 of the next block's
// buffer. The buffer is stored in planes of 8 channels (16 bytes a pixel,
// the grid's pixels in order): a k group of a band is then one contiguous
// run of its plane, which one bulk copy moves into the wgmma operand's
// layout. The epilogue runs in f32 on the f32 accumulator: the bias, then
// the LeakyReLU (c1..c4), or the residual x + s (acc + b) (c5 of a first
// or second block) or x_rrdb + s (x + s (acc + b)) (c5 of a third block,
// x_rrdb the RRDB's input, kept in the first block's buffer), and rounds
// once to bf16. Three buffers take the three blocks of an RRDB in turn, so
// the RRDB's input survives until its third block; that block's c5 writes
// the next RRDB's input over it in place (each element is read before the
// thread that reads it writes it, and no band of that launch reads the
// first buffer). The last block writes y unpadded. The bias, the
// LeakyReLU slope and the residual scale are taken in f32.
//
// What bounds it on an H100: at a 960 x 540 frame one dense block is
// 248.4 GFLOP (0.251 ms at the bf16 peak): 17.13 TFLOP for the 23 RRDBs,
// 17.33 ms (17.37 with conv_body). Each conv that reads its prefix from
// device memory once and writes its output once moves 1,664 bytes a pixel
// over a block's five convs: 69 x 518,400 x 1,664 = 59.5 GB a frame, 17.8
// ms at 3.35 TB/s. So a conv-by-conv design is bound by both, about
// equally; c1..c4 (32 outputs, K = 576..1,440) sit at the ridge, c5 (64
// outputs, K = 1,728) above it.
//
// Design. A step of a CTA is R = 4 RW output rows of one 64-pixel column
// block; warpgroup w takes rows w RW .. w RW + RW - 1, each a wgmma tile
// of M = 64 pixels and N = the conv's outputs (m64n32k16 for c1..c4 with
// R = 8, m64n64k16 for c5 with R = 4). K runs in chunks of 32 channels: a
// unit of work is (step, chunk), and for each unit warp 0 issues the bulk
// copies of the R + 2 bands (the 66 input pixels x0-1 .. x0+64 of rows
// y0-1 .. y0+R) of the chunk's four planes and of the chunk's weights (9
// taps x 32 channels x N) into one stage of an S-stage ring, completing on
// the stage's mbarrier: the next S-1 units load while one is computed, and
// a CTA barrier a unit frees the stage of the unit before. Bands are
// stored as wgmma's no-swizzle K-major operand [k group][pixel][8
// channels], so tap (ky, kx) of output row i is band row i + ky moved by
// kx pixels, a descriptor offset (csrc/coarse_wgmma.cuh): no im2col copy.
// The weights (c5's are 221 KB) do not stay resident: each chunk's slice
// streams through the ring from L2 and serves the R tiles of the step. The
// buffers' zero border is the 3x3 SAME padding, so a band needs no mask;
// past the grid's last row a band reads what follows (the workspace is
// padded), which only masked outputs use. After a step's last chunk each
// warpgroup applies its epilogue from the accumulator fragments straight
// to device memory (a warp's store covers 8 pixels x 16 bytes of a plane),
// c5's residuals loaded into registers before its last products. Launches
// use programmatic dependent launch: a conv's CTAs start as the conv
// before it drains, and wait for it before reading its output.
//
// Measured on one H100 80GB HBM3 at 700 W (chip_smoke.py) at (1, 540,
// 960, 64): the 23 RRDBs in 44.5 ms a call, 39% of their 17.33 ms bound,
// against 146.3 ms for the cuDNN blocks on `torch.cat`; one RRDB 2.15 ms.
// Of a frame's 44 ms, c1..c4 take ~30 and c5 ~18 (summed spans; launches
// overlap). A CTA-wide barrier a unit, with the next units' copies in
// flight, measured faster than per-warpgroup release barriers, and one CTA
// of 4 warpgroups an SM faster than two of 2. Loading the same bands with
// cp.async from pixel-major 192-channel buffers, 16 bytes a thread, held
// the loads near 1.8 TB/s: 66 ms a call. The c1..c4 products read 3 KB of
// shared memory for each 64 x 32 x 16 product, which bounds them at ~2/3
// of the tensor peak.
#include <algorithm>

#include "trunk_wgmma.cuh"

using namespace srgan;

namespace {

using bf16 = __nv_bfloat16;
constexpr int NF = 64;                // the block's width: x and c5's outputs
constexpr int GC = 32;                // the growth: c1..c4's outputs
constexpr int CB = NF + 4 * GC;       // channels of a block's buffer (192)
constexpr int TX = 64;                // output pixels of a tile (one row)
constexpr int BAND = TX + 2;          // input pixels of a band
constexpr int CH = 32;                // channels of a K chunk
constexpr int PL = 8;                 // channels of a plane: one 16-byte k group
constexpr int KGC = CH / PL;          // k groups (planes) of a chunk
constexpr int BROW = KGC * BAND * 16; // bytes of one band row of one chunk
constexpr int WGS = 4;                // warpgroups a CTA
constexpr int THREADS = 128 * WGS;
// elements of one block's weight images and biases, and each conv's offset
constexpr int BLOCK_W = 9 * (NF * GC + (NF + GC) * GC + (NF + 2 * GC) * GC +
                             (NF + 3 * GC) * GC + CB * NF);
constexpr int BLOCK_B = 4 * GC + NF;
enum { EP_LRELU = 0, EP_RESID = 1 };

__host__ __device__ constexpr int conv_in(int k) { return k < 5 ? NF + (k - 1) * GC : CB; }
__host__ __device__ constexpr int conv_out(int k) { return k < 5 ? GC : NF; }
__host__ __device__ constexpr int w_offset(int k) {
  int o = 0;
  for (int i = 1; i < k; ++i) o += 9 * conv_in(i) * conv_out(i);
  return o;
}
static_assert(w_offset(6) == BLOCK_W, "one block's weights");

// the geometry of a conv launch with N outputs, RW rows a warpgroup and S stages
template <int N, int RW, int S>
struct Geo {
  static constexpr int R = WGS * RW;                 // output rows of a step
  static constexpr int BAND_BYTES = (R + 2) * BROW;  // a chunk's bands
  static constexpr int W_BYTES = 9 * KGC * N * 16;   // a chunk's weights
  static constexpr int STAGE = BAND_BYTES + W_BYTES;
  static constexpr int SMEM = S * STAGE;
};

struct ConvParams {
  int B, H, W, Wp;
  long long Q;          // pixels of a padded grid, B (H+2) (W+2), a plane
  int NC, NGY;          // column blocks of TX a row, row groups of R a column
  long long T;          // steps: B * NC * NGY
  int nchunk;           // the conv's input channels / CH
  const bf16* wimg;     // [chunk][tap][k group][N out][8 in]
  const float* bias;    // [N]
  const bf16* src;      // the block's buffer (CB / PL planes of a padded grid)
  const bf16* resid;    // EP_RESID: x, channels 0..63 of src
  const bf16* resid2;   // EP_RESID of a third block: x_rrdb (a buffer's channels 0..63), or null
  bf16* out;            // a buffer, or (the last block) unpadded NHWC of NF channels
  int out_c0;           // the buffer's channel of output 0
  int out_padded;       // the output a buffer, or unpadded NHWC
  float slope, scale;   // the LeakyReLU slope, the residual scale
};

// pixel (b, y, x) of a padded grid (y in -1..H, x in -1..W)
__device__ __forceinline__ long long padded(const ConvParams& p, int b, int y, int x) {
  return ((long long)b * (p.H + 2) + y + 1) * p.Wp + x + 1;
}

// the element of channel ch at padded pixel pix of a buffer: plane ch / PL
__device__ __forceinline__ long long at_buf(const ConvParams& p, long long pix, int ch) {
  return ((long long)(ch / PL) * p.Q + pix) * PL + ch % PL;
}

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

template <int N, int RW, int S, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    rrdb_dense_conv(const __grid_constant__ ConvParams p) {
  using G = Geo<N, RW, S>;
  constexpr int R = G::R;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[S];  // a stage's bands and weights have landed
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, gq = lane >> 2, q4 = lane & 3;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) hop::mbar_init(&full[i], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  tw::grid_dep_wait();
  tw::grid_dep_launch();

  // this CTA's run of steps [s0, s0 + count), each of nchunk units
  const long long nb = gridDim.x, c = blockIdx.x;
  const long long s0 = c * p.T / nb;
  const int units = (int)((c + 1) * p.T / nb - s0) * p.nchunk;

  struct Step {
    int b, cb, y0;
  };
  auto step_of = [&](int u) {  // steps number fewer than 2^31 (dims_ok)
    const int st = (int)s0 + u / p.nchunk;
    const int col = st / p.NGY;
    Step s;
    s.y0 = (st - col * p.NGY) * R;
    s.cb = col % p.NC;
    s.b = col / p.NC;
    return s;
  };

  // by warp 0: the bulk copies of unit u into its stage, the R + 2 bands of
  // chunk g (rows y0-1 .. y0+R, pixels x0-1 .. x0+64: each k group's 66
  // pixels one contiguous run of its plane; past the grid's last row they
  // read what follows, which only masked outputs use), then the chunk's
  // weights, all completing on the stage's barrier
  auto load = [&](int u) {
    const int st = u % S;
    unsigned char* stage = smem + (size_t)st * G::STAGE;
    const Step s = step_of(u);
    const int g = u % p.nchunk;
    if (lane == 0) mbar_arrive_expect(&full[st], G::STAGE);
    __syncwarp();
    const long long pix0 = padded(p, s.b, s.y0 - 1, s.cb * TX - 1);
    for (int i = lane; i < (R + 2) * KGC; i += 32) {
      const int r = i / KGC, kg = i % KGC;
      const bf16* src = p.src + ((long long)(g * KGC + kg) * p.Q + pix0 + (long long)r * p.Wp) * PL;
      bulk_copy(stage + r * BROW + kg * BAND * 16, src, BAND * 16, &full[st]);
    }
    if (lane == 0)
      bulk_copy(stage + G::BAND_BYTES,
                reinterpret_cast<const unsigned char*>(p.wimg) + (size_t)g * G::W_BYTES,
                G::W_BYTES, &full[st]);
  };

  if (tid < 32)
    for (int u = 0; u < S - 1 && u < units; ++u) load(u);

  // the operands' descriptors in stage 0; a tap, k step or stage is an
  // offset of the start address field (every address stays under 256 KB)
  const uint32_t sbase = hop::smem_addr(smem);
  const uint64_t a0 = hop::desc(sbase + (uint32_t)(wg * RW * BROW), BAND * 16, 128);
  const uint64_t b0 = hop::desc(sbase + (uint32_t)G::BAND_BYTES, N * 16, 128);
  const bf16* __restrict__ rs1 = p.resid;
  const bf16* __restrict__ rs2 = p.resid2;
  bf16* __restrict__ dst = p.out;
  float acc[RW][N / 2];
  for (int u = 0; u < units; ++u) {
    __syncthreads();  // every warpgroup is done with unit u - 1: its stage refills
    if (tid < 32 && u + S - 1 < units) load(u + S - 1);
    const int g = u % p.nchunk;
    const bool last = g == p.nchunk - 1;
    const Step s = last ? step_of(u) : Step{};
    // c5: the residuals of this thread's outputs, loaded while the step's
    // last products run (a third block's c5 writes over x_rrdb: each
    // element is read before this thread writes it)
    __nv_bfloat162 r1[RW][2][N / 8], r2[RW][2][N / 8];
    if constexpr (EPI == EP_RESID) {
      if (last) {
#pragma unroll
        for (int rw = 0; rw < RW; ++rw)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int y = s.y0 + wg * RW + rw, x = s.cb * TX + 16 * warp + gq + 8 * hh;
            if (y >= p.H || x >= p.W) continue;
            const long long q = padded(p, s.b, y, x);
#pragma unroll
            for (int t = 0; t < N / 8; ++t)
              r1[rw][hh][t] =
                  *reinterpret_cast<const __nv_bfloat162*>(rs1 + at_buf(p, q, 8 * t + 2 * q4));
            if (rs2 != nullptr) {
#pragma unroll
              for (int t = 0; t < N / 8; ++t)
                r2[rw][hh][t] =
                    *reinterpret_cast<const __nv_bfloat162*>(rs2 + at_buf(p, q, 8 * t + 2 * q4));
            }
          }
      }
    }
    hop::mbar_wait(&full[u % S], (uint32_t)(u / S) & 1u);

    if (g == 0) {
#pragma unroll
      for (int rw = 0; rw < RW; ++rw)
#pragma unroll
        for (int e = 0; e < N / 2; ++e) acc[rw][e] = 0.f;
    }
    const uint64_t so = (uint64_t)((u % S) * G::STAGE) >> 4;
    hop::wg_fence();
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int kk = 0; kk < KGC / 2; ++kk) {
          const uint64_t bd = b0 + so + (((3 * ky + kx) * KGC + 2 * kk) * N * 16 >> 4);
#pragma unroll
          for (int rw = 0; rw < RW; ++rw)
            hop::wgmma_bf16<N>(
                acc[rw], a0 + so + (((rw + ky) * BROW + (2 * kk * BAND + kx) * 16) >> 4), bd);
        }
    hop::wg_commit();
    hop::wg_wait<0>();
    if (!last) continue;

    // the step's epilogue: this thread's pixels 16 warp + gq + 8 hh and
    // channels 8 t + 2 q4 + e, acc[rw][4 t + 2 hh + e]
#pragma unroll
    for (int rw = 0; rw < RW; ++rw) {
      const int y = s.y0 + wg * RW + rw;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = s.cb * TX + 16 * warp + gq + 8 * hh;
        if (y >= p.H || x >= p.W) continue;
        const long long q = padded(p, s.b, y, x);
#pragma unroll
        for (int t = 0; t < N / 8; ++t) {
          const int ch = 8 * t + 2 * q4;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float a = __fadd_rn(acc[rw][4 * t + 2 * hh + e], __ldg(p.bias + ch + e));
            if constexpr (EPI == EP_LRELU) {
              if (!(a >= 0.f)) a = __fmul_rn(p.slope, a);
            } else {
              const float2 rf = __bfloat1622float2(r1[rw][hh][t]);
              a = __fadd_rn(e ? rf.y : rf.x, __fmul_rn(p.scale, a));
              if (rs2 != nullptr) {
                const float2 qf = __bfloat1622float2(r2[rw][hh][t]);
                a = __fadd_rn(e ? qf.y : qf.x, __fmul_rn(p.scale, a));
              }
            }
            v[e] = a;
          }
          const long long o = p.out_padded ? at_buf(p, q, p.out_c0 + ch)
                                           : (((long long)s.b * p.H + y) * p.W + x) * NF + ch;
          *reinterpret_cast<__nv_bfloat162*>(dst + o) = __floats2bfloat162_rn(v[0], v[1]);
        }
      }
    }
  }
}

// x (B, H, W, 64) into channels 0..63 (planes 0..7) of the first
// buffer's interior, and every border pixel of the three buffers' planes
// zeroed: 16 bytes (one plane's pixel) a thread
__global__ void rrdb_dense_prep(const bf16* __restrict__ x, bf16* __restrict__ bufs, int B,
                                int H, int W) {
  const int Wp = W + 2;
  const long long Q = (long long)B * (H + 2) * Wp;
  const long long inner = (long long)B * H * W * (NF / PL);
  const long long per = 2LL * Wp + 2LL * H;  // border pixels an image
  const long long border = 3LL * B * per * (CB / PL);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < inner + border;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < inner) {
      const long long px = i / (NF / PL);
      const int c = (int)(i % (NF / PL));
      const int xx = (int)(px % W);
      const long long r = px / W;
      const int yy = (int)(r % H), b = (int)(r / H);
      const long long q = ((long long)b * (H + 2) + yy + 1) * Wp + xx + 1;
      *reinterpret_cast<uint4*>(bufs + (c * Q + q) * PL) =
          *reinterpret_cast<const uint4*>(x + px * NF + PL * c);
      continue;
    }
    const long long j = i - inner;
    const int c = (int)(j % (CB / PL));
    const long long e = j / (CB / PL);
    const long long r = e % per, bi = e / per;
    const int buf = (int)(bi / B), b = (int)(bi % B);
    int y, xx;
    if (r < 2 * Wp) {
      y = r < Wp ? -1 : H;
      xx = (int)(r % Wp) - 1;
    } else {
      y = (int)((r - 2 * Wp) >> 1);
      xx = (r & 1) ? W : -1;
    }
    const long long q = ((long long)b * (H + 2) + y + 1) * Wp + xx + 1;
    const long long plane = (long long)buf * (CB / PL) + c;
    *reinterpret_cast<uint4*>(bufs + (plane * Q + q) * PL) = make_uint4(0u, 0u, 0u, 0u);
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

// the two launch shapes: c1..c4 (N = 32) and c5 (N = 64)
// c1..c4: 8 rows a step, 3 stages of 60.7 KB; c5: 4 rows a step (its
// residuals held in registers over the last unit), 3 stages of 62.2 KB
constexpr int RW_GROW = 2, S_GROW = 3;
constexpr int RW_OUT = 1, S_OUT = 3;
using GeoGrow = Geo<GC, RW_GROW, S_GROW>;
using GeoOut = Geo<NF, RW_OUT, S_OUT>;

template <int R>
ConvParams make_params(int B, int H, int W) {
  ConvParams p{};
  p.B = B;
  p.H = H;
  p.W = W;
  p.Wp = W + 2;
  p.Q = (long long)B * (H + 2) * p.Wp;
  p.NC = (W + TX - 1) / TX;
  p.NGY = (H + R - 1) / R;
  p.T = (long long)B * p.NC * p.NGY;
  return p;
}

template <int N, int RW, int S, int EPI>
cudaError_t launch_conv(const ConvParams& p, cudaStream_t s) {
  constexpr int SMEM = Geo<N, RW, S>::SMEM;
  cudaError_t err = allow_smem<rrdb_dense_conv<N, RW, S, EPI>>(SMEM);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
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
  return cudaLaunchKernelEx(&cfg, rrdb_dense_conv<N, RW, S, EPI>, p);
}

// a call's steps, pixels and planes in 32-bit step and 64-bit element arithmetic
bool dims_ok(int nb, int B, int H, int W) {
  return nb > 0 && B > 0 && H > 0 && W > 0 &&
         (long long)B * (H + 2) * (W + 2) * CB < (1LL << 40);
}

}  // namespace

// The wgmma work of one call in FLOP, from the kernel's own tiles (the
// design's floor): per conv, every step's R tiles (64 columns of a row,
// the last column block and row group padded) x 9 taps x K / 16 products.
extern "C" int rrdb_dense_bf16_mma_flops(int nb, int B, int H, int W, double* flops) {
  if (!dims_ok(nb, B, H, W)) return (int)cudaErrorInvalidValue;
  const double grow = (double)make_params<GeoGrow::R>(B, H, W).T * GeoGrow::R;
  const double outs = (double)make_params<GeoOut::R>(B, H, W).T * GeoOut::R;
  double per = 0;
  for (int k = 1; k <= 5; ++k)
    per += (k < 5 ? grow : outs) * 9 * (conv_in(k) / 16) * 2.0 * 64 * conv_out(k) * 16;
  *flops = 3.0 * nb * per;
  return 0;
}

// the bf16 elements of the workspace of a call: three buffers of CB / PL
// planes of a padded grid, and after them the pixels that the last row
// group's bands read past the grid's end
extern "C" int rrdb_dense_workspace(int B, int H, int W, long long* elems) {
  if (!dims_ok(1, B, H, W)) return (int)cudaErrorInvalidValue;
  const long long Wp = W + 2, Q = (long long)B * (H + 2) * Wp;
  const long long pad = (std::max(GeoGrow::R, GeoOut::R) + 2) * Wp + 2 * BAND;
  *elems = (3 * (CB / PL) * Q + pad) * PL;
  return 0;
}

// the larger dynamic shared memory of the two conv shapes (any shape)
extern "C" int rrdb_dense_smem() { return std::max(GeoGrow::SMEM, GeoOut::SMEM); }

// x (B, H, W, 64) bf16: the stem output, the trunk's input; wimg the 3 nb
// dense blocks' weight images, BLOCK_W bf16 each (kernels/rrdb_dense.py
// `layout`: c1..c5 in order, each [chunk][tap][k group][out][8 in]); bias
// the blocks' f32 biases, BLOCK_B each (b1..b5); bufs three B x (H+2) x
// (W+2) x 192 bf16 buffers of any contents, one after the other. Writes y
// (B, H, W, 64) bf16, the last RRDB's output: 1 + 15 nb launches.
extern "C" int rrdb_dense_bf16(const void* x, const void* wimg, const void* bias, void* y,
                               void* bufs, int nb, int B, int H, int W, float slope,
                               float scale, void* stream) {
  if (!dims_ok(nb, B, H, W)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long Q = (long long)B * (H + 2) * (W + 2);
  bf16* buf[3];
  for (int i = 0; i < 3; ++i) buf[i] = static_cast<bf16*>(bufs) + i * Q * CB;  // CB / PL planes
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  rrdb_dense_prep<<<4 * sms, 256, 0, s>>>(static_cast<const bf16*>(x), buf[0], B, H, W);
  cudaError_t err = cudaGetLastError();
  const bf16* wi = static_cast<const bf16*>(wimg);
  const float* bi = static_cast<const float*>(bias);
  const ConvParams grow = make_params<GeoGrow::R>(B, H, W);
  const ConvParams outs = make_params<GeoOut::R>(B, H, W);
  const int blocks = 3 * nb;
  for (int d = 0; d < blocks && err == cudaSuccess; ++d) {
    const int j = d % 3;
    bf16* src = buf[j];
    const bf16* wd = wi + (size_t)d * BLOCK_W;
    const float* bd = bi + (size_t)d * BLOCK_B;
    for (int k = 1; k <= 4 && err == cudaSuccess; ++k) {  // x_k into its slice
      ConvParams c = grow;
      c.nchunk = conv_in(k) / CH;
      c.wimg = wd + w_offset(k);
      c.bias = bd + (k - 1) * GC;
      c.src = src;
      c.out = src;
      c.out_c0 = conv_in(k);
      c.out_padded = 1;
      c.slope = slope;
      c.scale = scale;
      err = launch_conv<GC, RW_GROW, S_GROW, EP_LRELU>(c, s);
    }
    if (err != cudaSuccess) break;
    ConvParams c = outs;  // the block's output, and the RRDB's in a third block
    c.nchunk = CB / CH;
    c.wimg = wd + w_offset(5);
    c.bias = bd + 4 * GC;
    c.src = src;
    c.resid = src;
    c.resid2 = j == 2 ? buf[0] : nullptr;
    const bool last = d == blocks - 1;
    c.out = last ? static_cast<bf16*>(y) : buf[(j + 1) % 3];
    c.out_padded = !last;
    c.slope = slope;
    c.scale = scale;
    err = launch_conv<NF, RW_OUT, S_OUT, EP_RESID>(c, s);
  }
  return (int)err;
}

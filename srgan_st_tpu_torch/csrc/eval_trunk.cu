// The eval-mode residual trunk of the generator: kernel E.
//
// Replaces no TPU kernel: the JAX package's eval trunk is plain XLA (its
// BatchNorm-folded xpack eval trunk), and the port ran it as per-block
// cuDNN convs with eager BatchNorm, PReLU and residual passes. This kernel
// runs everything the generator's `g.trunk` region computes in eval:
//
//   block j:  h = PReLU_j(BN1_j(conv1_j(x))),  x <- x + BN2_j(conv2_j(h))
//   then:     y = BN(conv_fuse(x)) + x_stem          (the fusion layer and
//                                                      the global skip)
//
// with BatchNorm on its running statistics: 2n + 1 launches of one 3x3,
// 64 -> 64 bf16 conv (`eval_trunk_conv`) whose epilogue applies the
// channel's affine y = acc * s + t (s = gamma rsqrt(var + eps), t = beta -
// mean s, both f32 from the host), then the PReLU (a block's first conv)
// or the residual add (a block's second conv and the fusion conv), all in
// f32 on the f32 accumulator, and rounds once to bf16. The weights are the
// blocks' bf16 weights unscaled: folding s into bf16 weights would add a
// rounding the blocks do not have.
//
// What bounds it on an H100: at a 960 x 540 frame each conv is 38.2 GFLOP
// (38.7 us at the bf16 peak) and moves 133 MB of activations (199 MB with
// the residual), 40-60 us at 3.35 TB/s; the activation (66 MB) does not fit
// the 50 MB L2. The eval passes it replaces moved the activation ~12 times a
// block through torch's elementwise kernels.
//
// Design. A tile is 64 output pixels of one image row (columns x0 .. x0+63;
// the last column block of a row is masked). Its 3x3 conv reads three
// "bands", the 66 input pixels x0-1 .. x0+64 of rows y-1, y, y+1, each
// stored in shared memory as wgmma's no-swizzle K-major operand [k group]
// [pixel][8 channels]: tap (ky, kx) of the tile is band ky moved by kx
// rows, a descriptor offset (csrc/coarse_wgmma.cuh), so the conv is 9 taps
// x 4 k steps of wgmma m64n64k16 with no im2col copy. The tiles are
// numbered row-fastest down each column block, and each warpgroup takes a
// contiguous run of them: a tile one row below the last shares two of its
// bands, so a warpgroup loads one new band a tile (8.4 KB) into a ring of
// four, and reads each input pixel ~1.07 times. The activations between
// convs live on zero-bordered B x (H+2) x (W+2) x 64 grids, so a band is 66
// consecutive pixels and needs no mask; the first conv zeroes the grids'
// borders, which no conv writes. Block 0's first conv reads the stem output
// unpadded (its bands masked at the image edge), block 0's second conv and
// the fusion conv add it unpadded, and the fusion conv writes y unpadded;
// the block input is updated in place (a pixel's residual is read and its
// output written by the same tile, and no band of that launch reads it).
//
// Each conv is one persistent launch, one 384-thread CTA an SM: the conv's
// 73.7 KB of weights stay in shared memory (one bulk copy), and three
// warpgroups each walk their own run of tiles, the next tile's new band
// and residual loading by cp.async while the current tile's products and
// epilogue run, and each warpgroup's products running during the others'
// epilogues (a new strip's first tile loads its second and third band once
// the tile before it has read its own). The residual is loaded into the
// tile's staging buffer, 16 bytes a thread, coalesced; the epilogue reads
// it there and writes the bf16 output in its place (the 16-byte chunks
// XOR-swizzled by the pixel, so that the accumulator fragments' 4-byte
// accesses are free of bank conflicts), and the tile leaves by 16-byte
// stores, coalesced. Launches use programmatic dependent launch: a conv's
// prologue (its weights' copy) runs while the conv before it drains, and
// waits for it before reading its output.
//
// Measured on one H100 80GB HBM3 at 700 W (chip_smoke.py) at (1, 540, 960,
// 64), n = 16: 3.17 ms a call, 40% of its 1.275 ms bound, against 19.6 ms
// for the cuDNN blocks with eager BatchNorm and PReLU. Shared memory (each
// m64n64k16 reads 4 KB of operands) and the activations' ~170 MB a conv
// bound it together: the products alone take ~67 us a conv, the loads and
// stores alone ~79 us, both ~92 us.
#include <algorithm>

#include "trunk_wgmma.cuh"

using namespace srgan;

namespace {

using bf16 = __nv_bfloat16;
constexpr int C64 = tw::CK;             // channels: the kernel takes C = 64
constexpr int TX = tw::MT;              // output pixels of a tile (one row)
constexpr int BAND = TX + 2;            // input pixels of a band
constexpr int BAND_BYTES = tw::KG * BAND * 16;
constexpr int NSLOT = 4;                // bands a warpgroup keeps: 3 in use, 1 loading
constexpr int STAGE_BYTES = TX * C64 * 2;  // a tile's residual / output staging
constexpr int WGS = 3;                  // warpgroups a CTA, each with its own tiles
constexpr int THREADS = 128 * WGS;
constexpr int WG_BYTES = NSLOT * BAND_BYTES + 2 * STAGE_BYTES;
constexpr int SMEM_BYTES = tw::W_BYTES + WGS * WG_BYTES + 16;
enum { EP_PRELU = 0, EP_RESID = 1 };

struct EvalParams {
  int B, H, W, Wp, NC;  // NC column blocks of TX a row; Wp = W + 2
  long long T;          // tiles: B * NC * H
  long long Q;          // pixels of a padded grid: B (H+2) (W+2)
  const bf16* wimg;     // the conv's ring image: [tap][k group][64 out][8 in]
  const float* st;      // [2][64]: the channels' scale s, then shift t
  const float* alpha;   // EP_PRELU: the block's slope
  const bf16* src;      // conv input (padded grid or unpadded NHWC)
  const bf16* resid;    // EP_RESID: residual (padded grid or unpadded NHWC)
  bf16* out;            // output (padded grid interior, or unpadded)
  bf16* zero[2];        // padded grids whose borders this conv zeroes (or null)
  int src_padded, resid_padded, out_padded;
};

// the 128 threads of warpgroup wg
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// element offset of pixel (b, y, x) in a padded grid (y in -1..H, x in
// -1..W) or, unpadded, in NHWC (-1 outside the image)
__device__ __forceinline__ long long at_padded(const EvalParams& p, int b, int y, int x) {
  return (((long long)b * (p.H + 2) + y + 1) * p.Wp + x + 1) * C64;
}
__device__ __forceinline__ long long at_image(const EvalParams& p, int b, int y, int x) {
  if (y < 0 || y >= p.H || x < 0 || x >= p.W) return -1;
  return (((long long)b * p.H + y) * p.W + x) * C64;
}

// A tile's place: image b, row y, column block cb; `send` is the count of
// bands its warpgroup has loaded up to and including this tile's, which
// are the bands send - 3, send - 2, send - 1 (rows y - 1, y, y + 1).
struct Tile {
  int b, cb, y;
  long long send;
};

__device__ __forceinline__ Tile next_tile(const EvalParams& p, Tile t) {
  if (++t.y == p.H) {
    t.y = 0;
    if (++t.cb == p.NC) {
      t.cb = 0;
      ++t.b;
    }
  }
  t.send += t.y == 0 ? 3 : 1;  // a new column strip loads all three bands
  return t;
}

// Band (b, row yy, column block cb) into `dst` ([k group][66][16 B]), by
// the warpgroup's thread wt; pixels outside the grid (or, from an
// unpadded source, outside the image) load as zeros.
__device__ __forceinline__ void load_band(const EvalParams& p, unsigned char* dst, int b,
                                          int yy, int cb, int wt) {
  const int kg = wt & 7, x0 = cb * TX - 1;
  for (int i = wt >> 3; i < BAND; i += 16) {
    long long o;
    if (p.src_padded) {
      o = at_padded(p, b, yy, x0 + i);
      if (o >= p.Q * C64) o = -1;  // the last rows' wrap past the grid's end
    } else {
      o = at_image(p, b, yy, x0 + i);
    }
    hop::cp_async16(dst + ((size_t)kg * BAND + i) * 16, p.src + (o < 0 ? 0 : o) + kg * 8,
                    o >= 0);
  }
}

// the byte offset of channel chunk c (8 channels) of tile pixel m in a
// staging buffer: pixel-major, chunks XOR-swizzled by the pixel
__device__ __forceinline__ int staged(int m, int c) { return m * 128 + ((c ^ (m & 7)) << 4); }

template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    eval_trunk_conv(const __grid_constant__ EvalParams p) {
  using namespace tw;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, gq = lane >> 2, q4 = lane & 3;
  unsigned char* ring = smem + W_BYTES + (size_t)wg * WG_BYTES;
  unsigned char* stage = ring + NSLOT * BAND_BYTES;  // [2][STAGE_BYTES]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + W_BYTES + (size_t)WGS * WG_BYTES);
  // the weights and the epilogue's constants were written before the conv
  // before this one ran: they are read before waiting for it
  if (tid == 0) {
    hop::mbar_init(bar, 1);
    hop::mbar_fence_init();
    hop::bulk_load(smem, p.wimg, W_BYTES, bar);
  }
  // this thread's channels 8 t + 2 q4 + e: acc[4 t + 2 hh + e]
  float sc[16], sh[16];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * t + 2 * q4 + e;
      sc[2 * t + e] = p.st[c];
      sh[2 * t + e] = p.st[C64 + c];
    }
  const float al = EPI == EP_PRELU ? *p.alpha : 0.f;
  __syncthreads();  // the barrier is initialised
  grid_dep_wait();
  grid_dep_launch();

  // the padded grids' borders (the first conv of a call): nothing in this
  // launch reads them, and no conv writes them
  if (p.zero[0] != nullptr) {
    const long long per = 2LL * p.Wp + 2LL * p.H;  // border pixels an image
    const long long n = (long long)p.B * per * 2 * 8;
    for (long long i = (long long)blockIdx.x * THREADS + tid; i < n;
         i += (long long)gridDim.x * THREADS) {
      const int c = (int)(i & 7), grid = (int)((i >> 3) & 1);
      const long long e = i >> 4, b = e / per, r = e % per;
      int y, x;
      if (r < 2 * p.Wp) {
        y = r < p.Wp ? -1 : p.H;
        x = (int)(r % p.Wp) - 1;
      } else {
        y = (int)((r - 2 * p.Wp) >> 1);
        x = (r & 1) ? p.W : -1;
      }
      *reinterpret_cast<uint4*>(p.zero[grid] + at_padded(p, (int)b, y, x) + 8 * c) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // this warpgroup's run of tiles [t0, t1)
  const long long gw = (long long)blockIdx.x * WGS + wg, nw = (long long)gridDim.x * WGS;
  const long long t0 = gw * p.T / nw, t1 = (gw + 1) * p.T / nw;
  const int count = (int)(t1 - t0);

  // the cp.async copies of bands [from, to) of tile t (band s is row
  // t.y + s - t.send + 2) and, with `resid`, of its residual into staging
  // buffer `buf`
  auto load = [&](const Tile& t, long long from, long long to, int buf, bool resid) {
    for (long long s = from; s < to; ++s)
      load_band(p, ring + (s % NSLOT) * BAND_BYTES, t.b, t.y + (int)(s - t.send) + 2, t.cb,
                wt);
    if constexpr (EPI == EP_RESID) {
      if (!resid) return;
      const int c = wt & 7;
      unsigned char* dst = stage + buf * STAGE_BYTES;
      for (int m = wt >> 3; m < TX; m += 16) {
        const int x = t.cb * TX + m;
        long long o = -1;
        if (x < p.W)
          o = p.resid_padded ? at_padded(p, t.b, t.y, x) : at_image(p, t.b, t.y, x);
        hop::cp_async16(dst + staged(m, c), p.resid + (o < 0 ? 0 : o) + 8 * c, o >= 0);
      }
    }
  };

  Tile cur;
  {
    const long long rows = t0 / p.H;
    cur.y = (int)(t0 - rows * p.H);
    cur.cb = (int)(rows % p.NC);
    cur.b = (int)(rows / p.NC);
    cur.send = 3;
  }
  if (count > 0) load(cur, 0, 3, 0, true);
  hop::cp_async_commit();
  hop::mbar_wait(bar, 0);  // the weights

  const uint32_t wb = hop::smem_addr(smem);
  for (int k = 0; k < count; ++k) {
    // the next tile's new band, or the first of a new strip's three, whose
    // slot the current tile does not read; the other two after its products
    const Tile nxt = next_tile(p, cur);
    const bool more = k + 1 < count, strip = nxt.y == 0;
    if (more) load(nxt, nxt.send - (strip ? 3 : 1), nxt.send - (strip ? 2 : 0), (k + 1) & 1, true);
    hop::cp_async_commit();
    hop::cp_async_wait<1>();
    hop::fence_async_smem();
    wg_sync(wg);  // every thread's copies of tile k have landed

    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    hop::wg_fence();
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const uint32_t band =
          hop::smem_addr(ring + ((cur.send - 3 + ky) % NSLOT) * BAND_BYTES);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int kk = 0; kk < KG / 2; ++kk)
          hop::wgmma_bf16<64>(
              acc, hop::desc(band + (uint32_t)((2 * kk * BAND + kx) * 16), BAND * 16, 128),
              hop::desc(wb + (uint32_t)(((3 * ky + kx) * KG + 2 * kk) * CK * 16), CK * 16,
                        128));
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    if (more && strip) {
      wg_sync(wg);  // every warp's products are done: the tile's bands are free
      load(nxt, nxt.send - 2, nxt.send, 0, false);
      hop::cp_async_commit();
    }

    // the epilogue: the residual read from the staging buffer, the output
    // written in its place
    unsigned char* sbuf = stage + (k & 1) * STAGE_BYTES;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = 16 * warp + gq + 8 * hh;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        __nv_bfloat162* cell = reinterpret_cast<__nv_bfloat162*>(sbuf + staged(m, t) + 4 * q4);
        float r[2] = {0.f, 0.f};
        if constexpr (EPI == EP_RESID) {
          const float2 rf = __bfloat1622float2(*cell);
          r[0] = rf.x;
          r[1] = rf.y;
        }
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float y = __fadd_rn(__fmul_rn(acc[4 * t + 2 * hh + e], sc[2 * t + e]), sh[2 * t + e]);
          if constexpr (EPI == EP_PRELU) {
            if (!(y >= 0.f)) y = __fmul_rn(al, y);
          } else {
            y = __fadd_rn(y, r[e]);
          }
          v[e] = y;
        }
        *cell = __floats2bfloat162_rn(v[0], v[1]);
      }
    }
    wg_sync(wg);  // the tile is staged, and every warp's products are done
    {
      const int c = wt & 7;
      for (int m = wt >> 3; m < TX; m += 16) {
        const int x = cur.cb * TX + m;
        if (x >= p.W) continue;
        const long long o =
            p.out_padded ? at_padded(p, cur.b, cur.y, x) : at_image(p, cur.b, cur.y, x);
        *reinterpret_cast<uint4*>(p.out + o + 8 * c) =
            *reinterpret_cast<const uint4*>(sbuf + staged(m, c));
      }
    }
    wg_sync(wg);  // the staging buffer is read: tile k + 2 may load into it
    cur = nxt;
  }
  hop::cp_async_wait<0>();
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

template <int EPI>
cudaError_t launch_conv(const EvalParams& p, cudaStream_t s) {
  cudaError_t err = allow_smem<eval_trunk_conv<EPI>>(SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const long long ctas = std::min<long long>(sms, (p.T + WGS - 1) / WGS);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, eval_trunk_conv<EPI>, p);
}

bool dims_ok(int n, int B, int H, int W) { return n >= 0 && B > 0 && H > 0 && W > 0; }

EvalParams make_params(int B, int H, int W) {
  EvalParams p{};
  p.B = B;
  p.H = H;
  p.W = W;
  p.Wp = W + 2;
  p.NC = (W + TX - 1) / TX;
  p.T = (long long)B * p.NC * H;
  p.Q = (long long)B * (H + 2) * p.Wp;
  return p;
}

}  // namespace

// The wgmma work of one call in FLOP, from the kernel's own tiles (the
// design's floor): per conv, every tile (64 columns of a row, the last
// column block of a row padded to 64) x 9 taps x 4 m64n64k16.
extern "C" int eval_trunk_bf16_mma_flops(int n, int B, int H, int W, double* flops) {
  if (!dims_ok(n, B, H, W)) return (int)cudaErrorInvalidValue;
  *flops = (2.0 * n + 1) * (double)make_params(B, H, W).T * 36 * tw::MMA_FLOP;
  return 0;
}

// dynamic shared memory of one CTA (any shape)
extern "C" int eval_trunk_smem() { return SMEM_BYTES; }

// x (B, H, W, 64) bf16: the stem output, the trunk's input and its global
// skip; wimg (2n + 1) ring images (kernels/packed_trunk.py weight_image of
// the HWIO kernels: conv1_0, conv2_0, ..., conv2_{n-1}, the fusion conv);
// st (2n + 1, 2, 64) f32 the convs' scale and shift; al (n,) f32 the
// blocks' PReLU slopes; xpad, hpad two B x (H+2) x (W+2) x 64 bf16 grids of
// any contents (the block input and the block's hidden activation). Writes
// y (B, H, W, 64) bf16.
extern "C" int eval_trunk_bf16(const void* x, const void* wimg, const void* st, const void* al,
                               void* y, void* xpad, void* hpad, int n, int B, int H, int W,
                               void* stream) {
  if (!dims_ok(n, B, H, W)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xs = static_cast<const bf16*>(x);
  const bf16* wi = static_cast<const bf16*>(wimg);
  const float* stf = static_cast<const float*>(st);
  bf16* xp = static_cast<bf16*>(xpad);
  bf16* hp = static_cast<bf16*>(hpad);
  const size_t wsz = (size_t)tw::W_BYTES / 2;
  const EvalParams p = make_params(B, H, W);
  cudaError_t err = cudaSuccess;
  for (int j = 0; j < n && err == cudaSuccess; ++j) {
    EvalParams c1 = p;  // h = PReLU(BN1(conv1(x)))
    c1.wimg = wi + (size_t)(2 * j) * wsz;
    c1.st = stf + (size_t)(2 * j) * 2 * C64;
    c1.alpha = static_cast<const float*>(al) + j;
    c1.src = j == 0 ? xs : xp;
    c1.src_padded = j > 0;
    c1.out = hp;
    c1.out_padded = 1;
    if (j == 0) {
      c1.zero[0] = xp;
      c1.zero[1] = hp;
    }
    err = launch_conv<EP_PRELU>(c1, s);
    if (err != cudaSuccess) break;
    EvalParams c2 = p;  // x <- x + BN2(conv2(h))
    c2.wimg = wi + (size_t)(2 * j + 1) * wsz;
    c2.st = stf + (size_t)(2 * j + 1) * 2 * C64;
    c2.src = hp;
    c2.src_padded = 1;
    c2.resid = j == 0 ? xs : xp;
    c2.resid_padded = j > 0;
    c2.out = xp;
    c2.out_padded = 1;
    err = launch_conv<EP_RESID>(c2, s);
  }
  if (err != cudaSuccess) return (int)err;
  EvalParams f = p;  // y = BN(conv_fuse(x)) + x_stem
  f.wimg = wi + (size_t)(2 * n) * wsz;
  f.st = stf + (size_t)(2 * n) * 2 * C64;
  f.src = n > 0 ? xp : xs;
  f.src_padded = n > 0;
  f.resid = xs;
  f.out = static_cast<bf16*>(y);
  err = launch_conv<EP_RESID>(f, s);
  return (int)err;
}

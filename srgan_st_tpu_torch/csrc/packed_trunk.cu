// Residual trunk with train-mode batch-stat BatchNorm, forward and backward:
// kernels K4 and K5.
//
// Replaces the Pallas kernels srgan_st_tpu/kernels/packed_trunk.py
// `_fwd_kernel` (K4) and `_bwd_kernel` (K5). Both run n residual blocks
//
//   x <- x + BN2(conv2(PReLU(BN1(conv1(x)))))
//
// with 3x3 SAME convs without bias and BatchNorm normalized by the batch
// statistics of each call, forward in order and backward in reverse. The
// TPU kernels lane-pack pairs of W columns into 128 lanes; that packing is a
// device of the TPU's vector unit and has no counterpart here: every tensor
// is plain NHWC, and a conv is an implicit GEMM over the (B*H*W) pixels.
//
// Numerics follow the Pallas kernels, T being the compute dtype:
//   forward   a = T(conv acc f32); m, v = f32 batch moments of a (biased,
//             v = max(E[a^2] - m^2, 0)); out = ((a - T(m)) * T(rsqrt(v+eps)))
//             * T(gamma) + T(beta), each step rounded to T; PReLU and the
//             residual add in T.
//   backward  BN backward in f32 with the unrounded inv; da rounded to T
//             before dgrad and wgrad; dgrad (flipped, transposed weights)
//             accumulated in f32; the PReLU input recomputed in T exactly as
//             the forward computed it; wgrad in f32; the running cotangent
//             g held in T between blocks (g <- T(g + dgrad1)).
//
// What bounds it on an H100: at the training shape (16, 24, 24, 64), n = 16,
// the forward moves 61 MB (x, weights, y, the saved residuals) for 21.7
// GFLOP and the backward 66 MB for 43.5 GFLOP: 0.022 / 0.044 ms at the bf16
// peak, bound by operations. Batch-stat BN needs every pixel of a conv
// before its normalize, so the trunk is a fixed sequence of launches, the
// 1.2 MB activation staying in the 50 MB L2 between them; at this size a
// conv's tile (above all its window loader) and the batch-stat reduction
// are what cost, not the launches: K6 runs the same tiles in one launch in
// the same time (PERF.md, Findings).
//
// bf16 design (csrc/trunk_wgmma.cuh; the conv tile in
// csrc/trunk_conv_tile.cuh, which K6 shares): the conv tile is wgmma
// m64n64k16 over the zero-padded flattened grid, 64 positions x 64
// channels a warpgroup, the taps as row offsets into one window, the
// weights one bulk copy of 73.7 KB per 64-channel chunk (2 CTAs an SM at
// C = 64; the 169 tiles of the training shape run in one wave). The
// BatchNorm passes ride on the convs:
//   forward, 2 launches a block + 1: conv1 (forms the block input x + BN2(a2)
//   of the block before on load and writes its own positions of it; its
//   epilogue reduces m1, v1 by the last-ticket tile), conv2 (BN1 + PReLU
//   applied to its window on load; m2, v2); once, the last BN2 + residual;
//   backward, 4 launches a block + 1: dgrad2 (forms da2 from g and a2 on
//   load; its epilogue recomputes the PReLU input, writes h and dpre and
//   reduces dgamma1, dbeta1, dalpha), dgrad1 (forms da1 from dpre and a1 on
//   load; its epilogue adds into g and reduces block j-1's BN2 sums), both
//   wgrads in one launch (wgmma with transposed operands over split-K
//   chunks of the padded grid), their fixed-order sums; once, the last
//   block's BN2 sums of dy.
// The wgmma kernels are launched with programmatic stream serialization:
// each one's prologue (barriers, its weights' bulk copies) runs while the
// kernel before it finishes, and it waits for that kernel before it reads
// anything the kernel wrote.
// Every reduction is deterministic: per-tile partials reduced in tile
// order, by an integer ticket or by one launch; no float atomics. The f32
// path keeps the warp tile code (fmaf through csrc/tile_mma.cuh), 6 launches
// forward and 12 backward a block, as the algorithm check.
// Measured on one H100 80GB HBM3 at 700 W (chip_smoke.py) at the training
// shape, through the wrapper that lays the weights out on every call as a
// train step does: 0.70 ms forward and 1.44 ms backward (the launches alone
// 0.65 and 1.29 ms), against 1.89 and 5.04 ms for the design before it on
// the same card (mma.sync tiles with synchronous loads, a scalar-load
// wgrad, separate BN passes; 6 and 12 launches a block).
#include <algorithm>

#include "trunk_conv_tile.cuh"

using namespace srgan;

namespace {

constexpr int EW_THREADS = 256;   // partial sums: 64 channels x 4 pixel lanes
constexpr int PIX_CHUNK = 256;    // pixels per BN partial-sum block
constexpr int WG_CHUNK = 256;     // least pixels per split-K wgrad block
constexpr int WG_BLOCKS = 128;    // most split-K wgrad blocks (partials' size)
constexpr int APPLY_THREADS = 256;

enum { OUT_ROUND = 0, OUT_F32 = 1, OUT_RESID = 2 };
enum { RED_STATS = 0, RED_SUMS = 1, RED_SUMS_ALPHA = 2 };

// 3x3 SAME conv of src (P pixels of a B x H x W grid, C channels) with
// wt [tap][out][in]; one block computes 64 pixels x 64 output channels.
// OUT_ROUND stores T(acc), OUT_F32 acc, OUT_RESID T(resid + acc) (resid may
// alias out: each element is read and written by the same thread).
template <typename T, int MODE>
__global__ void __launch_bounds__(CONV_THREADS)
    conv3x3_kernel(const T* src, const T* __restrict__ wt, void* out,
                   const T* resid, int H, int W, int C, long long P) {
  constexpr int KS = chunk_stride<T>();
  __shared__ __align__(16) T As[TILE * KS];
  __shared__ __align__(16) T Bs[TILE * KS];

  const long long p0 = (long long)blockIdx.x * TILE;
  const int n0 = blockIdx.y * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float acc[2][4][4];
  conv_tile<T>(src, wt, H, W, C, P, p0, n0, As, Bs, acc);

#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long p = p0 + wm + m * 16 + g + 8 * half;
      if (p >= P) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const size_t o = (size_t)p * C + n0 + wn + n * 8 + 2 * t;
        const float v0 = acc[m][n][2 * half], v1 = acc[m][n][2 * half + 1];
        if constexpr (MODE == OUT_F32) {
          store2(static_cast<float*>(out) + o, v0, v1);
        } else if constexpr (MODE == OUT_ROUND) {
          store2(static_cast<T*>(out) + o, v0, v1);
        } else {
          const float r0 = to_f(resid[o]), r1 = to_f(resid[o + 1]);
          store2(static_cast<T*>(out) + o, __fadd_rn(r0, v0), __fadd_rn(r1, v1));
        }
      }
    }
  }
}

// Per-block channel sums of a and a^2 over PIX_CHUNK pixels:
// part[block][k][c], k = 0 (sum a), 1 (sum a^2).
template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
    fwd_partials_kernel(const T* __restrict__ a, float* __restrict__ part, int C,
                        long long P) {
  __shared__ float red[2][4][64];
  const int cl = threadIdx.x & 63, lane = threadIdx.x >> 6;
  const int c = blockIdx.y * 64 + cl;
  const long long pbeg = (long long)blockIdx.x * PIX_CHUNK;
  const long long pend = min(P, pbeg + PIX_CHUNK);
  float s = 0.f, ss = 0.f;
  for (long long p = pbeg + lane; p < pend; p += 4) {
    const float v = to_f(a[(size_t)p * C + c]);
    s = __fadd_rn(s, v);
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
  red[0][lane][cl] = s;
  red[1][lane][cl] = ss;
  __syncthreads();
  if (lane < 2) {
    const float* r = red[lane][0] + cl;
    part[((size_t)blockIdx.x * 2 + lane) * C + c] = ((r[0] + r[64]) + r[128]) + r[192];
  }
}

// Per-block sums of the BN backward: k = 0 (sum dy), 1 (sum dy * xhat), and
// with PRELU (BN1 under the PReLU) k = 2 (sum over pre < 0 of dh * pre).
// With PRELU, dy is the PReLU backward of dh (f32, overwritten in place by
// dpre) at the PReLU input recomputed from a in T, whose output h is
// stored for the wgrad of conv2; without, dy is the cotangent g (T).
template <typename T, bool PRELU>
__global__ void __launch_bounds__(EW_THREADS)
    bwd_partials_kernel(const T* __restrict__ g, float* __restrict__ dh,
                        const T* __restrict__ a, T* __restrict__ hout,
                        const float* __restrict__ mv, const float* __restrict__ gam,
                        const float* __restrict__ bet, const float* __restrict__ alpha_p,
                        float eps, float* __restrict__ part, int C, long long P) {
  constexpr int K = PRELU ? 3 : 2;
  __shared__ float red[K][4][64];
  const int cl = threadIdx.x & 63, lane = threadIdx.x >> 6;
  const int c = blockIdx.y * 64 + cl;
  const float m = mv[c], inv = inv_std(mv[C + c], eps);
  float mT = 0.f, invT = 0.f, gT = 0.f, bT = 0.f, al = 0.f, alT = 0.f;
  if constexpr (PRELU) {
    mT = rnd<T>(m);
    invT = rnd<T>(inv);
    gT = rnd<T>(gam[c]);
    bT = rnd<T>(bet[c]);
    al = *alpha_p;
    alT = rnd<T>(al);
  }
  const long long pbeg = (long long)blockIdx.x * PIX_CHUNK;
  const long long pend = min(P, pbeg + PIX_CHUNK);
  float s = 0.f, sx = 0.f, sa = 0.f;
  for (long long p = pbeg + lane; p < pend; p += 4) {
    const size_t o = (size_t)p * C + c;
    const float av = to_f(a[o]);
    float d;
    if constexpr (PRELU) {
      const float pre = bn_affine<T>(av, mT, invT, gT, bT);
      const bool neg = pre < 0.f;
      hout[o] = from_f<T>(neg ? __fmul_rn(alT, pre) : pre);
      const float dhv = dh[o];
      if (neg) sa = __fadd_rn(sa, __fmul_rn(dhv, pre));
      d = neg ? __fmul_rn(dhv, al) : dhv;
      dh[o] = d;
    } else {
      d = to_f(g[o]);
    }
    const float xh = __fmul_rn(__fsub_rn(av, m), inv);
    s = __fadd_rn(s, d);
    sx = __fadd_rn(sx, __fmul_rn(d, xh));
  }
  red[0][lane][cl] = s;
  red[1][lane][cl] = sx;
  if constexpr (PRELU) red[2][lane][cl] = sa;
  __syncthreads();
  if (lane < K) {
    const float* r = red[lane][0] + cl;
    part[((size_t)blockIdx.x * K + lane) * C + c] = ((r[0] + r[64]) + r[128]) + r[192];
  }
}

// One block of C threads sums the partials of every quantity k over the
// blocks in order (in double). RED_STATS: o0 = m, o1 = v of `nelem`
// elements. RED_SUMS: o0 = sum k=1 (dgamma), o1 = sum k=0 (dbeta);
// RED_SUMS_ALPHA also o2[0] = the k=2 sums added over the channels in order.
__global__ void reduce_kernel(const float* __restrict__ part, int nblocks, int K, int C,
                              int mode, float nelem, float* __restrict__ o0,
                              float* __restrict__ o1, float* __restrict__ o2) {
  __shared__ float chan[1024];
  const int c = threadIdx.x;
  float r[3];
  for (int k = 0; k < K; ++k) {
    double s = 0.0;
    for (int b = 0; b < nblocks; ++b) s += part[((size_t)b * K + k) * C + c];
    r[k] = (float)s;
  }
  if (mode == RED_STATS) {
    bn_moments(r[0], r[1], nelem, o0 + c, o1 + c);
    return;
  }
  o0[c] = r[1];
  o1[c] = r[0];
  if (mode == RED_SUMS_ALPHA) {
    chan[c] = r[2];
    __syncthreads();
    if (c == 0) {
      float s = 0.f;
      for (int i = 0; i < C; ++i) s = __fadd_rn(s, chan[i]);
      o2[0] = s;
    }
  }
}

// Forward normalize: out = BN(a) [-> PReLU] [+ x], in T.
template <typename T, bool PRELU, bool RESID>
__global__ void __launch_bounds__(APPLY_THREADS)
    bn_apply_kernel(const T* __restrict__ a, const float* __restrict__ mv,
                    const float* __restrict__ gam, const float* __restrict__ bet,
                    const float* __restrict__ alpha_p, const T* __restrict__ x,
                    T* __restrict__ out, float eps, int C, long long total) {
  const long long i = (long long)blockIdx.x * APPLY_THREADS + threadIdx.x;
  if (i >= total) return;
  out[i] = bn_out<T, PRELU, RESID>(to_f(a[i]), (int)(i % C), C, mv, gam, bet, eps,
                                   PRELU ? rnd<T>(*alpha_p) : 0.f, RESID ? to_f(x[i]) : 0.f);
}

// BN backward: da = T((gamma * inv) * (dy - dbeta/n - xhat * (dgamma/n))).
template <typename T, typename DY>
__global__ void __launch_bounds__(APPLY_THREADS)
    bn_bwd_apply_kernel(const DY* __restrict__ dy, const T* __restrict__ a,
                        const float* __restrict__ mv, const float* __restrict__ gam,
                        const float* __restrict__ dgam, const float* __restrict__ dbet,
                        T* __restrict__ da, float eps, float nelem, int C,
                        long long total) {
  const long long i = (long long)blockIdx.x * APPLY_THREADS + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C);
  const float inv = inv_std(mv[C + c], eps);
  const float xh = __fmul_rn(__fsub_rn(to_f(a[i]), mv[c]), inv);
  const float t = __fsub_rn(__fsub_rn(to_f(dy[i]), __fdiv_rn(dbet[c], nelem)),
                            __fmul_rn(xh, __fdiv_rn(dgam[c], nelem)));
  da[i] = from_f<T>(__fmul_rn(__fmul_rn(gam[c], inv), t));
}

// Split-K wgrad: part[block][tap][ci][co] = sum over the block's `chunk`
// pixels p of src[p + (ky-1, kx-1), ci] * dy[p, co] (zero outside the grid).
// Grid: (pixel chunks, 9 taps, (C/64)^2 channel tiles).
template <typename T>
__global__ void __launch_bounds__(CONV_THREADS)
    wgrad_kernel(const T* __restrict__ src, const T* __restrict__ dy,
                 float* __restrict__ part, int H, int W, int C, long long P,
                 int chunk) {
  constexpr int KC = Chunk<T>::KC;
  constexpr int KS = KC + 16 / sizeof(T);
  __shared__ __align__(16) T As[TILE * KS];  // [ci][pixel]
  __shared__ __align__(16) T Bs[TILE * KS];  // [co][pixel]

  const int tap = blockIdx.y, sy = tap / 3 - 1, sx = tap % 3 - 1;
  const int nb = C / TILE;
  const int ci0 = (blockIdx.z / nb) * TILE, co0 = (blockIdx.z % nb) * TILE;
  const long long pbeg = (long long)blockIdx.x * chunk;
  const long long pend = min(P, pbeg + chunk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const T zero = from_f<T>(0.f);

  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (long long k0 = pbeg; k0 < pend; k0 += KC) {
    __syncthreads();
    for (int v = tid; v < KC * TILE; v += CONV_THREADS) {
      const int kk = v / TILE, ch = v % TILE;
      const long long p = k0 + kk;
      T sv = zero, dv = zero;
      if (p < pend) {
        dv = dy[(size_t)p * C + co0 + ch];
        const int w = (int)(p % W), h = (int)((p / W) % H);
        if (h + sy >= 0 && h + sy < H && w + sx >= 0 && w + sx < W)
          sv = src[(size_t)(p + (long long)sy * W + sx) * C + ci0 + ch];
      }
      As[ch * KS + kk] = sv;
      Bs[ch * KS + kk] = dv;
    }
    __syncthreads();
    const T* alo[2] = {As + (wm + g) * KS, As + (wm + 16 + g) * KS};
    const T* ahi[2] = {alo[0] + 8 * KS, alo[1] + 8 * KS};
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
      warp_k16<2, 4>(acc, alo, ahi, ks * 16, Bs + wn * KS, KS, g, t);
  }

  float* o = part + ((size_t)blockIdx.x * 9 + tap) * C * C;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = ci0 + wm + m * 16 + g + 8 * half;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        store2(o + (size_t)ci * C + co0 + wn + n * 8 + 2 * t, acc[m][n][2 * half],
               acc[m][n][2 * half + 1]);
    }
}

// dw[i] = sum over the wgrad blocks, in order, of part[block][i].
__global__ void wgrad_reduce_kernel(const float* __restrict__ part, int nblocks,
                                    long long per, float* __restrict__ dw) {
  const long long i = (long long)blockIdx.x * APPLY_THREADS + threadIdx.x;
  if (i >= per) return;
  double s = 0.0;
  for (int b = 0; b < nblocks; ++b) s += part[(size_t)b * per + i];
  dw[i] = (float)s;
}

// ------------------------------------------------------------------ bf16
// The conv tile on wgmma (csrc/trunk_conv_tile.cuh), one tile a CTA: M tile
// blockIdx.x, N tile blockIdx.y.
using tw::bf16;
using tw::ConvParams;
using tw::conv_smem;
using tw::LD_COPY;
using tw::LD_BN_PRELU;
using tw::LD_DA_T;
using tw::LD_DA_F;
using tw::LD_BN_RESID;
using tw::EP_STATS;
using tw::EP_PRELU_BWD;
using tw::EP_GRAD;

template <int LOAD, int EPI>
__global__ void __launch_bounds__(tw::CONV_THREADS)
    trunk_conv_wgmma(const __grid_constant__ ConvParams p) {
  using namespace tw;
  extern __shared__ __align__(128) unsigned char smem[];
  const TileSmem s = tile_smem(smem, p.g);
  const int C = p.g.C, tid = threadIdx.x, mt = blockIdx.x, nt = blockIdx.y;
  // the weights do not depend on the kernel before: their copies start
  // before waiting for it
  if (tid == 0) {
    for (int st = 0; st < s.stages; ++st) hop::mbar_init(&s.bar[st], 1);
    hop::mbar_fence_init();
    for (int kc = 0; kc < s.stages; ++kc) issue_weights(p, s, nt, kc);
  }
  grid_dep_wait();
  grid_dep_launch();
  epilogue_constants<EPI>(p, s, nt * CK);
  __syncthreads();  // barriers initialised

  float acc[32];
  unsigned ph = 0;
  conv_mainloop<LOAD>(p, s, (long long)mt * MT, nt, acc, ph);
  if (!conv_epilogue<EPI>(p, s, mt, nt, acc)) return;
  if (!last_ticket(p.ticket, gridDim.x * gridDim.y)) return;

  // the last tile: every tile's partials, in tile order
  float* scratch = reinterpret_cast<float*>(s.wring);  // free after the mainloop
  if constexpr (EPI == EP_STATS) {
    reduce_partials<2>(p.part, gridDim.x, C, scratch, [&](int c, const float* r) {
      bn_moments(r[0], r[1], p.nelem, p.r0 + c, p.r1 + c);
    });
  } else if constexpr (EPI == EP_GRAD) {
    reduce_partials<2>(p.part, gridDim.x, C, scratch, [&](int c, const float* r) {
      p.r0[c] = r[1];  // dgamma
      p.r1[c] = r[0];  // dbeta
    });
  } else {
    float* chan = s.econ;  // C <= 1024 floats: econ and red
    reduce_partials<3>(p.part, gridDim.x, C, scratch, [&](int c, const float* r) {
      p.r0[c] = r[1];
      p.r1[c] = r[0];
      chan[c] = r[2];
    });
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      for (int c = 0; c < C; ++c) sum = __fadd_rn(sum, chan[c]);
      *p.r2 = sum;  // dalpha: the channels' sums in order
    }
  }
}

// The weight-gradient tile on wgmma: both wgrads of a residual block in one
// launch (blockIdx.y: 0 = dW1 from the block input and da1, 1 = dW2 from h
// and da2). A block owns `nsub` sub-chunks of 64 padded positions (split-K)
// and one (ci, co) tile of 64 x 64 (blockIdx.z); warpgroup ky computes the
// taps (ky, 0..2), 3 x 32 f32 accumulators a thread. Sub-chunks stream
// through a 2-stage ring of cp.async copies: the src window of the
// sub-chunk (the conv window's geometry) and its 64 rows of dy.
struct WgradParams {
  tw::Geom g;
  const bf16* src[2];
  const bf16* dy[2];
  float* part;  // [2][nchunks][9][C][C]
  int nsub;
};

__host__ __device__ inline size_t wgrad_smem(const tw::Geom& g) {
  return 2 * (size_t)(g.rows + tw::MT) * tw::KG * 16;
}

__global__ void __launch_bounds__(tw::WGRAD_THREADS, 1)
    trunk_wgrad_wgmma(const __grid_constant__ WgradParams p) {
  using namespace tw;
  extern __shared__ __align__(128) unsigned char smem[];
  const Geom& g = p.g;
  const int C = g.C, ntc = C / CK;
  const int stage_bytes = (g.rows + MT) * KG * 16;  // [KG][rows][16] src, [KG][64][16] dy
  const int which = blockIdx.y, chunk = blockIdx.x;
  const int ci0 = (blockIdx.z / ntc) * CK, co0 = (blockIdx.z % ntc) * CK;
  const bf16* src = p.src[which];
  const bf16* dy = p.dy[which];
  const int tid = threadIdx.x, ky = tid / 128;
  const long long total = (g.Q + MT - 1) / MT;
  const long long s0 = (long long)chunk * p.nsub;
  const int nsub = (int)min((long long)p.nsub, total - s0);
  grid_dep_wait();
  grid_dep_launch();

  auto load = [&](int s) {
    unsigned char* st = smem + (s & 1) * stage_bytes;
    const long long q0 = (s0 + s) * MT;
    const int kg = tid & 7;  // 384 threads: a thread keeps its k group
    for (int r = tid >> 3; r < g.rows; r += WGRAD_THREADS / 8) {
      const long long pix = pixel_of(g, win_pos(g, q0, r));
      hop::cp_async16(st + ((size_t)kg * g.rows + r) * 16,
                      src + (size_t)(pix < 0 ? 0 : pix) * C + ci0 + kg * 8, pix >= 0);
    }
    unsigned char* dw = st + (size_t)g.rows * KG * 16;
    for (int r = tid >> 3; r < MT; r += WGRAD_THREADS / 8) {
      const long long pix = pixel_of(g, q0 + r);
      hop::cp_async16(dw + ((size_t)kg * MT + r) * 16,
                      dy + (size_t)(pix < 0 ? 0 : pix) * C + co0 + kg * 8, pix >= 0);
    }
  };
  float acc[3][32];
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[x][e] = 0.f;
  load(0);
  hop::cp_async_commit();
  if (nsub > 1) load(1);
  hop::cp_async_commit();
  for (int s = 0; s < nsub; ++s) {
    hop::cp_async_wait<1>();
    hop::fence_async_smem();
    __syncthreads();
    hop::wg_fence();
    const uint32_t wa = hop::smem_addr(smem + (s & 1) * stage_bytes);
    const uint32_t wd = wa + (uint32_t)g.rows * KG * 16;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int row = ky * g.tapstride + kx;
#pragma unroll
      for (int k = 0; k < MT / 16; ++k)
        tw::wgmma_bf16_tt(acc[kx], hop::desc(wa + (uint32_t)((row + 16 * k) * 16), 128, g.rows * 16),
                          hop::desc(wd + (uint32_t)(16 * k * 16), 128, MT * 16));
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    __syncthreads();  // stage s & 1 is free
    if (s + 2 < nsub) load(s + 2);
    hop::cp_async_commit();
  }
  // acc[kx][4 t + 2 hh + e]: ci = ci0 + 16 warp + g + 8 hh, co = co0 + 8 t + 2 q + e
  const int warp = (tid >> 5) & 3, lane = tid & 31, gq = lane >> 2, q4 = lane & 3;
  float* out = p.part + ((size_t)which * gridDim.x + chunk) * 9 * C * C;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ci = ci0 + 16 * warp + gq + 8 * hh;
#pragma unroll
      for (int t = 0; t < 8; ++t)
        store2(out + ((size_t)(3 * ky + kx) * C + ci) * C + co0 + 8 * t + 2 * q4,
               acc[kx][4 * t + 2 * hh], acc[kx][4 * t + 2 * hh + 1]);
    }
}

// dW1 and dW2 of a block: the wgrad partials summed over the chunks in
// order, in double.
__global__ void __launch_bounds__(APPLY_THREADS)
    wgrad_reduce2_kernel(const float* __restrict__ part, int nchunks, long long per,
                         float* __restrict__ dw1, float* __restrict__ dw2) {
  const long long i = (long long)blockIdx.x * APPLY_THREADS + threadIdx.x;
  if (i >= 2 * per) return;
  const int which = (int)(i / per);
  const long long e = i - which * per;
  const float* src = part + (size_t)which * nchunks * per + e;
  constexpr int U = 8;
  double s = 0.0;
  for (int b0 = 0; b0 < nchunks; b0 += U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = b0 + u < nchunks ? src[(size_t)(b0 + u) * per] : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) s += (double)v[u];
  }
  (which ? dw2 : dw1)[e] = (float)s;
}

// The last block's BN2 backward sums of the cotangent g over a2:
// partials of sum g and sum g * xhat per PIX_CHUNK pixels, then the ticket
// reduction into dgamma, dbeta.
__global__ void __launch_bounds__(EW_THREADS)
    bn2_sums_kernel(const bf16* __restrict__ g, const bf16* __restrict__ a,
                    const float* __restrict__ mv, float eps, float* part, unsigned* ticket,
                    float* dgam, float* dbet, int C, long long P) {
  __shared__ float red[2][4][64];
  __shared__ float scratch[2 * 1024];
  const int cl = threadIdx.x & 63, lane = threadIdx.x >> 6;
  const int c = blockIdx.y * 64 + cl;
  const float m = mv[c], inv = inv_std(mv[C + c], eps);
  const long long pbeg = (long long)blockIdx.x * PIX_CHUNK;
  const long long pend = min(P, pbeg + PIX_CHUNK);
  float s = 0.f, sx = 0.f;
  for (long long p = pbeg + lane; p < pend; p += 4) {
    const size_t o = (size_t)p * C + c;
    const float d = to_f(g[o]);
    const float xh = __fmul_rn(__fsub_rn(to_f(a[o]), m), inv);
    s = __fadd_rn(s, d);
    sx = __fadd_rn(sx, __fmul_rn(d, xh));
  }
  red[0][lane][cl] = s;
  red[1][lane][cl] = sx;
  __syncthreads();
  if (lane < 2) {
    const float* r = red[lane][0] + cl;
    part[((size_t)blockIdx.x * 2 + lane) * C + c] = ((r[0] + r[64]) + r[128]) + r[192];
  }
  if (!tw::last_ticket(ticket, gridDim.x * gridDim.y)) return;
  tw::reduce_partials<2>(part, gridDim.x, C, scratch, [&](int ch, const float* r) {
    dgam[ch] = r[1];
    dbet[ch] = r[0];
  });
}

struct Dims {
  int H, W, C;
  long long P, act;
  int pchunks, wchunks, wg_chunk;
  dim3 conv_grid, part_grid, apply_grid, wgrad_grid, wred_grid;
};

bool make_dims(int n, int B, int H, int W, int C, Dims* d) {
  if (n <= 0 || B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % TILE || C > 1024 ||
      !tw::grid_fits(B, H, W))
    return false;
  d->H = H;
  d->W = W;
  d->C = C;
  d->P = (long long)B * H * W;
  d->act = d->P * C;
  d->pchunks = (int)((d->P + PIX_CHUNK - 1) / PIX_CHUNK);
  // at most WG_BLOCKS wgrad blocks, so that their partials stay small
  const long long per_block = (d->P + WG_BLOCKS - 1) / WG_BLOCKS;
  const long long rounded = (per_block + 31) / 32 * 32;
  d->wg_chunk = rounded > WG_CHUNK ? (int)rounded : WG_CHUNK;
  d->wchunks = (int)((d->P + d->wg_chunk - 1) / d->wg_chunk);
  d->conv_grid = dim3((unsigned)((d->P + TILE - 1) / TILE), C / TILE);
  d->part_grid = dim3(d->pchunks, C / TILE);
  d->apply_grid = dim3((unsigned)((d->act + APPLY_THREADS - 1) / APPLY_THREADS));
  d->wgrad_grid = dim3(d->wchunks, 9, (C / TILE) * (C / TILE));
  d->wred_grid = dim3((unsigned)((9LL * C * C + APPLY_THREADS - 1) / APPLY_THREADS));
  return true;
}

size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

// Workspace layout. Forward: h (T), BN partials. Backward: da (T), h (T),
// dh / dpre (f32), BN partials, wgrad partials.
struct Workspace {
  size_t da, h, dh, part, wpart, total;
};

Workspace layout(const Dims& d, int esize, bool backward) {
  Workspace w{};
  size_t off = 0;
  const size_t act = (size_t)d.act;
  if (backward) {
    w.da = off;
    off += align256(act * esize);
  }
  w.h = off;
  off += align256(act * esize);
  if (backward) {
    w.dh = off;
    off += align256(act * 4);
  }
  w.part = off;
  off += align256((size_t)d.pchunks * 3 * d.C * 4);
  if (backward) {
    w.wpart = off;
    off += align256((size_t)d.wchunks * 9 * d.C * d.C * 4);
  }
  w.total = off;
  return w;
}

template <typename T>
int trunk_forward(const T* x, const T* w1t, const T* w2t, const float* g1, const float* b1,
            const float* g2, const float* b2, const float* al, T* y, T* xs, T* a1s,
            T* a2s, float* stats, void* ws, long long ws_bytes, int n, int B, int H,
            int W, int C, float eps, cudaStream_t s) {
  Dims d;
  if (!make_dims(n, B, H, W, C, &d)) return (int)cudaErrorInvalidValue;
  const Workspace wl = layout(d, sizeof(T), false);
  if ((size_t)ws_bytes < wl.total) return (int)cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(ws);
  T* h = reinterpret_cast<T*>(base + wl.h);
  float* part = reinterpret_cast<float*>(base + wl.part);
  const float nelem = (float)d.P;
  const size_t wsz = (size_t)9 * C * C;

  cudaError_t err = cudaMemcpyAsync(xs, x, (size_t)d.act * sizeof(T),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < n; ++i) {
    const T* xi = xs + i * d.act;
    T* a1 = a1s + i * d.act;
    T* a2 = a2s + i * d.act;
    float* st = stats + (size_t)i * 4 * C;
    T* xo = i + 1 < n ? xs + (i + 1) * d.act : y;

    conv3x3_kernel<T, OUT_ROUND><<<d.conv_grid, CONV_THREADS, 0, s>>>(
        xi, w1t + i * wsz, a1, nullptr, H, W, C, d.P);
    fwd_partials_kernel<T><<<d.part_grid, EW_THREADS, 0, s>>>(a1, part, C, d.P);
    reduce_kernel<<<1, C, 0, s>>>(part, d.pchunks, 2, C, RED_STATS, nelem, st,
                                  st + C, nullptr);
    bn_apply_kernel<T, true, false><<<d.apply_grid, APPLY_THREADS, 0, s>>>(
        a1, st, g1 + i * C, b1 + i * C, al + i, nullptr, h, eps, C, d.act);

    conv3x3_kernel<T, OUT_ROUND><<<d.conv_grid, CONV_THREADS, 0, s>>>(
        h, w2t + i * wsz, a2, nullptr, H, W, C, d.P);
    fwd_partials_kernel<T><<<d.part_grid, EW_THREADS, 0, s>>>(a2, part, C, d.P);
    reduce_kernel<<<1, C, 0, s>>>(part, d.pchunks, 2, C, RED_STATS, nelem, st + 2 * C,
                                  st + 3 * C, nullptr);
    bn_apply_kernel<T, false, true><<<d.apply_grid, APPLY_THREADS, 0, s>>>(
        a2, st + 2 * C, g2 + i * C, b2 + i * C, nullptr, xi, xo, eps, C, d.act);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int trunk_backward(const T* dy, const T* xs, const T* a1s, const T* a2s, const float* stats,
             const T* w1d, const T* w2d, const float* g1, const float* b1,
             const float* g2, const float* al, T* dx, float* dw1, float* dw2,
             float* dg1, float* db1, float* dg2, float* db2, float* dal, void* ws,
             long long ws_bytes, int n, int B, int H, int W, int C, float eps,
             cudaStream_t s) {
  Dims d;
  if (!make_dims(n, B, H, W, C, &d)) return (int)cudaErrorInvalidValue;
  const Workspace wl = layout(d, sizeof(T), true);
  if ((size_t)ws_bytes < wl.total) return (int)cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(ws);
  T* da = reinterpret_cast<T*>(base + wl.da);
  T* h = reinterpret_cast<T*>(base + wl.h);
  float* dh = reinterpret_cast<float*>(base + wl.dh);
  float* part = reinterpret_cast<float*>(base + wl.part);
  float* wpart = reinterpret_cast<float*>(base + wl.wpart);
  const float nelem = (float)d.P;
  const size_t wsz = (size_t)9 * C * C;

  // dx holds the running cotangent g, in T
  cudaError_t err = cudaMemcpyAsync(dx, dy, (size_t)d.act * sizeof(T),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  for (int j = n - 1; j >= 0; --j) {
    const float* st = stats + (size_t)j * 4 * C;
    const T* a1 = a1s + j * d.act;
    const T* a2 = a2s + j * d.act;

    // out = x + BN2(conv2(h)): BN2 backward of g
    bwd_partials_kernel<T, false><<<d.part_grid, EW_THREADS, 0, s>>>(
        dx, nullptr, a2, nullptr, st + 2 * C, nullptr, nullptr, nullptr, eps, part, C,
        d.P);
    reduce_kernel<<<1, C, 0, s>>>(part, d.pchunks, 2, C, RED_SUMS, nelem, dg2 + j * C,
                                  db2 + j * C, nullptr);
    bn_bwd_apply_kernel<T, T><<<d.apply_grid, APPLY_THREADS, 0, s>>>(
        dx, a2, st + 2 * C, g2 + j * C, dg2 + j * C, db2 + j * C, da, eps, nelem, C,
        d.act);
    // dgrad2 -> dh (f32); PReLU backward and BN1 sums; h for wgrad2
    conv3x3_kernel<T, OUT_F32><<<d.conv_grid, CONV_THREADS, 0, s>>>(
        da, w2d + j * wsz, dh, nullptr, H, W, C, d.P);
    bwd_partials_kernel<T, true><<<d.part_grid, EW_THREADS, 0, s>>>(
        nullptr, dh, a1, h, st, g1 + j * C, b1 + j * C, al + j, eps, part, C, d.P);
    reduce_kernel<<<1, C, 0, s>>>(part, d.pchunks, 3, C, RED_SUMS_ALPHA, nelem,
                                  dg1 + j * C, db1 + j * C, dal + j);
    wgrad_kernel<T><<<d.wgrad_grid, CONV_THREADS, 0, s>>>(h, da, wpart, H, W, C, d.P,
                                                         d.wg_chunk);
    wgrad_reduce_kernel<<<d.wred_grid, APPLY_THREADS, 0, s>>>(wpart, d.wchunks, wsz,
                                                              dw2 + j * wsz);
    // BN1 backward of dpre; dgrad1 into g; wgrad1 from the block input
    bn_bwd_apply_kernel<T, float><<<d.apply_grid, APPLY_THREADS, 0, s>>>(
        dh, a1, st, g1 + j * C, dg1 + j * C, db1 + j * C, da, eps, nelem, C, d.act);
    conv3x3_kernel<T, OUT_RESID><<<d.conv_grid, CONV_THREADS, 0, s>>>(
        da, w1d + j * wsz, dx, dx, H, W, C, d.P);
    wgrad_kernel<T><<<d.wgrad_grid, CONV_THREADS, 0, s>>>(xs + j * d.act, da, wpart, H,
                                                         W, C, d.P, d.wg_chunk);
    wgrad_reduce_kernel<<<d.wred_grid, APPLY_THREADS, 0, s>>>(wpart, d.wchunks, wsz,
                                                              dw1 + j * wsz);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16 host
struct Bf16Dims {
  tw::Geom g;
  int mtiles;   // conv M tiles = wgrad sub-chunks of 64 padded positions
  int ntc;      // 64-channel tiles
  int nsub;     // sub-chunks per wgrad block
  int nchunks;  // wgrad blocks along the positions (split-K)
};

Bf16Dims bf16_dims(const Dims& d, int B) {
  Bf16Dims b;
  b.g = tw::make_geom(B, d.H, d.W, d.C);
  b.mtiles = (int)((b.g.Q + tw::MT - 1) / tw::MT);
  b.ntc = d.C / tw::CK;
  // about 128 wgrad blocks (of 384 threads, one per SM) over both wgrads
  const long long work = 2LL * b.ntc * b.ntc * b.mtiles;
  b.nsub = (int)std::max(1LL, (work + 127) / 128);
  b.nchunks = (b.mtiles + b.nsub - 1) / b.nsub;
  return b;
}

// bf16 workspace. Forward: BN partials, tickets. Backward: da1, da2, h
// (bf16), dpre (f32), BN partials, wgrad partials, tickets. The weights'
// ring images are the wrapper's tensors.
struct WsBf16 {
  size_t da1, da2, h, dpre, part, wpart, ticket, total;
  int ntickets;
};

WsBf16 layout_bf16(const Dims& d, const Bf16Dims& b, int n, bool backward) {
  WsBf16 w{};
  size_t off = 0;
  const size_t act = (size_t)d.act;
  if (backward) {
    w.da1 = off;
    off += align256(act * 2);
    w.da2 = off;
    off += align256(act * 2);
    w.h = off;
    off += align256(act * 2);
    w.dpre = off;
    off += align256(act * 4);
  }
  w.part = off;
  off += align256((size_t)std::max(3 * b.mtiles, 2 * d.pchunks) * d.C * 4);
  if (backward) {
    w.wpart = off;
    off += align256((size_t)2 * b.nchunks * 9 * d.C * d.C * 4);
  }
  w.ntickets = 2 * n + 1;
  w.ticket = off;
  off += align256((size_t)w.ntickets * 4);
  w.total = off;
  return w;
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

// A wgmma kernel launched with programmatic stream serialization: its
// prologue (barriers, the weights' copies) overlaps the kernel before it,
// which it waits for in grid_dep_wait.
template <auto Kernel, typename Params>
cudaError_t launch_pdl(dim3 grid, int threads, size_t smem, cudaStream_t s, const Params& p) {
  cudaError_t err = allow_smem<Kernel>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, Kernel, p);
}

template <int LOAD, int EPI>
cudaError_t launch_conv(const ConvParams& p, const Bf16Dims& b, cudaStream_t s) {
  return launch_pdl<trunk_conv_wgmma<LOAD, EPI>>(dim3(b.mtiles, b.ntc), tw::CONV_THREADS,
                                                 conv_smem(b.g), s, p);
}

int forward_bf16(const bf16* x, const bf16* w1i, const bf16* w2i, const float* g1,
                 const float* b1, const float* g2, const float* b2, const float* al, bf16* y,
                 bf16* xs, bf16* a1s, bf16* a2s, float* stats, void* ws, long long ws_bytes,
                 int n, int B, int H, int W, int C, float eps, cudaStream_t s) {
  Dims d;
  if (!make_dims(n, B, H, W, C, &d)) return (int)cudaErrorInvalidValue;
  const Bf16Dims bd = bf16_dims(d, B);
  const WsBf16 wl = layout_bf16(d, bd, n, false);
  if ((size_t)ws_bytes < wl.total) return (int)cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(ws);
  unsigned* tickets = reinterpret_cast<unsigned*>(base + wl.ticket);
  const size_t wsz = (size_t)9 * C * C;

  cudaError_t err = cudaMemcpyAsync(xs, x, (size_t)d.act * 2, cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(tickets, 0, (size_t)wl.ntickets * 4, s);
  ConvParams p{};
  p.g = bd.g;
  p.part = reinterpret_cast<float*>(base + wl.part);
  p.eps = eps;
  p.nelem = (float)d.P;
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    bf16* a1 = a1s + i * d.act;
    bf16* a2 = a2s + i * d.act;
    float* st = stats + (size_t)i * 4 * C;

    ConvParams c1 = p;  // a1 = conv1(x); m1, v1
    c1.wimg = w1i + i * wsz;
    c1.out = a1;
    c1.ticket = tickets + 2 * i;
    c1.r0 = st;
    c1.r1 = st + C;
    if (i == 0) {
      c1.src = xs;
      err = launch_conv<LD_COPY, EP_STATS>(c1, bd, s);
    } else {
      // x_i = x_{i-1} + BN2(a2_{i-1}), formed on load; its own positions
      // written to xs[i]
      c1.src = a2s + (i - 1) * d.act;
      c1.dsrc = xs + (i - 1) * d.act;
      c1.lmv = st - 2 * C;
      c1.lgam = g2 + (i - 1) * C;
      c1.lbet = b2 + (i - 1) * C;
      c1.dout = xs + i * d.act;
      err = launch_conv<LD_BN_RESID, EP_STATS>(c1, bd, s);
    }
    if (err != cudaSuccess) break;
    ConvParams c2 = p;  // a2 = conv2(PReLU(BN1(a1))), normalized on load; m2, v2
    c2.wimg = w2i + i * wsz;
    c2.src = a1;
    c2.lmv = st;
    c2.lgam = g1 + i * C;
    c2.lbet = b1 + i * C;
    c2.lal = al + i;
    c2.out = a2;
    c2.ticket = tickets + 2 * i + 1;
    c2.r0 = st + 2 * C;
    c2.r1 = st + 3 * C;
    err = launch_conv<LD_BN_PRELU, EP_STATS>(c2, bd, s);
  }
  if (err != cudaSuccess) return (int)err;
  // y = x_{n-1} + BN2(a2_{n-1})
  const float* st = stats + (size_t)(n - 1) * 4 * C;
  bn_apply_kernel<bf16, false, true><<<d.apply_grid, APPLY_THREADS, 0, s>>>(
      a2s + (n - 1) * d.act, st + 2 * C, g2 + (n - 1) * C, b2 + (n - 1) * C, nullptr,
      xs + (n - 1) * d.act, y, eps, C, d.act);
  return (int)cudaGetLastError();
}

int backward_bf16(const bf16* dy, const bf16* xs, const bf16* a1s, const bf16* a2s,
                  const float* stats, const bf16* w1i, const bf16* w2i, const float* g1,
                  const float* b1, const float* g2, const float* al, bf16* dx, float* dw1,
                  float* dw2, float* dg1, float* db1, float* dg2, float* db2, float* dal,
                  void* ws, long long ws_bytes, int n, int B, int H, int W, int C, float eps,
                  cudaStream_t s) {
  Dims d;
  if (!make_dims(n, B, H, W, C, &d)) return (int)cudaErrorInvalidValue;
  const Bf16Dims bd = bf16_dims(d, B);
  const WsBf16 wl = layout_bf16(d, bd, n, true);
  if ((size_t)ws_bytes < wl.total) return (int)cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(ws);
  bf16* da1 = reinterpret_cast<bf16*>(base + wl.da1);
  bf16* da2 = reinterpret_cast<bf16*>(base + wl.da2);
  bf16* h = reinterpret_cast<bf16*>(base + wl.h);
  float* dpre = reinterpret_cast<float*>(base + wl.dpre);
  float* part = reinterpret_cast<float*>(base + wl.part);
  float* wpart = reinterpret_cast<float*>(base + wl.wpart);
  unsigned* tickets = reinterpret_cast<unsigned*>(base + wl.ticket);
  const size_t wsz = (size_t)9 * C * C;
  const size_t wg_smem = wgrad_smem(bd.g);

  cudaError_t err = cudaMemsetAsync(tickets, 0, (size_t)wl.ntickets * 4, s);
  if (err != cudaSuccess) return (int)err;
  // the last block's BN2 sums of g = dy
  bn2_sums_kernel<<<d.part_grid, EW_THREADS, 0, s>>>(
      dy, a2s + (n - 1) * d.act, stats + (size_t)(n - 1) * 4 * C + 2 * C, eps, part,
      tickets + 2 * n, dg2 + (n - 1) * C, db2 + (n - 1) * C, C, d.P);
  err = cudaGetLastError();
  ConvParams p{};
  p.g = bd.g;
  p.part = part;
  p.eps = eps;
  p.nelem = (float)d.P;
  for (int j = n - 1; j >= 0 && err == cudaSuccess; --j) {
    const float* st = stats + (size_t)j * 4 * C;
    const bf16* a1 = a1s + j * d.act;
    const bf16* a2 = a2s + j * d.act;
    const bf16* gin = j == n - 1 ? dy : dx;  // the running cotangent g (dx holds it)

    // dgrad2 of da2 = BN2 backward of g (formed on load); its epilogue: the
    // PReLU backward, h, dpre and BN1's sums -> dg1, db1, dal
    ConvParams c2 = p;
    c2.wimg = w2i + j * wsz;
    c2.src = a2;
    c2.dsrc = gin;
    c2.lmv = st + 2 * C;
    c2.lgam = g2 + j * C;
    c2.ldg = dg2 + j * C;
    c2.ldb = db2 + j * C;
    c2.dout = da2;
    c2.out = dpre;
    c2.ea = a1;
    c2.emv = st;
    c2.egam = g1 + j * C;
    c2.ebet = b1 + j * C;
    c2.eal = al + j;
    c2.hout = h;
    c2.ticket = tickets + 2 * j;
    c2.r0 = dg1 + j * C;
    c2.r1 = db1 + j * C;
    c2.r2 = dal + j;
    err = launch_conv<LD_DA_T, EP_PRELU_BWD>(c2, bd, s);
    if (err != cudaSuccess) break;
    // dgrad1 of da1 = BN1 backward of dpre (formed on load); its epilogue:
    // g <- bf16(g + dgrad1) and block j-1's BN2 sums -> dg2, db2
    ConvParams c1 = p;
    c1.wimg = w1i + j * wsz;
    c1.src = a1;
    c1.dsrc = dpre;
    c1.lmv = st;
    c1.lgam = g1 + j * C;
    c1.ldg = dg1 + j * C;
    c1.ldb = db1 + j * C;
    c1.dout = da1;
    c1.out = dx;
    c1.resid = gin;
    if (j > 0) {
      c1.ea = a2s + (j - 1) * d.act;
      c1.emv = stats + (size_t)(j - 1) * 4 * C + 2 * C;
      c1.r0 = dg2 + (j - 1) * C;
      c1.r1 = db2 + (j - 1) * C;
    }
    c1.ticket = tickets + 2 * j + 1;
    err = launch_conv<LD_DA_F, EP_GRAD>(c1, bd, s);
    if (err != cudaSuccess) break;
    // both wgrads, then their split-K sums
    WgradParams wp{};
    wp.g = bd.g;
    wp.src[0] = xs + j * d.act;
    wp.src[1] = h;
    wp.dy[0] = da1;
    wp.dy[1] = da2;
    wp.part = wpart;
    wp.nsub = bd.nsub;
    err = launch_pdl<trunk_wgrad_wgmma>(dim3(bd.nchunks, 2, bd.ntc * bd.ntc),
                                        tw::WGRAD_THREADS, wg_smem, s, wp);
    if (err != cudaSuccess) break;
    wgrad_reduce2_kernel<<<(unsigned)((2 * wsz + APPLY_THREADS - 1) / APPLY_THREADS),
                           APPLY_THREADS, 0, s>>>(wpart, bd.nchunks, (long long)wsz,
                                                  dw1 + j * wsz, dw2 + j * wsz);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

// Workspace bytes of one call: forward (backward = 0) or backward (1).
extern "C" int packed_trunk_ws_bytes(int n, int B, int H, int W, int C, int esize,
                                     int backward, long long* out) {
  Dims d;
  if (!make_dims(n, B, H, W, C, &d) || (esize != 2 && esize != 4))
    return (int)cudaErrorInvalidValue;
  *out = (long long)(esize == 2 ? layout_bf16(d, bf16_dims(d, B), n, backward != 0).total
                                  : layout(d, esize, backward != 0).total);
  return 0;
}

// Kernel launches of one call (besides one copy or memset on the stream and
// one memset): f32 6n forward, 12n backward; bf16 2n + 1 forward (per block
// conv1, conv2; once, the last BN2 + residual apply), 4n + 1 backward (per
// block dgrad2, dgrad1, the two wgrads, their split-K sums; once, the last
// block's BN2 sums).
extern "C" int packed_trunk_launches(int n, int esize, int backward, long long* out) {
  if (n <= 0 || (esize != 2 && esize != 4)) return (int)cudaErrorInvalidValue;
  *out = esize == 4 ? (backward ? 12LL : 6LL) * n : (backward ? 4LL : 2LL) * n + 1;
  return 0;
}

// The wgmma work of one bf16 call in FLOP, counted from the kernels' own
// tiles (the design's floor): per conv, M tiles x N tiles x K chunks x 9
// taps x 4 m64n64k16; per wgrad pair, 2 x (C/64)^2 tiles x every 64-position
// sub-chunk x 9 taps x 4.
extern "C" int packed_trunk_bf16_mma_flops(int n, int B, int H, int W, int C, int backward,
                                           double* flops) {
  Dims d;
  if (!make_dims(n, B, H, W, C, &d)) return (int)cudaErrorInvalidValue;
  const Bf16Dims b = bf16_dims(d, B);
  const double conv = (double)b.mtiles * b.ntc * b.ntc * 36 * tw::MMA_FLOP;
  const double wgrad = 2.0 * b.ntc * b.ntc * b.mtiles * 36 * tw::MMA_FLOP;
  *flops = 2.0 * n * conv + (backward ? n * wgrad : 0.0);
  return 0;
}

// dynamic shared memory of one block of the bf16 conv and wgrad kernels
extern "C" int packed_trunk_conv_smem(int W, int C) {
  return (int)conv_smem(tw::make_geom(1, 1, W, C));
}
extern "C" int packed_trunk_wgrad_smem(int W, int C) {
  return (int)wgrad_smem(tw::make_geom(1, 1, W, C));
}

// x (B, H, W, C) NHWC; w1t, w2t f32: (n, 9, C, C) [block][tap][out][in],
// bf16: the ring images of kernels/packed_trunk.py `weight_image`; g1, b1,
// g2, b2 (n, C) f32; al (n,) f32. Writes y (B, H, W, C), the residuals xs,
// a1s, a2s (n, B, H, W, C) and stats (n, 4, C) f32 [m1, v1, m2, v2].
#define FWD_ARGS(T)                                                                  \
  const void *x, const void *w1t, const void *w2t, const void *g1, const void *b1,   \
      const void *g2, const void *b2, const void *al, void *y, void *xs, void *a1s,  \
      void *a2s, void *stats, void *ws, long long ws_bytes, int n, int B, int H,     \
      int W, int C, float eps, void *stream
#define FWD_CALL(T, FN)                                                              \
  FN(static_cast<const T*>(x), static_cast<const T*>(w1t),                   \
                   static_cast<const T*>(w2t), static_cast<const float*>(g1),              \
             static_cast<const float*>(b1), static_cast<const float*>(g2),           \
             static_cast<const float*>(b2), static_cast<const float*>(al),           \
             static_cast<T*>(y), static_cast<T*>(xs), static_cast<T*>(a1s),          \
             static_cast<T*>(a2s), static_cast<float*>(stats), ws, ws_bytes, n, B,   \
             H, W, C, eps, static_cast<cudaStream_t>(stream))

extern "C" int packed_trunk_fwd_bf16(FWD_ARGS(__nv_bfloat16)) {
  return FWD_CALL(__nv_bfloat16, forward_bf16);
}
extern "C" int packed_trunk_fwd_f32(FWD_ARGS(float)) {
  return FWD_CALL(float, trunk_forward<float>);
}

// dy (B, H, W, C); the residuals and stats of the forward; w1d, w2d the
// flipped, transposed (dgrad) kernels in the forward's layout (f32
// [block][tap][out][in], w1d[i][3 * ky + kx][ci][co] = w1[i][2-ky][2-kx][ci][co];
// bf16 their ring images).
// Writes dx (B, H, W, C), dw1, dw2 (n, 3, 3, C, C) HWIO f32, dg1, db1, dg2,
// db2 (n, C) f32 and dal (n,) f32.
#define BWD_ARGS(T)                                                                  \
  const void *dy, const void *xs, const void *a1s, const void *a2s,                  \
      const void *stats, const void *w1d, const void *w2d, const void *g1,           \
      const void *b1, const void *g2, const void *al, void *dx, void *dw1,           \
      void *dw2, void *dg1, void *db1, void *dg2, void *db2, void *dal, void *ws,    \
      long long ws_bytes, int n, int B, int H, int W, int C, float eps, void *stream
#define BWD_CALL(T, FN)                                                              \
  FN(static_cast<const T*>(dy), static_cast<const T*>(xs),                  \
              static_cast<const T*>(a1s), static_cast<const T*>(a2s),                \
              static_cast<const float*>(stats), static_cast<const T*>(w1d),          \
              static_cast<const T*>(w2d), static_cast<const float*>(g1),             \
              static_cast<const float*>(b1), static_cast<const float*>(g2),          \
              static_cast<const float*>(al), static_cast<T*>(dx),                    \
              static_cast<float*>(dw1), static_cast<float*>(dw2),                    \
              static_cast<float*>(dg1), static_cast<float*>(db1),                    \
              static_cast<float*>(dg2), static_cast<float*>(db2),                    \
              static_cast<float*>(dal), ws, ws_bytes, n, B, H, W, C, eps,            \
              static_cast<cudaStream_t>(stream))

extern "C" int packed_trunk_bwd_bf16(BWD_ARGS(__nv_bfloat16)) {
  return BWD_CALL(__nv_bfloat16, backward_bf16);
}
extern "C" int packed_trunk_bwd_f32(BWD_ARGS(float)) {
  return BWD_CALL(float, trunk_backward<float>);
}

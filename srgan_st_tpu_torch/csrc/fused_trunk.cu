// Whole residual trunk forward in one persistent launch: kernel K6.
//
// Replaces the Pallas kernel srgan_st_tpu/kernels/fused_trunk.py `_kernel`
// (`_fwd_pallas`), which runs all n residual blocks
//
//   x <- x + BN2(conv2(PReLU(BN1(conv1(x)))))
//
// in one call with the running activation kept on chip, and streams out
// the residuals of its backward: the block inputs xs, both preactivations
// a1s, a2s (n, B, H, W, C) and the per-block batch statistics (n, 4, C) f32
// [m1, v1, m2, v2]. Numerics follow the Pallas kernel, T being the compute
// dtype: a = T(conv acc f32); m, v = f32 biased moments of a
// (v = max(E[a^2] - m^2, 0)); out = ((a - T(m)) * T(rsqrt(v + eps))) * T(gamma)
// + T(beta), each step rounded to T; PReLU (predicate in f32) and the
// residual add in T. These are K4's roundings (csrc/packed_trunk.cu), and
// the plain version is K4's.
//
// Batch-stat BatchNorm needs a reduction over the whole batch between a
// conv and its normalize, twice per block. The TPU kernel walks its
// sequential grid; here ONE cooperative launch (cudaLaunchCooperative-
// Kernel, grid no larger than the co-resident block count) separates the
// convs by grid barriers (cooperative_groups::this_grid().sync()).
//
// bf16 design (`fused_trunk_wgmma`): K4's conv tile (csrc/trunk_conv_tile.cuh,
// wgmma m64n64k16 over the zero-padded grid) in a persistent loop, 2n grid
// barriers a call (32 at n = 16). Per conv, each CTA walks the (M tile,
// N tile) jobs at a stride of the grid; the loader forms the conv's input
// as K4's does (block 0's conv1 copies x; a later conv1 forms x + BN2(a2)
// of the block before and writes xs; conv2 forms PReLU(BN1(a1))), from the
// moments and the BatchNorm's gamma and beta that each CTA keeps in shared
// memory, and the epilogue stores a and the tile's BN partials. As soon as a tile's
// products are done, its CTA issues the bulk copy of its next tile's
// weights, which need not wait for the barrier. After the barrier every
// CTA sums the partials in tile order, in double (K4's last-ticket
// reduction, redundantly in each CTA, so that no second barrier is needed:
// the next conv's loads read every channel's moments), and block 0 writes
// them to stats. The partials alternate between two buffers, so that a
// CTA's next conv never overwrites what a slower CTA still sums. After the
// last barrier, y = x + BN2(a2) in the same launch; xs[0] = x is copied in
// it too. The tile, its partials and their order are K4's, so the five
// outputs have K4's bits.
//
// Measured at the training shape (chip_smoke.py, its probe of one launch,
// one H100 80GB HBM3 at 700 W): ~17 us a conv, as K4's launches take: the
// tiles ~8.5 us, the barrier ~2.8 us (its wait for the slowest block
// included), the 169-partial sums ~5.7 us.
// One summing block behind an integer ticket and a flag, a staged copy of
// the partials, and a parallel sum exact where the partials allow it were
// tried and gained nothing at this shape: the launch boundaries are not
// what K4's convs lose time to.
//
// f32 design (`fused_trunk_kernel`, the algorithm check, as K4 keeps its
// SIMT tiles for f32): three phases per conv between grid barriers, 6n - 1
// a call: conv (csrc/trunk_conv.cuh's mma tile, one partial per tile),
// stats (one thread per channel sums the partials in order, in double),
// apply (the normalize, + PReLU into the conv2 input h, or + the residual
// into the next block input).
//
// Every sum runs in a fixed order and there are no float atomics, so two
// runs give the same bits. The 1.2 MB activation stays in the 50 MB L2.
//
// The probe (both kernels, optional): each block adds one to its first
// word at every grid barrier it passes, so that a launch's barriers are
// counted, not assumed; the bf16 kernel also stamps each block's convs
// with %globaltimer (`FusedParams::probe`).
//
// What bounds it on an H100: at the training shape (16, 24, 24, 64),
// n = 16, the call moves 61.4 MB (x, weights, y, the saved residuals and
// stats) and does 21.7 GFLOP of bf16 conv work: 0.018 ms of memory, 0.022
// ms at the 989 TFLOP/s bf16 peak, so operations bound it. At that shape
// the 169 tiles of a conv run in one wave (2 CTAs an SM), so each conv
// costs one tile's latency chain, the barrier and the moment sums.
#include <cooperative_groups.h>

#include "trunk_conv_tile.cuh"

namespace cg = cooperative_groups;
using namespace srgan;

namespace {

using u64 = unsigned long long;

// null, or the probe: one more grid barrier passed by this block
__device__ __forceinline__ void count_sync(u64* probe) {
  if (probe != nullptr && threadIdx.x == 0) atomicAdd(probe, 1ull);
}

struct Params {
  const float* x;
  const float* w1t;  // (n, 9, C, C) [block][tap][out][in]
  const float* w2t;
  const float *g1, *b1, *g2, *b2, *al;  // (n, C) x 4, (n,)
  float* y;
  float* xs;  // (n, B, H, W, C)
  float* a1s;
  float* a2s;
  float* stats;  // (n, 4, C)
  float* h;      // workspace: the conv2 input, (B, H, W, C)
  float* part;   // workspace: (pixel tiles, 2, C)
  u64* probe;    // null, or [0] the grid barriers passed, summed over blocks
  int n, H, W, C;
  long long P;
  float eps;
};

// The conv phase: acc into a, and each tile's per-channel sums of a and
// a^2 over its pixels into part[pixel tile][0 / 1][c].
__device__ void conv_phase(const Params& p, const float* src, const float* wt, float* a,
                           float* As, float* Bs, float (*tile)[TILE + 1]) {
  const int ptiles = (int)((p.P + TILE - 1) / TILE), ctiles = p.C / TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  for (int job = blockIdx.x; job < ptiles * ctiles; job += gridDim.x) {
    const int pt = job / ctiles, n0 = (job % ctiles) * TILE;
    const long long p0 = (long long)pt * TILE;
    float acc[2][4][4];
    conv_tile<float>(src, wt, p.H, p.W, p.C, p.P, p0, n0, As, Bs, acc);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm + m * 16 + g + 8 * half;
        const long long px = p0 + r;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int cl = wn + n * 8 + 2 * t;
          const float v0 = acc[m][n][2 * half], v1 = acc[m][n][2 * half + 1];
          tile[r][cl] = px < p.P ? v0 : 0.f;
          tile[r][cl + 1] = px < p.P ? v1 : 0.f;
          if (px < p.P) store2(a + (size_t)px * p.C + n0 + cl, v0, v1);
        }
      }
    __syncthreads();
    // threads 0-63: sum a of channel n0 + tid; 64-127: sum a^2 of tid - 64
    const int c = threadIdx.x & 63, k = threadIdx.x >> 6;
    float s = 0.f;
    for (int r = 0; r < TILE; ++r) {
      const float v = tile[r][c];
      s = __fadd_rn(s, k ? __fmul_rn(v, v) : v);
    }
    p.part[((size_t)pt * 2 + k) * p.C + n0 + c] = s;
    __syncthreads();  // the tile is free for the next job
  }
}

// The stats phase: the moments of channel c from the partials, in order.
__device__ void stats_phase(const Params& p, float* mv) {
  const int ptiles = (int)((p.P + TILE - 1) / TILE);
  const float nelem = (float)p.P;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < p.C;
       c += gridDim.x * blockDim.x) {
    double s = 0.0, ss = 0.0;
    for (int pt = 0; pt < ptiles; ++pt) {
      s += p.part[((size_t)pt * 2) * p.C + c];
      ss += p.part[((size_t)pt * 2 + 1) * p.C + c];
    }
    bn_moments((float)s, (float)ss, nelem, mv + c, mv + p.C + c);
  }
}

// The apply phase: out = BN(a) -> PReLU (PRELU) or BN(a) + resid.
template <bool PRELU>
__device__ void apply_phase(const Params& p, const float* a, const float* mv,
                            const float* gam, const float* bet, const float* alpha,
                            const float* resid, float* out) {
  const long long total = p.P * p.C;
  const float al = PRELU ? *alpha : 0.f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = bn_out<float, PRELU, !PRELU>(a[i], (int)(i % p.C), p.C, mv, gam, bet, p.eps, al,
                                          PRELU ? 0.f : resid[i]);
}

__global__ void __launch_bounds__(CONV_THREADS) fused_trunk_kernel(Params p) {
  constexpr int KS = chunk_stride<float>();
  __shared__ __align__(16) float As[TILE * KS];
  __shared__ __align__(16) float Bs[TILE * KS];
  __shared__ float tile[TILE][TILE + 1];
  cg::grid_group grid = cg::this_grid();
  const long long act = p.P * p.C;
  const size_t wsz = (size_t)9 * p.C * p.C;
  const auto sync = [&] {
    grid.sync();
    count_sync(p.probe);
  };

  // xs[0] = x: a copy nothing reads in this launch (block 0 reads x)
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < act;
       i += (long long)gridDim.x * blockDim.x)
    p.xs[i] = p.x[i];

  for (int i = 0; i < p.n; ++i) {
    const float* xi = i == 0 ? p.x : p.xs + i * act;
    float* a1 = p.a1s + i * act;
    float* a2 = p.a2s + i * act;
    float* st = p.stats + (size_t)i * 4 * p.C;
    float* xo = i + 1 < p.n ? p.xs + (i + 1) * act : p.y;

    conv_phase(p, xi, p.w1t + i * wsz, a1, As, Bs, tile);
    sync();
    stats_phase(p, st);
    sync();
    apply_phase<true>(p, a1, st, p.g1 + i * p.C, p.b1 + i * p.C, p.al + i, nullptr, p.h);
    sync();
    conv_phase(p, p.h, p.w2t + i * wsz, a2, As, Bs, tile);
    sync();
    stats_phase(p, st + 2 * p.C);
    sync();
    apply_phase<false>(p, a2, st + 2 * p.C, p.g2 + i * p.C, p.b2 + i * p.C, nullptr, xi, xo);
    if (i + 1 < p.n) sync();
  }
}

// ------------------------------------------------------------------ bf16
struct FusedParams {
  tw::Geom g;
  const tw::bf16* x;
  const tw::bf16 *w1i, *w2i;  // ring images (kernels/packed_trunk.py `weight_image`)
  const float *g1, *b1, *g2, *b2, *al;
  tw::bf16 *y, *xs, *a1s, *a2s;
  float* stats;  // (n, 4, C)
  float* part;   // workspace: 2 buffers of (M tiles, 2, C) partials
  int n, mtiles;
  long long act;
  float eps, nelem;
  // null, or [0] the grid barriers passed, summed over blocks, then
  // (grid, 2n, 4) %globaltimer stamps of each CTA's convs: its first tile
  // starts, its last epilogue ends, the grid barrier releases it, the
  // moments and the next BatchNorm's gamma and beta are in shared memory
  u64* probe;
};

__device__ __forceinline__ void stamp(const FusedParams& f, int k, int i) {
  if (f.probe != nullptr && threadIdx.x == 0) {
    u64 t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    f.probe[1 + ((size_t)blockIdx.x * 2 * f.n + k) * 4 + i] = t;
  }
}

// the tile's shared memory, then the moments [m (C), v (C)] of the conv
// before and the gamma and beta [2][C] of their BatchNorm
__host__ __device__ inline size_t fused_smem(const tw::Geom& g) {
  return tw::conv_smem(g) + (size_t)4 * g.C * 4;
}

// conv k of the call (conv1 of block k / 2 for even k, conv2 for odd k)
// as K4 launches it: its weights, loader, output and partials buffer; the
// loader forms its BatchNorm constants from `mv` and `gb` in shared memory
__device__ __forceinline__ tw::ConvParams conv_of(const FusedParams& f, int k, const float* mv,
                                                  const float* gb) {
  const int i = k >> 1, C = f.g.C;
  const size_t wsz = (size_t)9 * C * C;
  tw::ConvParams p{};
  p.g = f.g;
  p.part = f.part + (size_t)(k & 1) * f.mtiles * 2 * C;
  p.eps = f.eps;
  p.nelem = f.nelem;
  p.lmv = mv;
  p.lgam = gb;
  p.lbet = gb + C;
  if (k & 1) {  // a2 = conv2(PReLU(BN1(a1))), normalized on load
    p.wimg = f.w2i + i * wsz;
    p.src = f.a1s + i * f.act;
    p.lal = f.al + i;
    p.out = f.a2s + i * f.act;
  } else {  // a1 = conv1(x_i)
    p.wimg = f.w1i + i * wsz;
    p.out = f.a1s + i * f.act;
    if (i == 0) {
      p.src = f.x;
    } else {  // x_i = x_{i-1} + BN2(a2_{i-1}), formed on load, written to xs[i]
      p.src = f.a2s + (i - 1) * f.act;
      p.dsrc = f.xs + (i - 1) * f.act;
      p.dout = f.xs + i * f.act;
    }
  }
  return p;
}

__global__ void __launch_bounds__(tw::CONV_THREADS)
    fused_trunk_wgmma(const __grid_constant__ FusedParams f) {
  using namespace tw;
  extern __shared__ __align__(128) unsigned char smem[];
  const Geom& g = f.g;
  const TileSmem s = tile_smem(smem, g);
  const int C = g.C, jobs = f.mtiles * (C / CK), nconv = 2 * f.n, tid = threadIdx.x;
  float* mv = reinterpret_cast<float*>(smem + conv_smem(g));  // [2][C]
  float* gb = mv + 2 * C;                                     // [2][C]
  cg::grid_group grid = cg::this_grid();

  if (tid == 0) {
    for (int st = 0; st < s.stages; ++st) hop::mbar_init(&s.bar[st], 1);
    hop::mbar_fence_init();
    const ConvParams p0 = conv_of(f, 0, mv, gb);
    for (int kc = 0; kc < s.stages; ++kc) issue_weights(p0, s, blockIdx.x / f.mtiles, kc);
  }
  // xs[0] = x: nothing in this launch reads it before a grid barrier
  // (block 0's conv1 reads x)
  for (long long i = (long long)blockIdx.x * blockDim.x + tid; i < f.act / 8;
       i += (long long)gridDim.x * blockDim.x)
    reinterpret_cast<uint4*>(f.xs)[i] = reinterpret_cast<const uint4*>(f.x)[i];
  __syncthreads();  // barriers initialised

  unsigned ph = 0;
  for (int k = 0; k < nconv; ++k) {
    const ConvParams p = conv_of(f, k, mv, gb);
    stamp(f, k, 0);
    for (int job = blockIdx.x; job < jobs; job += gridDim.x) {
      const int mt = job % f.mtiles, nt = job / f.mtiles;
      const long long q0 = (long long)mt * MT;
      float acc[32];
      if (k & 1)
        conv_mainloop<LD_BN_PRELU>(p, s, q0, nt, acc, ph);
      else if (k == 0)
        conv_mainloop<LD_COPY>(p, s, q0, nt, acc, ph);
      else
        conv_mainloop<LD_BN_RESID>(p, s, q0, nt, acc, ph);
      // the ring is free: the next tile's weights (this conv's next job, or
      // the next conv's first) do not wait for the epilogue or the barrier
      int next = job + (int)gridDim.x, kn = k;
      if (next >= jobs) {
        next = blockIdx.x;
        ++kn;
      }
      if (tid == 0 && kn < nconv) {
        const ConvParams pn = conv_of(f, kn, mv, gb);
        for (int kc = 0; kc < s.stages; ++kc) issue_weights(pn, s, next / f.mtiles, kc);
      }
      conv_epilogue<EP_STATS>(p, s, mt, nt, acc);
    }
    stamp(f, k, 1);
    grid.sync();
    count_sync(f.probe);
    stamp(f, k, 2);
    // the conv's moments from every tile's partials in tile order, in
    // double, as K4's last tile sums them (each CTA for itself, so that no
    // second barrier is needed: the next conv's loads read every channel);
    // the windows are free scratch
    float* st = f.stats + (size_t)(k >> 1) * 4 * C + (k & 1) * 2 * C;
    reduce_partials<2, 64>(p.part, f.mtiles, C, reinterpret_cast<float*>(s.wins),
                           [&](int c, const float* r) {
                             bn_moments(r[0], r[1], f.nelem, mv + c, mv + C + c);
                             if (blockIdx.x == 0) {
                               st[c] = mv[c];
                               st[C + c] = mv[C + c];
                             }
                           });
    // the gamma and beta of the moments' BatchNorm (BN1 of this block after
    // conv1, else BN2), which the next conv's loader reads beside them
    const int i = k >> 1;
    const float* gam = (k & 1 ? f.g2 : f.g1) + i * C;
    const float* bet = (k & 1 ? f.b2 : f.b1) + i * C;
    for (int c = tid; c < C; c += blockDim.x) {
      gb[c] = gam[c];
      gb[C + c] = bet[c];
    }
    __syncthreads();  // the moments, gamma and beta
    stamp(f, k, 3);
  }
  // y = x_{n-1} + BN2(a2_{n-1}), as K4's last apply
  const int l = f.n - 1;
  const bf16* a2 = f.a2s + l * f.act;
  const bf16* xl = f.xs + l * f.act;
  for (long long i = (long long)blockIdx.x * blockDim.x + tid; i < f.act;
       i += (long long)gridDim.x * blockDim.x)
    f.y[i] = bn_out<bf16, false, true>(to_f(a2[i]), (int)(i % C), C, mv, gb, gb + C, f.eps,
                                       0.f, to_f(xl[i]));
}

// ------------------------------------------------------------------ host
size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

bool dims_ok(int n, int B, int H, int W, int C) {
  return n > 0 && B > 0 && H > 0 && W > 0 && C > 0 && C % TILE == 0 && C <= 1024 &&
         tw::grid_fits(B, H, W);
}

int mtiles_of(const tw::Geom& g) { return (int)((g.Q + tw::MT - 1) / tw::MT); }

// workspace. f32: h (the conv2 input), then the partials (pixel tiles, 2,
// C); bf16: two buffers of partials (M tiles, 2, C), nothing else.
size_t ws_total(int B, int H, int W, int C, int esize, size_t* part_off) {
  if (esize == 2) {
    *part_off = 0;
    return align256((size_t)2 * mtiles_of(tw::make_geom(B, H, W, C)) * 2 * C * 4);
  }
  const long long P = (long long)B * H * W;
  *part_off = align256((size_t)P * C * esize);
  return *part_off + align256((size_t)((P + TILE - 1) / TILE) * 2 * C * 4);
}

// The grid of a cooperative launch of `kernel` with `smem` bytes of
// dynamic shared memory: min(jobs, co-resident blocks).
cudaError_t coop_grid(const void* kernel, long long jobs, size_t smem, int* grid) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, CONV_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (!coop || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = (int)(jobs < (long long)sms * per_sm ? jobs : (long long)sms * per_sm);
  return cudaSuccess;
}

// The cooperative launch of `kernel` on min(jobs, co-resident blocks)
// blocks, after checking that the probe (if any) holds `probe_need(grid)`
// words.
template <typename Need>
int launch_coop(const void* kernel, long long jobs, size_t smem, void** args, const void* probe,
                long long probe_len, Need probe_need, void* stream, int* grid_out) {
  int grid = 0;
  cudaError_t err = coop_grid(kernel, jobs, smem, &grid);
  if (err != cudaSuccess) return (int)err;
  if (probe != nullptr && probe_len < probe_need(grid)) return (int)cudaErrorInvalidValue;
  if (grid_out) *grid_out = grid;
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(CONV_THREADS), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int forward_f32(const void* x, const void* w1t, const void* w2t, const void* g1,
                const void* b1, const void* g2, const void* b2, const void* al, void* y,
                void* xs, void* a1s, void* a2s, void* stats, void* ws, long long ws_bytes,
                int n, int B, int H, int W, int C, float eps, void* stream, int* grid_out,
                void* probe, long long probe_len) {
  if (!dims_ok(n, B, H, W, C)) return (int)cudaErrorInvalidValue;
  size_t part_off;
  if ((size_t)ws_bytes < ws_total(B, H, W, C, 4, &part_off)) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const float*>(x);
  p.w1t = static_cast<const float*>(w1t);
  p.w2t = static_cast<const float*>(w2t);
  p.g1 = static_cast<const float*>(g1);
  p.b1 = static_cast<const float*>(b1);
  p.g2 = static_cast<const float*>(g2);
  p.b2 = static_cast<const float*>(b2);
  p.al = static_cast<const float*>(al);
  p.y = static_cast<float*>(y);
  p.xs = static_cast<float*>(xs);
  p.a1s = static_cast<float*>(a1s);
  p.a2s = static_cast<float*>(a2s);
  p.stats = static_cast<float*>(stats);
  p.h = static_cast<float*>(ws);
  p.part = reinterpret_cast<float*>(static_cast<unsigned char*>(ws) + part_off);
  p.probe = static_cast<u64*>(probe);
  p.n = n;
  p.H = H;
  p.W = W;
  p.C = C;
  p.P = (long long)B * H * W;
  p.eps = eps;
  void* args[] = {&p};
  const long long tiles = (p.P + TILE - 1) / TILE * (C / TILE);
  return launch_coop((const void*)fused_trunk_kernel, tiles, 0, args, probe, probe_len,
                     [](int) { return 1LL; }, stream, grid_out);
}

int forward_bf16(const void* x, const void* w1i, const void* w2i, const void* g1,
                 const void* b1, const void* g2, const void* b2, const void* al, void* y,
                 void* xs, void* a1s, void* a2s, void* stats, void* ws, long long ws_bytes,
                 int n, int B, int H, int W, int C, float eps, void* stream, int* grid_out,
                 void* probe, long long probe_len) {
  using tw::bf16;
  if (!dims_ok(n, B, H, W, C)) return (int)cudaErrorInvalidValue;
  size_t part_off;
  if ((size_t)ws_bytes < ws_total(B, H, W, C, 2, &part_off)) return (int)cudaErrorInvalidValue;
  FusedParams f{};
  f.g = tw::make_geom(B, H, W, C);
  f.x = static_cast<const bf16*>(x);
  f.w1i = static_cast<const bf16*>(w1i);
  f.w2i = static_cast<const bf16*>(w2i);
  f.g1 = static_cast<const float*>(g1);
  f.b1 = static_cast<const float*>(b1);
  f.g2 = static_cast<const float*>(g2);
  f.b2 = static_cast<const float*>(b2);
  f.al = static_cast<const float*>(al);
  f.y = static_cast<bf16*>(y);
  f.xs = static_cast<bf16*>(xs);
  f.a1s = static_cast<bf16*>(a1s);
  f.a2s = static_cast<bf16*>(a2s);
  f.stats = static_cast<float*>(stats);
  f.part = static_cast<float*>(ws);
  f.n = n;
  f.mtiles = mtiles_of(f.g);
  f.act = (long long)B * H * W * C;
  f.eps = eps;
  f.nelem = (float)((long long)B * H * W);
  f.probe = static_cast<u64*>(probe);
  void* args[] = {&f};
  return launch_coop((const void*)fused_trunk_wgmma, (long long)f.mtiles * (C / tw::CK),
                     fused_smem(f.g), args, probe, probe_len,
                     [n](int grid) { return 1 + (long long)grid * 2 * n * 4; }, stream,
                     grid_out);
}

}  // namespace

// Workspace bytes of one call.
extern "C" int fused_trunk_ws_bytes(int n, int B, int H, int W, int C, int esize,
                                    long long* out) {
  if (!dims_ok(n, B, H, W, C) || (esize != 2 && esize != 4)) return (int)cudaErrorInvalidValue;
  size_t part_off;
  *out = (long long)ws_total(B, H, W, C, esize, &part_off);
  return 0;
}

// dynamic shared memory of one block of the bf16 kernel
extern "C" int fused_trunk_bf16_smem(int W, int C) {
  return (int)fused_smem(tw::make_geom(1, 1, W, C));
}

// x (B, H, W, C) NHWC; w1t, w2t f32: (n, 9, C, C) [block][tap][out][in],
// bf16: the ring images of kernels/packed_trunk.py `weight_image`; g1, b1,
// g2, b2 (n, C) f32; al (n,) f32. Writes y (B, H, W, C), the residuals xs,
// a1s, a2s (n, B, H, W, C), stats (n, 4, C) f32 [m1, v1, m2, v2] and, in
// grid_out, the number of blocks launched. `probe`: null, or probe_len
// u64, zeroed: [0] gets the grid barriers passed, summed over the blocks
// (f32: 6n - 1 a block, after each conv, stats and apply phase but the
// last; bf16: 2n, after each conv); the bf16 kernel also writes (grid,
// 2n, 4) stamps after it (`FusedParams::probe`), so it needs 1 + grid * 8n
// words. A shorter probe is refused.
#define FUSED_ARGS                                                                   \
  const void *x, const void *w1t, const void *w2t, const void *g1, const void *b1,   \
      const void *g2, const void *b2, const void *al, void *y, void *xs, void *a1s,  \
      void *a2s, void *stats, void *ws, long long ws_bytes, int n, int B, int H,     \
      int W, int C, float eps, void *stream, int *grid_out, void *probe,             \
      long long probe_len
#define FUSED_CALL(FN)                                                               \
  FN(x, w1t, w2t, g1, b1, g2, b2, al, y, xs, a1s, a2s, stats, ws, ws_bytes, n, B, H, W, \
     C, eps, stream, grid_out, probe, probe_len)

extern "C" int fused_trunk_fwd_bf16(FUSED_ARGS) { return FUSED_CALL(forward_bf16); }
extern "C" int fused_trunk_fwd_f32(FUSED_ARGS) { return FUSED_CALL(forward_f32); }

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
// Design. Batch-stat BatchNorm needs a reduction over the whole batch
// between a conv and its normalize, twice per block. The TPU kernel walks
// its sequential grid; here ONE cooperative launch (cudaLaunchCooperative-
// Kernel, grid no larger than the co-resident block count) moves through
// three phases per conv, separated by grid barriers
// (cooperative_groups::this_grid().sync()), 96 at n = 16:
//   conv   every block takes 64-pixel x 64-channel tiles of the 3x3 conv
//          (csrc/trunk_conv.cuh, the tile K4 uses), stores T(acc) as the
//          saved preactivation, and writes the tile's per-channel sums of a
//          and a^2 over its 64 pixels, in pixel order, as one partial;
//   stats  one thread per channel sums the partials over the pixel tiles
//          in order (in double): the moments, written to stats;
//   apply  the normalize (+ PReLU into the conv2 input h, or + the residual
//          into the next block input xs[i+1], y after the last block).
// Every sum runs in a fixed order and there are no float atomics, so two
// runs give the same bits. The 1.2 MB activation stays in the 50 MB L2
// between phases.
//
// What bounds it on an H100: at the training shape (16, 24, 24, 64),
// n = 16, the call moves 61.4 MB (x, weights, y, the saved residuals and
// stats) and does 21.7 GFLOP of bf16 conv work: 0.018 ms of memory, 0.022
// ms at the 989 TFLOP/s bf16 peak, so operations bound it; this first
// version is bound by the 96 barriers and the 144-tile conv phases, which
// fill at most 144 of the 132 x k co-resident blocks.
#include <cooperative_groups.h>

#include "trunk_conv.cuh"

namespace cg = cooperative_groups;
using namespace srgan;

namespace {

template <typename T>
struct Params {
  const T* x;
  const T* w1t;  // (n, 9, C, C) [block][tap][out][in]
  const T* w2t;
  const float *g1, *b1, *g2, *b2, *al;  // (n, C) x 4, (n,)
  T* y;
  T* xs;  // (n, B, H, W, C)
  T* a1s;
  T* a2s;
  float* stats;  // (n, 4, C)
  T* h;          // workspace: the conv2 input, (B, H, W, C)
  float* part;   // workspace: (pixel tiles, 2, C)
  int n, H, W, C;
  long long P;
  float eps;
};

// The conv phase: T(acc) into a, and each tile's per-channel sums of a and
// a^2 over its pixels into part[pixel tile][0 / 1][c].
template <typename T>
__device__ void conv_phase(const Params<T>& p, const T* src, const T* wt, T* a, T* As,
                           T* Bs, float (*tile)[TILE + 1]) {
  const int ptiles = (int)((p.P + TILE - 1) / TILE), ctiles = p.C / TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  for (int job = blockIdx.x; job < ptiles * ctiles; job += gridDim.x) {
    const int pt = job / ctiles, n0 = (job % ctiles) * TILE;
    const long long p0 = (long long)pt * TILE;
    float acc[2][4][4];
    conv_tile<T>(src, wt, p.H, p.W, p.C, p.P, p0, n0, As, Bs, acc);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm + m * 16 + g + 8 * half;
        const long long px = p0 + r;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int cl = wn + n * 8 + 2 * t;
          const float v0 = rnd<T>(acc[m][n][2 * half]);
          const float v1 = rnd<T>(acc[m][n][2 * half + 1]);
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
template <typename T>
__device__ void stats_phase(const Params<T>& p, float* mv) {
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

// The apply phase: out = BN(a) -> PReLU (PRELU) or BN(a) + resid, in T.
template <typename T, bool PRELU>
__device__ void apply_phase(const Params<T>& p, const T* a, const float* mv,
                            const float* gam, const float* bet, const float* alpha,
                            const T* resid, T* out) {
  const long long total = p.P * p.C;
  float alT = 0.f;
  if constexpr (PRELU) alT = rnd<T>(*alpha);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = bn_out<T, PRELU, !PRELU>(to_f(a[i]), (int)(i % p.C), p.C, mv, gam, bet, p.eps,
                                      alT, PRELU ? 0.f : to_f(resid[i]));
}

template <typename T>
__global__ void __launch_bounds__(CONV_THREADS) fused_trunk_kernel(Params<T> p) {
  constexpr int KS = chunk_stride<T>();
  __shared__ __align__(16) T As[TILE * KS];
  __shared__ __align__(16) T Bs[TILE * KS];
  __shared__ float tile[TILE][TILE + 1];
  cg::grid_group grid = cg::this_grid();
  const long long act = p.P * p.C;
  const size_t wsz = (size_t)9 * p.C * p.C;

  // xs[0] = x: a copy nothing reads in this launch (block 0 reads x)
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < act;
       i += (long long)gridDim.x * blockDim.x)
    p.xs[i] = p.x[i];

  for (int i = 0; i < p.n; ++i) {
    const T* xi = i == 0 ? p.x : p.xs + i * act;
    T* a1 = p.a1s + i * act;
    T* a2 = p.a2s + i * act;
    float* st = p.stats + (size_t)i * 4 * p.C;
    T* xo = i + 1 < p.n ? p.xs + (i + 1) * act : p.y;

    conv_phase<T>(p, xi, p.w1t + i * wsz, a1, As, Bs, tile);
    grid.sync();
    stats_phase<T>(p, st);
    grid.sync();
    apply_phase<T, true>(p, a1, st, p.g1 + i * p.C, p.b1 + i * p.C, p.al + i, nullptr, p.h);
    grid.sync();
    conv_phase<T>(p, p.h, p.w2t + i * wsz, a2, As, Bs, tile);
    grid.sync();
    stats_phase<T>(p, st + 2 * p.C);
    grid.sync();
    apply_phase<T, false>(p, a2, st + 2 * p.C, p.g2 + i * p.C, p.b2 + i * p.C, nullptr,
                          xi, xo);
    if (i + 1 < p.n) grid.sync();
  }
}

size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

bool dims_ok(int n, int B, int H, int W, int C) {
  return n > 0 && B > 0 && H > 0 && W > 0 && C > 0 && C % TILE == 0 && C <= 1024;
}

// workspace: h (T), then the partials (pixel tiles, 2, C) f32
size_t ws_total(int B, int H, int W, int C, int esize, size_t* part_off) {
  const long long P = (long long)B * H * W;
  *part_off = align256((size_t)P * C * esize);
  return *part_off + align256((size_t)((P + TILE - 1) / TILE) * 2 * C * 4);
}

template <typename T>
int forward(const void* x, const void* w1t, const void* w2t, const void* g1,
            const void* b1, const void* g2, const void* b2, const void* al, void* y,
            void* xs, void* a1s, void* a2s, void* stats, void* ws, long long ws_bytes,
            int n, int B, int H, int W, int C, float eps, void* stream, int* grid_out) {
  if (!dims_ok(n, B, H, W, C)) return (int)cudaErrorInvalidValue;
  size_t part_off;
  if ((size_t)ws_bytes < ws_total(B, H, W, C, sizeof(T), &part_off))
    return (int)cudaErrorInvalidValue;
  Params<T> p;
  p.x = static_cast<const T*>(x);
  p.w1t = static_cast<const T*>(w1t);
  p.w2t = static_cast<const T*>(w2t);
  p.g1 = static_cast<const float*>(g1);
  p.b1 = static_cast<const float*>(b1);
  p.g2 = static_cast<const float*>(g2);
  p.b2 = static_cast<const float*>(b2);
  p.al = static_cast<const float*>(al);
  p.y = static_cast<T*>(y);
  p.xs = static_cast<T*>(xs);
  p.a1s = static_cast<T*>(a1s);
  p.a2s = static_cast<T*>(a2s);
  p.stats = static_cast<float*>(stats);
  p.h = static_cast<T*>(ws);
  p.part = reinterpret_cast<float*>(static_cast<unsigned char*>(ws) + part_off);
  p.n = n;
  p.H = H;
  p.W = W;
  p.C = C;
  p.P = (long long)B * H * W;
  p.eps = eps;

  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_trunk_kernel<T>,
                                                        CONV_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long tiles = (p.P + TILE - 1) / TILE * (C / TILE);
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  if (grid_out) *grid_out = grid;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)fused_trunk_kernel<T>, dim3(grid),
                                    dim3(CONV_THREADS), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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

// x (B, H, W, C) NHWC; w1t, w2t (n, 9, C, C) [block][tap][out][in]; g1, b1,
// g2, b2 (n, C) f32; al (n,) f32. Writes y (B, H, W, C), the residuals xs,
// a1s, a2s (n, B, H, W, C), stats (n, 4, C) f32 [m1, v1, m2, v2] and, in
// grid_out, the number of blocks launched.
#define FUSED_ARGS                                                                   \
  const void *x, const void *w1t, const void *w2t, const void *g1, const void *b1,   \
      const void *g2, const void *b2, const void *al, void *y, void *xs, void *a1s,  \
      void *a2s, void *stats, void *ws, long long ws_bytes, int n, int B, int H,     \
      int W, int C, float eps, void *stream, int *grid_out
#define FUSED_CALL(T)                                                                \
  forward<T>(x, w1t, w2t, g1, b1, g2, b2, al, y, xs, a1s, a2s, stats, ws, ws_bytes, n, \
             B, H, W, C, eps, stream, grid_out)

extern "C" int fused_trunk_fwd_bf16(FUSED_ARGS) { return FUSED_CALL(__nv_bfloat16); }
extern "C" int fused_trunk_fwd_f32(FUSED_ARGS) { return FUSED_CALL(float); }

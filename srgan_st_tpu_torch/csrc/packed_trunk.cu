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
// each direction moves ~60 MB (the saved residuals) and does 22-44 GFLOP of
// bf16 conv work, ~20 us and ~22-44 us at the card's peaks: neither is the
// limit of this first version, which is launch- and sync-bound. Batch-stat
// BN needs a reduction over the whole batch between a conv and its
// normalize, so each block is a fixed sequence of launches on the stream,
// 6 forward and 12 backward (96 and 192 at n = 16), the 1.2 MB activation
// staying in the 50 MB L2 between them. Convs are warp tile products
// (tensor-core mma.sync for bf16, fmaf for f32; csrc/tile_mma.cuh) over
// 64-pixel x 64-channel tiles. Every reduction is deterministic: BN sums and
// the split-K wgrad over the pixels (at most 128 blocks of at least 256
// pixels) go through per-block partials in the workspace, reduced in a
// fixed order; there are no float atomics. Measured on one H100 (700 W,
// chip_smoke.py): 1.9 ms forward and 5.7 ms backward at the training shape.
#include "trunk_conv.cuh"

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

struct Dims {
  int H, W, C;
  long long P, act;
  int pchunks, wchunks, wg_chunk;
  dim3 conv_grid, part_grid, apply_grid, wgrad_grid, wred_grid;
};

bool make_dims(int n, int B, int H, int W, int C, Dims* d) {
  if (n <= 0 || B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % TILE || C > 1024)
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

}  // namespace

// Workspace bytes of one call: forward (backward = 0) or backward (1).
extern "C" int packed_trunk_ws_bytes(int n, int B, int H, int W, int C, int esize,
                                     int backward, long long* out) {
  Dims d;
  if (!make_dims(n, B, H, W, C, &d) || (esize != 2 && esize != 4))
    return (int)cudaErrorInvalidValue;
  *out = (long long)layout(d, esize, backward != 0).total;
  return 0;
}

// x (B, H, W, C) NHWC; w1t, w2t (n, 9, C, C) [block][tap][out][in]; g1, b1,
// g2, b2 (n, C) f32; al (n,) f32. Writes y (B, H, W, C), the residuals xs,
// a1s, a2s (n, B, H, W, C) and stats (n, 4, C) f32 [m1, v1, m2, v2].
#define FWD_ARGS(T)                                                                  \
  const void *x, const void *w1t, const void *w2t, const void *g1, const void *b1,   \
      const void *g2, const void *b2, const void *al, void *y, void *xs, void *a1s,  \
      void *a2s, void *stats, void *ws, long long ws_bytes, int n, int B, int H,     \
      int W, int C, float eps, void *stream
#define FWD_CALL(T)                                                                  \
  trunk_forward<T>(static_cast<const T*>(x), static_cast<const T*>(w1t),                   \
                   static_cast<const T*>(w2t), static_cast<const float*>(g1),              \
             static_cast<const float*>(b1), static_cast<const float*>(g2),           \
             static_cast<const float*>(b2), static_cast<const float*>(al),           \
             static_cast<T*>(y), static_cast<T*>(xs), static_cast<T*>(a1s),          \
             static_cast<T*>(a2s), static_cast<float*>(stats), ws, ws_bytes, n, B,   \
             H, W, C, eps, static_cast<cudaStream_t>(stream))

extern "C" int packed_trunk_fwd_bf16(FWD_ARGS(__nv_bfloat16)) {
  return FWD_CALL(__nv_bfloat16);
}
extern "C" int packed_trunk_fwd_f32(FWD_ARGS(float)) { return FWD_CALL(float); }

// dy (B, H, W, C); the residuals and stats of the forward; w1d, w2d (n, 9,
// C, C) the flipped, transposed (dgrad) kernels in the forward's
// [block][tap][out][in] layout: w1d[i][3 * ky + kx][ci][co] = w1[i][2-ky][2-kx][ci][co].
// Writes dx (B, H, W, C), dw1, dw2 (n, 3, 3, C, C) HWIO f32, dg1, db1, dg2,
// db2 (n, C) f32 and dal (n,) f32.
#define BWD_ARGS(T)                                                                  \
  const void *dy, const void *xs, const void *a1s, const void *a2s,                  \
      const void *stats, const void *w1d, const void *w2d, const void *g1,           \
      const void *b1, const void *g2, const void *al, void *dx, void *dw1,           \
      void *dw2, void *dg1, void *db1, void *dg2, void *db2, void *dal, void *ws,    \
      long long ws_bytes, int n, int B, int H, int W, int C, float eps, void *stream
#define BWD_CALL(T)                                                                  \
  trunk_backward<T>(static_cast<const T*>(dy), static_cast<const T*>(xs),                  \
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
  return BWD_CALL(__nv_bfloat16);
}
extern "C" int packed_trunk_bwd_f32(BWD_ARGS(float)) { return BWD_CALL(float); }

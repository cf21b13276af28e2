// Best-buddy selection: kernel K7.
//
// Replaces the Pallas kernel srgan_st_tpu/kernels/buddy_select.py
// `_buddy_kernel`. Per batch element b and row n it writes
//
//   idx[b][n] = argmin_m  alpha * s(p1[b][n], bank[b][m]) + beta * s(p2[b][n], bank[b][m])
//
// with s the squared l2 distance clip(|p|^2 + |q|^2 - 2 p.q, 0) or the l1
// distance sum_k |p_k - q_k|, every score in f32 from inputs upcast to f32
// (bf16 values are exact in f32, so bf16 products are exact, as in the TPU
// kernel's bf16 dot with an f32 accumulator; f32 inputs never go through
// TF32). Ties go to the FIRST occurrence. Only real bank rows are scored:
// the last bank tile's rows past M are never compared. The gather of the
// selected rows and the stop-gradient stay outside, in torch.
//
// Near ties of the l2 expansion: |p|^2 + |q|^2 - 2 p.q cancels. With the
// PatchwiseST features |p|^2 + |q|^2 is ~1,800 times the smallest score of
// a row, so the f32 rounding of the expansion (~eps * (|p|^2 + |q|^2)) is
// larger than the gap between a row's two best bank rows on about one row
// in 16,000, and two f32 evaluations in different orders (this kernel, the
// plain version) pick different rows there. So the l2 kernels keep each
// row's two best (score, index) by the expansion and score those two
// exactly, (p - q)^2 summed in f64 (bf16 differences and their squares are
// exact there), keeping the exactly smaller, the first occurrence on an
// exact tie ("refine"). l1 sums |p - q| directly and needs none.
//
// What bounds it on an H100: at the PatchwiseST shape, p1/p2 (16, 1024, 27)
// and a bank of (16, 1344, 27) in bf16, it reads 3.0 MB and does 2.38 GFLOP
// of scoring (two 27-wide dots and the score per (n, m) pair). bf16 x bf16
// products are exact in f32, so the function's bound is the 989 TFLOP/s
// bf16 tensor-core peak, ~0.0024 ms, against ~0.001 ms of memory:
// operations bound it.
//
// Two kernels, chosen by the function (kernels/buddy_select.py `_launch`):
//
// bf16 with l2 (`buddy_mma_kernel`): the cross terms p1.q and p2.q on the
// tensor cores, mma.sync m16n8k16 bf16 -> f32. mma.sync, not wgmma: the
// features are 16 to 160 wide (one to ten k16 steps), too shallow to
// amortise wgmma's 64-row warpgroup tiles and descriptors, and the argmin
// needs each score in the registers of the fragment that holds it. A
// block holds 64 rows of p1 and p2 as A fragments in registers for the
// whole bank (features zero-padded to DP, a multiple of 16, which adds
// nothing to any product), and streams the batch element's bank in tiles
// of 64 rows through three shared-memory buffers: while tile i is scored,
// the norms of tile i + 1 are summed and tile i + 2's loads are in flight,
// one block barrier a tile. Warp w owns rows 16 (w % 4) .. + 16 and bank
// columns 32 (w / 4) .. + 32 of each tile. The norms |p|^2 and |q|^2 are
// summed in f32 in k order, as the SIMT kernel sums them (the bank rows'
// from 16-byte shared loads, a short dependent chain); each fragment
// element forms its score in registers. Argmin with the
// first occurrence kept: a thread visits its columns in increasing m with
// a strict `<`; the lanes of a quad, then the two column halves, merge by
// the lexicographic min on (score, index), which keeps the first of equal
// scores whatever the order of the merge.
//
// f32, and l1 (`buddy_kernel`, SIMT): l1 has no product form, and f32
// through the tensor cores would need TF32, which the JAX package's
// HIGHEST-precision selection does not allow. One block per (b, 64 rows),
// each thread one row held in registers (features padded to DP with
// zeros), bank tiles of 64 rows staged through shared memory as f32 with
// their norms; the thread scans the bank in increasing m with a strict
// `<`, so no merge can let a later equal score win. Its f32 FMAs cap it at
// the 67 TFLOP/s of non-tensor f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr int ROWS = 64;    // rows of p per block, one per thread
constexpr int MTILE = 64;   // bank rows per shared-memory tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// (s, i) before (t, j) in the lexicographic order, which keeps the first
// occurrence of equal scores
__device__ __forceinline__ bool lex_less(float s, int i, float t, int j) {
  return s < t || (s == t && i < j);
}

// a scan's next (score, m), m increasing: the two best so far, strict `<`
__device__ __forceinline__ void push2(float& b1, int& i1, float& b2, int& i2, float s, int m) {
  if (s < b1) {
    b2 = b1;
    i2 = i1;
    b1 = s;
    i1 = m;
  } else if (s < b2) {
    b2 = s;
    i2 = m;
  }
}

// the two best of two lists of the two best (disjoint indices), into the first
__device__ __forceinline__ void merge2(float& b1, int& i1, float& b2, int& i2, float c1, int j1,
                                       float c2, int j2) {
  if (lex_less(c1, j1, b1, i1)) {
    if (lex_less(c2, j2, b1, i1)) {
      b2 = c2;
      i2 = j2;
    } else {
      b2 = b1;
      i2 = i1;
    }
    b1 = c1;
    i1 = j1;
  } else if (lex_less(c1, j1, b2, i2)) {
    b2 = c1;
    i2 = j1;
  }
}

// alpha |p1 - q|^2 + beta |p2 - q|^2 in f64 from the rows' own values
template <typename T>
__device__ double exact_score(const T* p1r, const T* p2r, const T* q, int d, float alpha,
                              float beta) {
  double s1 = 0.0, s2 = 0.0;
  for (int k = 0; k < d; ++k) {
    const double v = to_f(q[k]);
    const double a = (double)to_f(p1r[k]) - v, c = (double)to_f(p2r[k]) - v;
    s1 += a * a;
    s2 += c * c;
  }
  return (double)alpha * s1 + (double)beta * s2;
}

// the refine: of the expansion's two best bank rows i1, i2 (b2 +inf: one
// row only), the exactly smaller, the first occurrence on an exact tie
template <typename T>
__device__ int refine(const T* p1r, const T* p2r, const T* bk, int d, float alpha, float beta,
                      int i1, float b2, int i2) {
  if (isinf(b2)) return i1;
  const double e1 = exact_score(p1r, p2r, bk + (size_t)i1 * d, d, alpha, beta);
  const double e2 = exact_score(p1r, p2r, bk + (size_t)i2 * d, d, alpha, beta);
  return (e2 < e1 || (e2 == e1 && i2 < i1)) ? i2 : i1;
}

template <typename T, int DP, bool L1>
__global__ void __launch_bounds__(ROWS)
    buddy_kernel(const T* __restrict__ p1, const T* __restrict__ p2,
                 const T* __restrict__ bank, int32_t* __restrict__ idx, int N, int M,
                 int d, float alpha, float beta) {
  __shared__ float tile[MTILE][DP];
  __shared__ float tnorm[MTILE];
  const int b = blockIdx.y;
  const int n = blockIdx.x * ROWS + threadIdx.x;
  const bool live = n < N;

  float r1[DP], r2[DP];
  float n1 = 0.f, n2 = 0.f;
#pragma unroll
  for (int k = 0; k < DP; ++k) {
    float a = 0.f, c = 0.f;
    if (live && k < d) {
      a = to_f(p1[((size_t)b * N + n) * d + k]);
      c = to_f(p2[((size_t)b * N + n) * d + k]);
    }
    r1[k] = a;
    r2[k] = c;
    n1 = __fadd_rn(n1, __fmul_rn(a, a));
    n2 = __fadd_rn(n2, __fmul_rn(c, c));
  }

  float best = inf_f(), best2 = inf_f();
  int arg = 0, arg2 = 0;
  const T* bk = bank + (size_t)b * M * d;
  for (int m0 = 0; m0 < M; m0 += MTILE) {
    const int mt = min(MTILE, M - m0);
    __syncthreads();  // the previous tile is done with
    for (int e = threadIdx.x; e < MTILE * DP; e += ROWS) {
      const int r = e / DP, k = e % DP;
      tile[r][k] = (r < mt && k < d) ? to_f(bk[(size_t)(m0 + r) * d + k]) : 0.f;
    }
    __syncthreads();
    if (!L1) {
      for (int r = threadIdx.x; r < mt; r += ROWS) {
        float s = 0.f;
        for (int k = 0; k < d; ++k) s = __fadd_rn(s, __fmul_rn(tile[r][k], tile[r][k]));
        tnorm[r] = s;
      }
      __syncthreads();
    }
    for (int r = 0; r < mt; ++r) {
      float s1 = 0.f, s2 = 0.f;
      if (L1) {
#pragma unroll
        for (int k = 0; k < DP; ++k) {
          const float q = tile[r][k];
          s1 = __fadd_rn(s1, fabsf(__fsub_rn(r1[k], q)));
          s2 = __fadd_rn(s2, fabsf(__fsub_rn(r2[k], q)));
        }
      } else {
        float c1 = 0.f, c2 = 0.f;
#pragma unroll
        for (int k = 0; k < DP; ++k) {
          const float q = tile[r][k];
          c1 = fmaf(r1[k], q, c1);
          c2 = fmaf(r2[k], q, c2);
        }
        const float bn = tnorm[r];
        s1 = fmaxf(__fsub_rn(__fadd_rn(n1, bn), __fmul_rn(2.f, c1)), 0.f);
        s2 = fmaxf(__fsub_rn(__fadd_rn(n2, bn), __fmul_rn(2.f, c2)), 0.f);
      }
      const float score = __fadd_rn(__fmul_rn(alpha, s1), __fmul_rn(beta, s2));
      push2(best, arg, best2, arg2, score, m0 + r);  // strict: the first of equal scores stays
    }
  }
  if (live) {
    const size_t row = ((size_t)b * N + n) * d;
    idx[(size_t)b * N + n] =
        L1 ? arg : refine(p1 + row, p2 + row, bk, d, alpha, beta, arg, best2, arg2);
  }
}

template <typename T, int DP>
int launch_dp(const void* p1, const void* p2, const void* bank, int32_t* idx, int B,
              int N, int M, int d, float alpha, float beta, int l1, cudaStream_t s) {
  const dim3 grid((N + ROWS - 1) / ROWS, B);
  const T* a = static_cast<const T*>(p1);
  const T* c = static_cast<const T*>(p2);
  const T* q = static_cast<const T*>(bank);
  if (l1)
    buddy_kernel<T, DP, true><<<grid, ROWS, 0, s>>>(a, c, q, idx, N, M, d, alpha, beta);
  else
    buddy_kernel<T, DP, false><<<grid, ROWS, 0, s>>>(a, c, q, idx, N, M, d, alpha, beta);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* p1, const void* p2, const void* bank, void* idx, int B, int N,
           int M, int d, float alpha, float beta, int l1, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || d <= 0 || d > 160) return (int)cudaErrorInvalidValue;
  int32_t* out = static_cast<int32_t*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 16) return launch_dp<T, 16>(p1, p2, bank, out, B, N, M, d, alpha, beta, l1, s);
  if (d <= 32) return launch_dp<T, 32>(p1, p2, bank, out, B, N, M, d, alpha, beta, l1, s);
  if (d <= 64) return launch_dp<T, 64>(p1, p2, bank, out, B, N, M, d, alpha, beta, l1, s);
  return launch_dp<T, 160>(p1, p2, bank, out, B, N, M, d, alpha, beta, l1, s);
}

// ------------------------------------------------------------ tensor cores
using bf16 = __nv_bfloat16;
constexpr int TC_ROWS = 64;                 // rows of p per block
constexpr int TC_WARPS = 8;                 // row group w % 4, column half w / 4
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_MT = 64;                   // bank rows per tile, 32 a column half
constexpr int TC_BUFS = 3;                  // tile buffers: scored, normed, being stored

// shared memory: the tile buffers [TC_BUFS][TC_MT][DP + 8] bf16, their bank
// rows' norms [TC_BUFS][TC_MT], the column halves' two best [2][TC_ROWS] x 4
// (scores and indices)
__host__ __device__ constexpr size_t tc_smem(int dp) {
  return (size_t)TC_BUFS * TC_MT * (dp + 8) * 2 + TC_BUFS * TC_MT * 4 + 2 * 4 * TC_ROWS * 4;
}

// the bf16 pair (k, k + 1) of row `row` of x (N rows of d), zero past d and N
__device__ __forceinline__ uint32_t feature_pair(const unsigned short* x, int N, int d, int row,
                                                 int k) {
  const bool live = row < N;
  const uint32_t lo = live && k < d ? x[(size_t)row * d + k] : 0u;
  const uint32_t hi = live && k + 1 < d ? x[(size_t)row * d + k + 1] : 0u;
  return lo | (hi << 16);
}

// |row|^2 in f32, summed in k order over the DP padded features (the zeros
// past d add nothing), from the A fragments of the lane's quad: register r
// (0: row g, k = 16 ks + 2 t; 2: row g, k + 8; 1 and 3 the same for row
// g + 8) of quad lane t holds the pair (k, k + 1).
template <int KSTEPS>
__device__ __forceinline__ float fragment_norm(const uint32_t (&a)[KSTEPS][4], int hh) {
  const int base = (threadIdx.x & 31) & ~3;
  float s = 0.f;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint32_t w = __shfl_sync(0xffffffffu, a[ks][2 * part + hh], base + t);
        const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xffff0000u);
        s = __fadd_rn(s, __fmul_rn(lo, lo));
        s = __fadd_rn(s, __fmul_rn(hi, hi));
      }
  return s;
}

template <int DP>
__global__ void __launch_bounds__(TC_THREADS)
    buddy_mma_kernel(const bf16* __restrict__ p1, const bf16* __restrict__ p2,
                     const bf16* __restrict__ bank, int32_t* __restrict__ idx, int N, int M,
                     int d, float alpha, float beta) {
  constexpr int KS = DP + 8;  // tile row stride (bf16): conflict-free fragment loads
  constexpr int KSTEPS = DP / 16;
  constexpr int E = TC_MT * DP / TC_THREADS;  // staged elements a thread, at most
  extern __shared__ __align__(16) unsigned char tc_shared[];
  bf16* tiles = reinterpret_cast<bf16*>(tc_shared);                    // [TC_BUFS][TC_MT][KS]
  float* tnorm = reinterpret_cast<float*>(tiles + TC_BUFS * TC_MT * KS);  // [TC_BUFS][TC_MT]
  float* mbest = tnorm + TC_BUFS * TC_MT;                                // [2][2][TC_ROWS]
  int* marg = reinterpret_cast<int*>(mbest + 4 * TC_ROWS);               // [2][2][TC_ROWS]
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, rg = warp & 3, half = warp >> 2;
  const int row0 = blockIdx.x * TC_ROWS + rg * 16;  // the warp's first row
  const unsigned short* q1 = reinterpret_cast<const unsigned short*>(p1) + (size_t)b * N * d;
  const unsigned short* q2 = reinterpret_cast<const unsigned short*>(p2) + (size_t)b * N * d;
  const unsigned short* bh = reinterpret_cast<const unsigned short*>(bank) + (size_t)b * M * d;

  // padding columns stay zero: the staging writes k < d only
  for (int e = tid; e < TC_BUFS * TC_MT * KS / 8; e += TC_THREADS)
    reinterpret_cast<uint4*>(tiles)[e] = make_uint4(0u, 0u, 0u, 0u);

  // the A fragments (rows row0 + g, row0 + g + 8) and the rows' norms
  uint32_t a1[KSTEPS][4], a2[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int k = 16 * ks + 2 * t;
    a1[ks][0] = feature_pair(q1, N, d, row0 + g, k);
    a1[ks][1] = feature_pair(q1, N, d, row0 + g + 8, k);
    a1[ks][2] = feature_pair(q1, N, d, row0 + g, k + 8);
    a1[ks][3] = feature_pair(q1, N, d, row0 + g + 8, k + 8);
    a2[ks][0] = feature_pair(q2, N, d, row0 + g, k);
    a2[ks][1] = feature_pair(q2, N, d, row0 + g + 8, k);
    a2[ks][2] = feature_pair(q2, N, d, row0 + g, k + 8);
    a2[ks][3] = feature_pair(q2, N, d, row0 + g + 8, k + 8);
  }
  float n1[2], n2[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    n1[hh] = fragment_norm<KSTEPS>(a1, hh);
    n2[hh] = fragment_norm<KSTEPS>(a2, hh);
  }

  // a tile's mt * d elements are contiguous; element tid + j * TC_THREADS
  // goes to off[j] of the tile buffer
  int off[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = tid + j * TC_THREADS;
    off[j] = (e / d) * KS + e % d;
  }
  unsigned short stage[E];
  auto load = [&](int m0) {
    const int cnt = min(TC_MT, M - m0) * d;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = tid + j * TC_THREADS;
      stage[j] = e < cnt ? bh[(size_t)m0 * d + e] : (unsigned short)0;
    }
  };
  auto store = [&](int buf, int m0) {
    const int cnt = min(TC_MT, M - m0) * d;
    unsigned short* dst = reinterpret_cast<unsigned short*>(tiles + buf * TC_MT * KS);
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (tid + j * TC_THREADS < cnt) dst[off[j]] = stage[j];
  };
  // |q|^2 of the tile's rows in f32, in k order, from 16-byte loads: row
  // 8 warp + lane for lanes < 8
  auto norms = [&](int buf, int m0) {
    const int r = 8 * warp + lane;
    if (lane < 8 && r < min(TC_MT, M - m0)) {
      const uint4* rp = reinterpret_cast<const uint4*>(tiles + (buf * TC_MT + r) * KS);
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < DP / 8; ++q) {
        const uint4 u = rp[q];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float lo = __uint_as_float(w[h] << 16), hi = __uint_as_float(w[h] & 0xffff0000u);
          s = __fadd_rn(s, __fmul_rn(lo, lo));
          s = __fadd_rn(s, __fmul_rn(hi, hi));
        }
      }
      tnorm[buf * TC_MT + r] = s;
    }
  };

  // per row hh: the two best (score, index) of the thread's columns
  float best[2] = {inf_f(), inf_f()}, best2[2] = {inf_f(), inf_f()};
  int arg[2] = {0, 0}, arg2[2] = {0, 0};
  const int ntiles = (M + TC_MT - 1) / TC_MT;
  __syncthreads();  // the zero fill
  load(0);
  store(0, 0);
  if (ntiles > 1) {
    load(TC_MT);
    store(1, TC_MT);
  }
  __syncthreads();
  norms(0, 0);
  __syncthreads();
  // tile it is scored from buffer it % 3 while tile it + 1's norms are
  // summed from buffer (it + 1) % 3 and tile it + 2 is staged into the
  // third: one block barrier a tile
  for (int it = 0; it < ntiles; ++it) {
    const int cur = it % TC_BUFS, m0 = it * TC_MT, mt = min(TC_MT, M - m0);
    if (it + 2 < ntiles) load(m0 + 2 * TC_MT);  // in flight while this tile is scored
    if (it + 1 < ntiles) norms((it + 1) % TC_BUFS, m0 + TC_MT);
    float c1[4][4], c2[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c1[j][e] = c2[j][e] = 0.f;
    const bf16* tb = tiles + (cur * TC_MT + 32 * half + g) * KS + 2 * t;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* bp = tb + 8 * j * KS + 16 * ks;
        const uint32_t b0 = srgan::ld32(bp), b1 = srgan::ld32(bp + 8);
        srgan::mma_16816(c1[j], a1[ks][0], a1[ks][1], a1[ks][2], a1[ks][3], b0, b1);
        srgan::mma_16816(c2[j], a2[ks][0], a2[ks][1], a2[ks][2], a2[ks][3], b0, b1);
      }
    // c[j][2 hh + e]: row g + 8 hh, tile column 32 half + 8 j + 2 t + e; the
    // thread's columns in increasing m, a strict `<`. n + bn - 2 c is one
    // fma: 2 c is exact, so fma(-2, c, n + bn) rounds as (n + bn) - 2 c.
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 32 * half + 8 * j + 2 * t + e;
        if (col >= mt) continue;  // past the bank: never compared
        const float bn = tnorm[cur * TC_MT + col];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float s1 = fmaxf(__fmaf_rn(-2.f, c1[j][2 * hh + e], __fadd_rn(n1[hh], bn)), 0.f);
          const float s2 = fmaxf(__fmaf_rn(-2.f, c2[j][2 * hh + e], __fadd_rn(n2[hh], bn)), 0.f);
          const float score = __fadd_rn(__fmul_rn(alpha, s1), __fmul_rn(beta, s2));
          push2(best[hh], arg[hh], best2[hh], arg2[hh], score, m0 + col);
        }
      }
    if (it + 2 < ntiles) store((it + 2) % TC_BUFS, m0 + 2 * TC_MT);  // last read in it - 1
    __syncthreads();
  }
  // the quad's lanes hold the same rows: merge their two best, then the
  // column halves', then refine the row's two best
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float c1 = __shfl_xor_sync(0xffffffffu, best[hh], o);
      const int j1 = __shfl_xor_sync(0xffffffffu, arg[hh], o);
      const float c2 = __shfl_xor_sync(0xffffffffu, best2[hh], o);
      const int j2 = __shfl_xor_sync(0xffffffffu, arg2[hh], o);
      merge2(best[hh], arg[hh], best2[hh], arg2[hh], c1, j1, c2, j2);
    }
  if (t == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = half * 2 * TC_ROWS + rg * 16 + g + 8 * hh;
      mbest[r] = best[hh];
      marg[r] = arg[hh];
      mbest[r + TC_ROWS] = best2[hh];
      marg[r + TC_ROWS] = arg2[hh];
    }
  }
  __syncthreads();
  const int n = blockIdx.x * TC_ROWS + tid;
  if (tid < TC_ROWS && n < N) {
    float s1 = mbest[tid], s2 = mbest[TC_ROWS + tid];
    int i1 = marg[tid], i2 = marg[TC_ROWS + tid];
    merge2(s1, i1, s2, i2, mbest[2 * TC_ROWS + tid], marg[2 * TC_ROWS + tid],
           mbest[3 * TC_ROWS + tid], marg[3 * TC_ROWS + tid]);
    const size_t row = ((size_t)b * N + n) * d;
    idx[(size_t)b * N + n] =
        refine(p1 + row, p2 + row, bank + (size_t)b * M * d, d, alpha, beta, i1, s2, i2);
  }
}

template <int DP>
int launch_mma_dp(const void* p1, const void* p2, const void* bank, int32_t* idx, int B,
                  int N, int M, int d, float alpha, float beta, cudaStream_t s) {
  constexpr size_t smem = tc_smem(DP);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        buddy_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + TC_ROWS - 1) / TC_ROWS, B);
  buddy_mma_kernel<DP><<<grid, TC_THREADS, smem, s>>>(
      static_cast<const bf16*>(p1), static_cast<const bf16*>(p2),
      static_cast<const bf16*>(bank), idx, N, M, d, alpha, beta);
  return (int)cudaGetLastError();
}

}  // namespace

// p1, p2 (B, N, d) and bank (B, M, d), contiguous, d <= 160 (ksize 7 gives
// 147); writes idx (B, N) int32. l1 = 0: squared l2 scores, 1: l1. The
// SIMT kernel (kernels/buddy_select.py sends it f32 and l1). bf16 with
// l1 = 0 is never dispatched there (the tensor-core kernel takes it):
// chip_smoke.py times it on the same inputs as the design it replaced.
extern "C" int buddy_select_bf16(const void* p1, const void* p2, const void* bank,
                                 void* idx, int B, int N, int M, int d, float alpha,
                                 float beta, int l1, void* stream) {
  return launch<__nv_bfloat16>(p1, p2, bank, idx, B, N, M, d, alpha, beta, l1, stream);
}

extern "C" int buddy_select_f32(const void* p1, const void* p2, const void* bank,
                                void* idx, int B, int N, int M, int d, float alpha,
                                float beta, int l1, void* stream) {
  return launch<float>(p1, p2, bank, idx, B, N, M, d, alpha, beta, l1, stream);
}

// The tensor-core kernel: bf16 p1, p2 (B, N, d) and bank (B, M, d),
// contiguous, d <= 160; squared l2 scores; writes idx (B, N) int32.
extern "C" int buddy_select_bf16_mma(const void* p1, const void* p2, const void* bank,
                                     void* idx, int B, int N, int M, int d, float alpha,
                                     float beta, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || d <= 0 || d > 160) return (int)cudaErrorInvalidValue;
  int32_t* out = static_cast<int32_t*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 16) return launch_mma_dp<16>(p1, p2, bank, out, B, N, M, d, alpha, beta, s);
  if (d <= 32) return launch_mma_dp<32>(p1, p2, bank, out, B, N, M, d, alpha, beta, s);
  if (d <= 64) return launch_mma_dp<64>(p1, p2, bank, out, B, N, M, d, alpha, beta, s);
  return launch_mma_dp<160>(p1, p2, bank, out, B, N, M, d, alpha, beta, s);
}

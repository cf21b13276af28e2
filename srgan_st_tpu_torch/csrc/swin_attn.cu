// SwinIR's window attention core in eval: kernel W.
//
// Replaces no TPU kernel: the JAX package has no SwinIR. The port ran the
// core (models/swinir.py `window_attention`, region g.attn_core) as torch
// ops: each head zero-padded from 30 to 32 columns (a copy of q, k and v),
// torch's fused attention called twice (the windows the shift mask misses
// with the bias broadcast, the others with bias plus mask, both
// materialised per block in bf16), and the heads' outputs transposed into
// place (a second copy). This kernel computes, for W windows of N = 64
// tokens (window 8), from qkv (W, 64, 3C) bf16 as the qkv linear writes it
// (q, k and v column blocks of C = heads x hd, head h at columns h hd ..
// h hd + hd - 1 of each):
//
//   s   = scale q k^T + table[index]                     f32
//   s  += -100 where two tokens' region labels differ     windows >= split
//   out = softmax(s) v                                    (W, 64, C) bf16
//
// with the scores, max, exponentials and row sums in f32, p rounded once
// to bf16 for the p v product, which accumulates in f32, and the output
// rounded once. table is the block's relative_position_bias_table
// ((2*8-1)^2 = 225 rows x heads, f32), index its (64, 64) int64
// relative_position_index, labels (W - split, 64) uint8 the region of each
// token of the windows the shift mask reaches (models/swinir.py
// `SwinIR.plan` puts those windows last): the mask is made from them, and
// no (heads, 64, 64) bias or per-window mask is ever stored.
//
// What bounds it on an H100 at a 544 x 960 frame (8,160 windows, heads of
// 30; benchmark/work_swinir.py `attn_core`): 0.754 GB a core, q, k and v
// read once and the output written once, 0.225 ms at 3.35 TB/s; its 24
// GFLOP take under 0.03 ms of tensor time. The bytes bound it.
//
// Design: one persistent CTA an SM (12 warps) walks the windows w =
// blockIdx.x + k gridDim.x. A window's rows are one contiguous run of 64 x
// 6C bytes (69,120 at C = 180; a token's 1,080-byte row is no multiple of
// 16, the window is), so each window lands whole in shared memory by one
// bulk copy, with its 64 labels where the mask reaches it, through a ring
// of 3 stages (2 where three windows do not fit) completing on mbarriers:
// two windows stream in while the CTA computes the third. Each warp takes
// 32 query rows of a head (every sixth head) as two m tiles of mma.sync
// m16n8k16 (bf16, f32 accumulators), which share each k and v fragment:
// q k^T over the head's columns read as 32-bit pairs (heads start at even
// columns), columns hd..31 of the k dimension zeros in registers, never in
// memory; the bias read through the index (held by each thread as bytes in
// registers for the CTA's life) from the table, transposed and scaled by
// log2(e) once a CTA into shared memory, so that the softmax takes one
// MUFU.EX2 a score; each row's softmax across the four lanes that hold it;
// p v with p's fragments packed from the score accumulators and v's key
// pairs from two 32-bit rows by byte permutes: the two n tiles of a
// 16-column block take its even and odd columns, so a thread's outputs are
// four consecutive columns of a row. Those go where the warp's q was (no
// other warp reads it): after a barrier the window's output rows, the q
// block, leave in 8-byte chunks, consecutive threads on consecutive
// chunks, and the stage is refilled.
//
// Measured on one H100 80GB HBM3 at 700 W at (8160, 64, 540) with 187
// windows masked, by CUDA events: 0.368 ms a wrapper call (61% of the
// bound; torch's attention on heads padded to 32, as the port ran it
// before, 1.953), 0.313 ms a core inside the served frame (72%). The math,
// not the bytes, holds it there (timed variants, before exp2 took one
// MUFU a score: 0.356-0.363 ms): the loads and the output copy alone take
// 0.265-0.267 ms, without the bias lookups (an index byte, an address and
// a load a score) 0.284-0.291, without the exponentials 0.270-0.272. Tried
// and not kept: one 16-row tile a warp over two heads, the outputs stored
// from registers as 4-byte pairs (0.375-0.377 ms); the same with 24 warps
// of one tile each (80 registers, spills: 0.408-0.410); two m tiles with
// the outputs stored from registers (0.368-0.374); 2 stages (no change).
#include <algorithm>

#include "coarse_wgmma.cuh"

using namespace srgan;

namespace {

using bf16 = __nv_bfloat16;
constexpr int N = 64;                  // tokens a window (window 8)
constexpr int TABLE_ROWS = 15 * 15;    // (2 * 8 - 1)^2 relative positions
constexpr int MAX_HD = 32;             // a head's columns, the mma's two k steps
constexpr int MAX_HEADS = 8;           // the table's rows in shared memory
constexpr int WARPS = 12;              // a warp takes 32 query rows of every sixth head
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_STAGES = 3;
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int HEAD = 128;              // the mbarriers, before the ring
constexpr float MASKED = -100.f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const unsigned char* qkv;   // (W, 64, 3C) bf16
  const float* table;         // (225, heads) f32
  const long long* index;     // (64, 64) int64
  const unsigned char* labels;  // (W - split, 64) uint8
  bf16* out;                  // (W, 64, C) bf16
  int windows, split, heads, hd, stages;
  float scale;
};

__host__ __device__ constexpr int window_bytes(int C) { return N * 3 * C * 2; }
__host__ __device__ constexpr int smem_bytes(int heads, int hd, int stages) {
  return HEAD + stages * (window_bytes(heads * hd) + N) + heads * TABLE_ROWS * 4;
}
// the ring's stages: three where they fit, else two (0 where two do not)
int stages_for(int heads, int hd) {
  for (int s = MAX_STAGES; s >= 2; --s)
    if (smem_bytes(heads, hd, s) <= SMEM_LIMIT) return s;
  return 0;
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   hop::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(hop::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(hop::smem_addr(bar))
      : "memory");
}

// D (16 x 8, f32) += A (16 x 16, row) * B (16 x 8, col), bf16 operands
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// 2^x of x <= 0 (one MUFU.EX2; results below 2^-126 flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// two floats as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One warp's share of one window: head h, query rows 32 half .. 32 half +
// 31 as two m tiles (m: rows 32 half + 16 m + g and + 8 of lane (g, t)),
// which share each k and v fragment. x: the window's rows in shared
// memory; tab: head h's 225 table entries times log2(e); idx[m][nt]: the
// index bytes of this thread's four scores of m tile m, n tile nt; lab: the
// window's labels, or null. The scores are kept in base 2 (times log2(e))
// for exp2. The output of these rows and head goes where their q was, which
// no other warp reads: the q block of the window becomes its output rows.
__device__ __forceinline__ void head_rows(const Params& p, unsigned char* x, const float* tab,
                                          const uint32_t (&idx)[2][8], const unsigned char* lab,
                                          int h, int half, int g, int t) {
  const int C = p.heads * p.hd, hd = p.hd, row = 6 * C;  // bytes of a token's row
  unsigned char* q = x + 2 * h * hd;
  const unsigned char* k = q + 2 * C;
  const unsigned char* v = k + 2 * C;
  const int r0 = 32 * half + g;  // m tile m: rows r0 + 16 m and r0 + 16 m + 8

  // q's A fragments for the two k steps; columns past hd are zeros
  uint32_t qa[2][2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const unsigned char* qr = q + (r0 + 16 * m) * row;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int c0 = 16 * ks + 2 * t, c1 = c0 + 8;
      qa[m][ks][0] = c0 < hd ? lds32(qr + 2 * c0) : 0u;
      qa[m][ks][1] = c0 < hd ? lds32(qr + 8 * row + 2 * c0) : 0u;
      qa[m][ks][2] = c1 < hd ? lds32(qr + 2 * c1) : 0u;
      qa[m][ks][3] = c1 < hd ? lds32(qr + 8 * row + 2 * c1) : 0u;
    }
  }
  // s = q k^T: n tile nt holds keys 8 nt .. 8 nt + 7
  float s[2][8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const unsigned char* kr = k + (8 * nt + g) * row;
    uint32_t b[2][2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int c0 = 16 * ks + 2 * t, c1 = c0 + 8;
      b[ks][0] = c0 < hd ? lds32(kr + 2 * c0) : 0u;
      b[ks][1] = c1 < hd ? lds32(kr + 2 * c1) : 0u;
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      s[m][nt][0] = s[m][nt][1] = s[m][nt][2] = s[m][nt][3] = 0.f;
      mma(s[m][nt], qa[m][0], b[0][0], b[0][1]);
      mma(s[m][nt], qa[m][1], b[1][0], b[1][1]);
    }
  }
  // scale, bias, mask; row g holds [0], [1], row g + 8 [2], [3]
  const float scale = p.scale * LOG2E;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[m][nt][e] = fmaf(s[m][nt][e], scale, tab[(idx[m][nt] >> (8 * e)) & 0xffu]);
  if (lab != nullptr) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int l0 = lab[r0 + 16 * m], l1 = lab[r0 + 16 * m + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int a = lab[8 * nt + 2 * t], b = lab[8 * nt + 2 * t + 1];
        if (a != l0) s[m][nt][0] += MASKED * LOG2E;
        if (b != l0) s[m][nt][1] += MASKED * LOG2E;
        if (a != l1) s[m][nt][2] += MASKED * LOG2E;
        if (b != l1) s[m][nt][3] += MASKED * LOG2E;
      }
    }
  }
  // softmax of each row over the 4 lanes of a quad: p = exp2(s - max) / sum,
  // packed to bf16 as the A fragments of p v (k step kk: n tiles 2 kk, 2 kk + 1)
  uint32_t pa[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float m0 = s[m][0][0], m1 = s[m][0][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      m0 = fmaxf(m0, fmaxf(s[m][nt][0], s[m][nt][1]));
      m1 = fmaxf(m1, fmaxf(s[m][nt][2], s[m][nt][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float z0 = 0.f, z1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[m][nt][0] = ex2(s[m][nt][0] - m0);
      s[m][nt][1] = ex2(s[m][nt][1] - m0);
      s[m][nt][2] = ex2(s[m][nt][2] - m1);
      s[m][nt][3] = ex2(s[m][nt][3] - m1);
      z0 += s[m][nt][0] + s[m][nt][1];
      z1 += s[m][nt][2] + s[m][nt][3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      z0 += __shfl_xor_sync(0xffffffffu, z0, o);
      z1 += __shfl_xor_sync(0xffffffffu, z1, o);
    }
    const float i0 = __frcp_rn(z0), i1 = __frcp_rn(z1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int n0 = 2 * kk, n1 = n0 + 1;
      pa[m][kk][0] = pack(s[m][n0][0] * i0, s[m][n0][1] * i0);
      pa[m][kk][1] = pack(s[m][n0][2] * i1, s[m][n0][3] * i1);
      pa[m][kk][2] = pack(s[m][n1][0] * i0, s[m][n1][1] * i0);
      pa[m][kk][3] = pack(s[m][n1][2] * i1, s[m][n1][3] * i1);
    }
  }

  // o = p v: column block sb (16 columns) is two n tiles, [0] its even
  // columns 16 sb + 2 n and [1] its odd ones, so lane (g, t) packs the key
  // pairs of columns 16 sb + 2 g, + 1 from two 32-bit loads
  float o[2][2][2][4] = {};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const unsigned char* vr = v + (16 * kk + 2 * t) * row;
#pragma unroll
    for (int sb = 0; sb < 2; ++sb) {
      const int d = 16 * sb + 2 * g;
      uint32_t v0 = 0u, v1 = 0u, v2 = 0u, v3 = 0u;
      if (d < hd) {
        v0 = lds32(vr + 2 * d);
        v1 = lds32(vr + row + 2 * d);
        v2 = lds32(vr + 8 * row + 2 * d);
        v3 = lds32(vr + 9 * row + 2 * d);
      }
      const uint32_t e0 = __byte_perm(v0, v1, 0x5410), e1 = __byte_perm(v2, v3, 0x5410);
      const uint32_t d0 = __byte_perm(v0, v1, 0x7632), d1 = __byte_perm(v2, v3, 0x7632);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma(o[m][sb][0], pa[m][kk], e0, e1);
        mma(o[m][sb][1], pa[m][kk], d0, d1);
      }
    }
  }
  // lane (g, t) holds columns 16 sb + 4 t .. + 3 of its rows
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    unsigned char* o0 = q + (r0 + 16 * m) * row;
    unsigned char* o1 = o0 + 8 * row;
#pragma unroll
    for (int sb = 0; sb < 2; ++sb) {
      const int d = 16 * sb + 4 * t;
      if (d < hd) {
        *reinterpret_cast<uint32_t*>(o0 + 2 * d) = pack(o[m][sb][0][0], o[m][sb][1][0]);
        *reinterpret_cast<uint32_t*>(o1 + 2 * d) = pack(o[m][sb][0][2], o[m][sb][1][2]);
      }
      if (d + 2 < hd) {
        *reinterpret_cast<uint32_t*>(o0 + 2 * d + 4) = pack(o[m][sb][0][1], o[m][sb][1][1]);
        *reinterpret_cast<uint32_t*>(o1 + 2 * d + 4) = pack(o[m][sb][0][3], o[m][sb][1][3]);
      }
    }
  }
}

// The window's output rows, the first 2C bytes of each of its 64 rows in
// shared memory, to `out` (64 x 2C contiguous bytes) in chunks of U bytes,
// consecutive threads on consecutive chunks.
template <typename U>
__device__ __forceinline__ void copy_out(const unsigned char* x, bf16* out, int C) {
  const int per_row = 2 * C / (int)sizeof(U), row = 6 * C;
  U* dst = reinterpret_cast<U*>(out);
  for (int i = threadIdx.x; i < N * per_row; i += THREADS) {
    const int r = i / per_row;
    dst[i] = *reinterpret_cast<const U*>(x + r * row + (i - r * per_row) * (int)sizeof(U));
  }
}

__global__ void __launch_bounds__(THREADS, 1) swin_attn_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.heads * p.hd, S = p.stages;
  const uint32_t wbytes = window_bytes(C);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // a stage's window has landed
  unsigned char* ring = smem + HEAD;
  unsigned char* labs = ring + (size_t)S * wbytes;
  float* tab = reinterpret_cast<float*>(labs + S * N);  // [head][225]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int half = warp & 1, G = gridDim.x;
  const int mine = (p.windows - (int)blockIdx.x + G - 1) / G;

  // thread 0: my k-th window (and its labels) into stage k % S, after the
  // block's writes to that stage (a window's output) are ordered before
  // the copy's
  auto issue = [&](int k) {
    const int w = blockIdx.x + k * G, st = k % S;
    const bool edge = w >= p.split;
    hop::fence_async_smem();
    mbar_expect(&full[st], wbytes + (edge ? N : 0));
    bulk_copy(ring + (size_t)st * wbytes, p.qkv + (size_t)w * wbytes, wbytes, &full[st]);
    if (edge) bulk_copy(labs + st * N, p.labels + (size_t)(w - p.split) * N, N, &full[st]);
  };
  if (tid == 0) {
    for (int i = 0; i < S; ++i) hop::mbar_init(&full[i], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < S && k < mine; ++k) issue(k);

  // the table, times log2(e), transposed to [head][row]; this thread's index bytes
  for (int i = tid; i < p.heads * TABLE_ROWS; i += THREADS) {
    const int h = i / TABLE_ROWS, r = i - h * TABLE_ROWS;
    tab[i] = p.table[r * p.heads + h] * LOG2E;
  }
  uint32_t idx[2][8];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const long long* i0 = p.index + (32 * half + 16 * m + g) * N;
    const long long* i1 = i0 + 8 * N;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int j = 8 * nt + 2 * t;
      const long long e[4] = {i0[j], i0[j + 1], i1[j], i1[j + 1]};
      idx[m][nt] = 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c)  // out of range reads row 0, never past the table
        idx[m][nt] |= (uint32_t)((unsigned long long)e[c] < TABLE_ROWS ? e[c] : 0) << (8 * c);
    }
  }
  __syncthreads();

  for (int k = 0; k < mine; ++k) {
    const int w = blockIdx.x + k * G, st = k % S;
    hop::mbar_wait(&full[st], (uint32_t)(k / S) & 1u);
    unsigned char* x = ring + (size_t)st * wbytes;
    const unsigned char* lab = w >= p.split ? labs + st * N : nullptr;
    for (int h = warp >> 1; h < p.heads; h += WARPS / 2)
      head_rows(p, x, tab + h * TABLE_ROWS, idx, lab, h, half, g, t);
    __syncthreads();  // the window's output rows are complete
    bf16* out = p.out + (size_t)w * N * C;
    if (C % 4 == 0)
      copy_out<uint2>(x, out, C);
    else
      copy_out<uint32_t>(x, out, C);
    __syncthreads();  // every thread is done with stage st
    if (tid == 0 && k + S < mine) issue(k + S);
  }
}

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

bool shape_ok(int heads, int hd) {
  return heads >= 1 && heads <= MAX_HEADS && hd >= 2 && hd <= MAX_HD && hd % 2 == 0 &&
         stages_for(heads, hd) >= 2;
}

}  // namespace

// qkv (windows, 64, 3 heads hd) bf16, 16-byte aligned; table (225, heads)
// f32; index (64, 64) int64; labels (windows - split, 64) uint8, 16-byte
// aligned (unread where split == windows); out (windows, 64, heads hd)
// bf16, 8-byte aligned. One launch.
extern "C" int swin_attn_bf16(const void* qkv, const void* table, const void* index,
                              const void* labels, void* out, int windows, int split, int heads,
                              int hd, float scale, void* stream) {
  if (!shape_ok(heads, hd) || windows <= 0 || split < 0 || split > windows ||
      (long long)windows * window_bytes(heads * hd) >= (1LL << 40) ||
      reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(out) % 8 ||
      reinterpret_cast<uintptr_t>(table) % 4 || reinterpret_cast<uintptr_t>(index) % 8 ||
      (split < windows && (labels == nullptr || reinterpret_cast<uintptr_t>(labels) % 16)))
    return (int)cudaErrorInvalidValue;
  const int stages = stages_for(heads, hd), smem = smem_bytes(heads, hd, stages);
  cudaError_t err = allow_smem<swin_attn_kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  Params p{};
  p.qkv = static_cast<const unsigned char*>(qkv);
  p.table = static_cast<const float*>(table);
  p.index = static_cast<const long long*>(index);
  p.labels = static_cast<const unsigned char*>(labels);
  p.out = static_cast<bf16*>(out);
  p.windows = windows;
  p.split = split;
  p.heads = heads;
  p.hd = hd;
  p.stages = stages;
  p.scale = scale;
  swin_attn_kernel<<<std::min(sms, windows), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}

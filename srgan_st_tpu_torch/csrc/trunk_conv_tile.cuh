// The bf16 conv tile of the residual trunk on wgmma, shared by K4's
// launches (csrc/packed_trunk.cu `trunk_conv_wgmma`, one tile a CTA) and
// K6's persistent launch (csrc/fused_trunk.cu `fused_trunk_wgmma`, many
// tiles a CTA): one warpgroup, 64 padded positions x 64 output channels,
// K = 9 taps x C in chunks of 64 channels through a 2-stage ring (window by
// cp.async or a transforming load, the chunk's 73.7 KB of weights by one
// bulk copy), over the padded grid of csrc/trunk_wgmma.cuh. What the loader
// forms and what the epilogue does with the accumulators is the mode.
//
// The pieces are device functions of one tile. What belongs to a launch
// stays in the kernels: K4's programmatic dependent launch and last-ticket
// reduction; K6's schedule, grid barriers and moment reductions. Both run
// the same instructions on a tile, so a tile's values and its BatchNorm
// partials have the same bits in both.
#pragma once

#include "trunk_wgmma.cuh"

namespace srgan {
namespace tw {

using bf16 = __nv_bfloat16;
enum { LD_COPY = 0, LD_BN_PRELU = 1, LD_DA_T = 2, LD_DA_F = 3, LD_BN_RESID = 4 };
enum { EP_STATS = 0, EP_PRELU_BWD = 1, EP_GRAD = 2 };

struct ConvParams {
  Geom g;
  const bf16* wimg;       // (C/64 N tiles, C/64 K chunks) weight blocks in the ring's image
  // loader: LD_COPY, LD_BN_PRELU read src; LD_DA_* read src (the BN input
  // a) and dsrc (the BN output's cotangent, bf16 or f32); LD_BN_RESID reads
  // src (a2 of the block before) and dsrc (that block's input, bf16)
  const bf16* src;
  const void* dsrc;
  const float *lmv, *lgam, *lbet, *lal, *ldg, *ldb;
  bf16* dout;             // LD_DA_*, LD_BN_RESID: the tile's own positions of
                          // what the loader formed (da for wgrad; the block input)
  // epilogue: EP_STATS out = a (bf16); EP_PRELU_BWD out = dpre (f32), hout
  // = h; EP_GRAD out = g (bf16) = resid + acc (resid may alias out)
  void* out;
  const bf16* resid;
  const bf16* ea;         // EP_PRELU_BWD: a1; EP_GRAD: a2 of the block before (or null)
  const float *emv, *egam, *ebet, *eal;
  bf16* hout;
  float* part;            // per-tile partials [tile][k][C]
  unsigned* ticket;
  float *r0, *r1, *r2;    // the reduced statistics
  float eps, nelem;
};

// the weight and window stages, then the epilogue's constants (6 x 64
// floats) and partial sums (3 x 4 x 64), then the stages' mbarriers
__host__ __device__ inline size_t conv_smem(const Geom& g) {
  const int stages = g.C > CK ? 2 : 1;
  return (size_t)stages * (W_BYTES + g.rows * KG * 16) + (6 + 12) * 64 * 4 + 16;
}

// 8 consecutive bf16 of a 16-byte word as floats, and back
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(h[j]);
}
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16_rn(f[j]);
  return u;
}

// The window of K chunk channels [ci0, ci0 + 64) of the tile at q0 into
// `win` ([k group][row][16 B]). Thread tid always owns k group tid % 8.
// `own`: this tile writes its own positions of what the loader formed to
// dout (the tiles of N tile 0 do, so that each position is written once).
template <int LOAD>
__device__ __forceinline__ void load_window(const ConvParams& p, unsigned char* win,
                                            long long q0, int ci0, bool own) {
  const Geom& g = p.g;
  const int C = g.C, kg = threadIdx.x & 7, c0 = ci0 + kg * 8;
  // the BN constants of this thread's 8 channels, as the f32 kernels form them
  float k0[8], k1[8], k2[8], k3[8], k4[8], alT = 0.f;
  if constexpr (LOAD == LD_BN_PRELU || LOAD == LD_BN_RESID) {
    if constexpr (LOAD == LD_BN_PRELU) alT = rnd<bf16>(*p.lal);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      k0[j] = rnd<bf16>(p.lmv[c0 + j]);
      k1[j] = rnd<bf16>(inv_std(p.lmv[C + c0 + j], p.eps));
      k2[j] = rnd<bf16>(p.lgam[c0 + j]);
      k3[j] = rnd<bf16>(p.lbet[c0 + j]);
    }
  } else if constexpr (LOAD != LD_COPY) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float inv = inv_std(p.lmv[C + c0 + j], p.eps);
      k0[j] = p.lmv[c0 + j];
      k1[j] = inv;
      k2[j] = __fmul_rn(p.lgam[c0 + j], inv);
      k3[j] = __fdiv_rn(p.ldb[c0 + j], p.nelem);
      k4[j] = __fdiv_rn(p.ldg[c0 + j], p.nelem);
    }
  }
  constexpr int RS = CONV_THREADS / 8;  // rows between a thread's rows
  if constexpr (LOAD == LD_COPY) {
    for (int r = threadIdx.x >> 3; r < g.rows; r += RS) {
      const long long pix = pixel_of(g, win_pos(g, q0, r));
      hop::cp_async16(win + ((size_t)kg * g.rows + r) * 16,
                      p.src + (size_t)(pix < 0 ? 0 : pix) * C + c0, pix >= 0);
    }
    return;
  }
  // The transforming loads: U rows at a time, their global loads all
  // started before the first is used
  constexpr int U = 4;
  for (int r0 = threadIdx.x >> 3; r0 < g.rows; r0 += U * RS) {
    long long q[U], pix[U];
    uint4 ra[U], rd[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * RS;
      q[u] = win_pos(g, q0, r);
      pix[u] = r < g.rows ? pixel_of(g, q[u]) : -1;
      if (pix[u] < 0) continue;
      const size_t o = (size_t)pix[u] * C + c0;
      ra[u] = *reinterpret_cast<const uint4*>(p.src + o);
      if constexpr (LOAD == LD_DA_F) {
        const uint4* df = reinterpret_cast<const uint4*>(static_cast<const float*>(p.dsrc) + o);
        rd[u][0] = df[0];
        rd[u][1] = df[1];
      } else if constexpr (LOAD != LD_BN_PRELU) {
        rd[u][0] = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.dsrc) + o);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * RS;
      if (r >= g.rows) break;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);  // padding stays zero: BN(0) is not 0
      if (pix[u] >= 0) {
        float a[8], v[8];
        unpack8(ra[u], a);
        if constexpr (LOAD == LD_BN_PRELU) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float y = bn_affine<bf16>(a[j], k0[j], k1[j], k2[j], k3[j]);
            if (!(y >= 0.f)) y = rnd<bf16>(__fmul_rn(alT, y));
            v[j] = y;
          }
        } else if constexpr (LOAD == LD_BN_RESID) {
          // x <- x + BN2(a2) of the block before, as bn_out<T, false, true>
          float x[8];
          unpack8(rd[u][0], x);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = __fadd_rn(x[j], bn_affine<bf16>(a[j], k0[j], k1[j], k2[j], k3[j]));
        } else {
          float d[8];
          if constexpr (LOAD == LD_DA_T) {
            unpack8(rd[u][0], d);
          } else {
            const float* lo = reinterpret_cast<const float*>(&rd[u][0]);
            const float* hi = reinterpret_cast<const float*>(&rd[u][1]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              d[j] = lo[j];
              d[4 + j] = hi[j];
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float xh = __fmul_rn(__fsub_rn(a[j], k0[j]), k1[j]);
            const float t = __fsub_rn(__fsub_rn(d[j], k3[j]), __fmul_rn(xh, k4[j]));
            v[j] = __fmul_rn(k2[j], t);
          }
        }
        w = pack8(v);
        if constexpr (LOAD != LD_BN_PRELU) {
          if (own && q[u] >= q0 && q[u] < q0 + MT)
            *reinterpret_cast<uint4*>(p.dout + (size_t)pix[u] * C + c0) = w;
        }
      }
      *reinterpret_cast<uint4*>(win + ((size_t)kg * g.rows + r) * 16) = w;
    }
  }
}

// The tile's shared memory (conv_smem bytes): the weight and window
// stages, the epilogue's constants (6 x 64 floats) and partial sums
// (3 x 4 x 64), the stages' mbarriers.
struct TileSmem {
  unsigned char* wring;  // [stages][W_BYTES]
  unsigned char* wins;   // [stages][KG][rows][16]
  float* econ;           // [6][64]
  float* red;            // [3][4 warps][64]
  uint64_t* bar;         // [stages]
  int win_bytes, nk, stages;
};

__device__ __forceinline__ TileSmem tile_smem(unsigned char* smem, const Geom& g) {
  TileSmem s;
  s.nk = g.C / CK;
  s.stages = s.nk > 1 ? 2 : 1;
  s.win_bytes = g.rows * KG * 16;
  s.wring = smem;
  s.wins = smem + s.stages * W_BYTES;
  s.econ = reinterpret_cast<float*>(s.wins + s.stages * s.win_bytes);
  s.red = s.econ + 6 * 64;
  s.bar = reinterpret_cast<uint64_t*>(s.red + 12 * 64);
  return s;
}

// One thread: the bulk copy of N tile nt's K chunk kc of the weights into
// ring stage kc & 1.
__device__ __forceinline__ void issue_weights(const ConvParams& p, const TileSmem& s, int nt,
                                              int kc) {
  hop::bulk_load(s.wring + (kc & 1) * W_BYTES,
                 p.wimg + ((size_t)nt * s.nk + kc) * (W_BYTES / 2), W_BYTES, &s.bar[kc & 1]);
}

// Threads tid < 64: the epilogue's constants of the tile's 64 channels
// from n0.
template <int EPI>
__device__ __forceinline__ void epilogue_constants(const ConvParams& p, const TileSmem& s,
                                                   int n0) {
  const int tid = threadIdx.x, C = p.g.C;
  if (tid >= CK) return;
  const int c = n0 + tid;
  float* econ = s.econ;
  if constexpr (EPI == EP_PRELU_BWD) {
    const float m = p.emv[c], inv = inv_std(p.emv[C + c], p.eps);
    econ[tid] = rnd<bf16>(m);
    econ[64 + tid] = rnd<bf16>(inv);
    econ[128 + tid] = rnd<bf16>(p.egam[c]);
    econ[192 + tid] = rnd<bf16>(p.ebet[c]);
    econ[256 + tid] = m;
    econ[320 + tid] = inv;
  } else if constexpr (EPI == EP_GRAD) {
    if (p.ea != nullptr) {
      econ[256 + tid] = p.emv[c];
      econ[320 + tid] = inv_std(p.emv[C + c], p.eps);
    }
  }
}

// The mainloop of the tile at q0 in N tile nt: acc (zeroed here) gets the
// 9 taps x C products. The copies of the stages' first chunks (kc <
// stages) must have been issued; those of chunks kc + 2 are issued here.
// `ph` holds each stage's mbarrier parity (bit s) and is advanced here, so
// that a CTA's next tile continues where this one left it. Returns with
// every product done and a block barrier passed: the ring and the windows
// are free.
//
// The accumulator fragment of wgmma m64n64 (f32): acc[4 t + 2 hh + e] is
// row 16 warp + g + 8 hh, column 8 t + 2 q + e (g = lane / 4, q = lane % 4).
template <int LOAD>
__device__ __forceinline__ void conv_mainloop(const ConvParams& p, const TileSmem& s,
                                              long long q0, int nt, float (&acc)[32],
                                              unsigned& ph) {
  const Geom& g = p.g;
  const int nk = s.nk, win_bytes = s.win_bytes, tid = threadIdx.x;
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  load_window<LOAD>(p, s.wins, q0, 0, nt == 0);
  hop::cp_async_commit();
  if (nk > 1) load_window<LOAD>(p, s.wins + win_bytes, q0, CK, nt == 0);
  hop::cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    const int st = kc & 1;
    hop::cp_async_wait<1>();  // chunk kc's copies have landed (this thread's)
    hop::fence_async_smem();  // ... and its stores, for the async proxy
    hop::mbar_wait(&s.bar[st], (ph >> st) & 1u);
    ph ^= 1u << st;
    __syncthreads();
    hop::wg_fence();
    const uint32_t wa = hop::smem_addr(s.wins + st * win_bytes);
    const uint32_t wb = hop::smem_addr(s.wring + st * W_BYTES);
    for (int tap = 0; tap < 9; ++tap) {
      const int row = (tap / 3) * g.tapstride + tap % 3;  // the tap's shift, in rows
#pragma unroll
      for (int k = 0; k < KG / 2; ++k)
        hop::wgmma_bf16<64>(
            acc, hop::desc(wa + (uint32_t)((2 * k * g.rows + row) * 16), g.rows * 16, 128),
            hop::desc(wb + (uint32_t)((tap * KG + 2 * k) * CK * 16), CK * 16, 128));
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    __syncthreads();  // stage st is free
    if (kc + 2 < nk) {
      if (tid == 0) issue_weights(p, s, nt, kc + 2);
      load_window<LOAD>(p, s.wins + st * win_bytes, q0, (kc + 2) * CK, nt == 0);
    }
    hop::cp_async_commit();
  }
}

// The epilogue of the tile (M tile mt, N tile nt): stores what its mode
// stores and writes the tile's partials part[mt][k][n0 + c] (K = 3
// quantities for EP_PRELU_BWD, else 2). Padding positions and positions
// past the grid are dropped. Returns false, with no partials written, for
// EP_GRAD without `ea`.
template <int EPI>
__device__ __forceinline__ bool conv_epilogue(const ConvParams& p, const TileSmem& s, int mt,
                                              int nt, const float (&acc)[32]) {
  const Geom& g = p.g;
  const int C = g.C, n0 = nt * CK;
  const long long q0 = (long long)mt * MT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q4 = lane & 3;
  const float* econ = s.econ;
  float* red = s.red;
  constexpr int K = EPI == EP_PRELU_BWD ? 3 : 2;
  float ps[K][16];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 16; ++i) ps[k][i] = 0.f;
  const float al = EPI == EP_PRELU_BWD ? *p.eal : 0.f, alT = rnd<bf16>(al);
  // the global values the epilogue reads, loaded before any store (which
  // the compiler may not move them past)
  long long pixs[2];
  __nv_bfloat162 ev[2][8], rv[2][8];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    pixs[hh] = pixel_of(g, q0 + 16 * warp + gq + 8 * hh);
    if (EPI == EP_STATS || pixs[hh] < 0) continue;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const size_t o = (size_t)pixs[hh] * C + n0 + 8 * t + 2 * q4;
      if (p.ea != nullptr) ev[hh][t] = *reinterpret_cast<const __nv_bfloat162*>(p.ea + o);
      if constexpr (EPI == EP_GRAD)
        rv[hh][t] = *reinterpret_cast<const __nv_bfloat162*>(p.resid + o);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long long pix = pixs[hh];
    if (pix < 0) continue;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int col = 8 * t + 2 * q4;
      const size_t o = (size_t)pix * C + n0 + col;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) v[e] = acc[4 * t + 2 * hh + e];
      if constexpr (EPI == EP_STATS) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = rnd<bf16>(v[e]);
          ps[0][2 * t + e] = __fadd_rn(ps[0][2 * t + e], v[e]);
          ps[1][2 * t + e] = __fadd_rn(ps[1][2 * t + e], __fmul_rn(v[e], v[e]));
        }
        store2(static_cast<bf16*>(p.out) + o, v[0], v[1]);
      } else if constexpr (EPI == EP_PRELU_BWD) {
        // dgrad2's dh -> the PReLU backward at the recomputed input; h for wgrad2
        const float2 a = __bfloat1622float2(ev[hh][t]);
        const float av[2] = {a.x, a.y};
        float h[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col + e;
          const float pre = bn_affine<bf16>(av[e], econ[c], econ[64 + c], econ[128 + c],
                                            econ[192 + c]);
          const bool neg = pre < 0.f;
          h[e] = neg ? __fmul_rn(alT, pre) : pre;
          if (neg) ps[2][2 * t + e] = __fadd_rn(ps[2][2 * t + e], __fmul_rn(v[e], pre));
          const float d = neg ? __fmul_rn(v[e], al) : v[e];
          const float xh = __fmul_rn(__fsub_rn(av[e], econ[256 + c]), econ[320 + c]);
          ps[0][2 * t + e] = __fadd_rn(ps[0][2 * t + e], d);
          ps[1][2 * t + e] = __fadd_rn(ps[1][2 * t + e], __fmul_rn(d, xh));
          v[e] = d;
        }
        store2(p.hout + o, h[0], h[1]);
        store2(static_cast<float*>(p.out) + o, v[0], v[1]);
      } else {
        // dgrad1: g <- bf16(g + acc); block j-1's BN2 sums of the new g
        const float2 r = __bfloat1622float2(rv[hh][t]);
        v[0] = rnd<bf16>(__fadd_rn(r.x, v[0]));
        v[1] = rnd<bf16>(__fadd_rn(r.y, v[1]));
        store2(static_cast<bf16*>(p.out) + o, v[0], v[1]);
        if (p.ea != nullptr) {
          const float2 a = __bfloat1622float2(ev[hh][t]);
          const float av[2] = {a.x, a.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = col + e;
            const float xh = __fmul_rn(__fsub_rn(av[e], econ[256 + c]), econ[320 + c]);
            ps[0][2 * t + e] = __fadd_rn(ps[0][2 * t + e], v[e]);
            ps[1][2 * t + e] = __fadd_rn(ps[1][2 * t + e], __fmul_rn(v[e], xh));
          }
        }
      }
    }
  }
  if constexpr (EPI == EP_GRAD) {
    if (p.ea == nullptr) return false;  // block 0: no BN2 before it
  }

  // the tile's partials: 2 rows, then the 8 lanes of a column, then the warps
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float v = ps[k][i];
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
      if (gq == 0) red[(k * 4 + warp) * 64 + 8 * (i >> 1) + 2 * q4 + (i & 1)] = v;
    }
  __syncthreads();
  for (int idx = tid; idx < K * 64; idx += CONV_THREADS) {
    const float* r = red + (idx / 64) * 256 + idx % 64;
    p.part[((size_t)mt * K + idx / 64) * C + n0 + idx % 64] =
        __fadd_rn(__fadd_rn(__fadd_rn(r[0], r[64]), r[128]), r[192]);
  }
  return true;
}

}  // namespace tw
}  // namespace srgan


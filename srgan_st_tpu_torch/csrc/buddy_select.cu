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
// TF32). Ties go to the FIRST occurrence: one thread owns a row and scans
// the bank in increasing m with a strict `<`, so there is no merge between
// threads that could let a later equal score win. Only real bank rows are
// scored: the last bank tile is cut to M, nothing is padded. The gather of
// the selected rows and the stop-gradient stay outside, in torch.
//
// What bounds it on an H100: at the PatchwiseST shape, p1/p2 (16, 1024, 27)
// and a bank of (16, 1344, 27) in bf16, it reads 3.0 MB and does 2.38 GFLOP
// of scoring (two 27-wide dots and the score per (n, m) pair). bf16 x bf16
// products are exact in f32, so the function's bound is the 989 TFLOP/s
// bf16 tensor-core peak, ~0.0024 ms, against ~0.001 ms of memory:
// operations bound it. This version's SIMT f32 FMAs cap it at the 67
// TFLOP/s of non-tensor f32, ~0.035 ms. It is plain: one block per
// (b, 64 rows), each thread one row held in registers (features padded to
// a compile-time width DP with zeros, which add nothing to any score), bank
// tiles of 64 rows staged through shared memory as f32 with their norms;
// every thread reads the same bank element at a time (a shared-memory
// broadcast).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;    // rows of p per block, one per thread
constexpr int MTILE = 64;   // bank rows per shared-memory tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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

  float best = __int_as_float(0x7f800000);  // +inf
  int arg = 0;
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
      if (score < best) {  // strict: the first of equal scores stays
        best = score;
        arg = m0 + r;
      }
    }
  }
  if (live) idx[(size_t)b * N + n] = arg;
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

}  // namespace

// p1, p2 (B, N, d) and bank (B, M, d), contiguous, d <= 160 (ksize 7 gives
// 147); writes idx (B, N) int32. l1 = 0: squared l2 scores, 1: l1.
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

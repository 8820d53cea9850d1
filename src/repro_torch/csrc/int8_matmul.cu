// W8A8 matmul: out = f32(sum_k xq[m, k] * wq[k, n]) * s, the sum exact in
// int32, s = f32(sx) * f32(sw) formed once by the caller.
//
// int8_matmul_launch replaces the TPU kernel `_int8_matmul_kernel` of
// src/repro/kernels/fxp_matmul.py (reached through `int8_matmul`, and
// through `int8_matmul_vjp`, whose backward reruns it at unit scale). Any
// <M, K, N> is accepted: the K tail of both operands reads as zero words (the
// TPU kernel's `_mask_tail`), so the int32 sum over it is exactly 0, and
// rows and columns past M and N are not written. The epilogue is
// __fmul_rn(__int2float_rn(acc), s): the int32 sum rounded once to f32
// (nearest even), then one f32 product, as the TPU kernel's
// `acc.astype(f32) * s`.
//
// What bounds it on an H100: its operations (2MKN at 1979 TOP/s of dense
// int8 on the tensor cores) for every shape of a dense layer at M >= 64,
// its bytes (MK + KN + 4MN) below. Design, a simple kernel that is right:
// SIMT __dp4a (four int8 products summed into an int32, exact) on a
// 128 x 128 output tile per block of 256 threads, 8 x 8 outputs per thread
// (rows ty + 16i, columns tx + 16j), k in steps of 32. The (K, N) row-major
// words have n contiguous, and __dp4a wants four consecutive k of one n in
// one register: each step loads the x tile and the w tile byte by byte
// (coalesced, 32 bytes per warp and row, zero past the edges) into shared
// memory, the w tile transposed to [n][k], with rows padded to 9 words so
// that the 16 columns a warp reads fall in distinct banks. The tensor
// cores (mma.sync s8 or wgmma) are a later PR's work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int NT = 256;
constexpr int TM = 8, TN = 8;
constexpr int KW = BK / 4;      // int32 words of k per tile row
constexpr int LD = KW + 1;      // padded row stride in words

__global__ void __launch_bounds__(NT)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ s, float* __restrict__ out,
                   int M, int K, int N) {
  __shared__ int sa[BM * LD];   // [m][k]: four k per word
  __shared__ int sb[BN * LD];   // [n][k]: the w tile transposed
  int8_t* sa8 = reinterpret_cast<int8_t*>(sa);
  int8_t* sb8 = reinterpret_cast<int8_t*>(sb);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const long long n0 = (long long)blockIdx.y * BN;
  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < BM * BK / NT; ++r) {
      const int idx = tid + NT * r;
      const int row = idx / BK, kk = idx % BK;
      const long long gm = m0 + row;
      const int gk = k0 + kk;
      sa8[row * LD * 4 + kk] = (gm < M && gk < K) ? x[gm * K + gk] : (int8_t)0;
    }
#pragma unroll
    for (int r = 0; r < BK * BN / NT; ++r) {
      const int idx = tid + NT * r;
      const int kk = idx / BN, col = idx % BN;
      const int gk = k0 + kk;
      const long long gn = n0 + col;
      sb8[col * LD * 4 + kk] =
          (gk < K && gn < N) ? w[(long long)gk * N + gn] : (int8_t)0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sa[(ty + 16 * i) * LD + kw];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sb[(tx + 16 * j) * LD + kw];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float sc = *s;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long gn = n0 + tx + 16 * j;
      if (gn < N) out[gm * N + gn] = __fmul_rn(__int2float_rn(acc[i][j]), sc);
    }
  }
}

}  // namespace

extern "C" {

// out (M, N) f32 = f32(xq (M, K) int8 @ wq (K, N) int8, exact int32) * *s,
// s a device f32 scalar. Returns cudaGetLastError().
int int8_matmul_launch(const void* xq, const void* wq, const void* s, void* out,
                       int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const long long gy = ((long long)N + BN - 1) / BN;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(((long long)M + BM - 1) / BM), (unsigned)gy);
  int8_matmul_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(s), static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"

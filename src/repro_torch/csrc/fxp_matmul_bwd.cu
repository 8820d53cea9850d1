// Backward of the fixed-point dense layer y = (x @ wq) * 2^-FL: the two
// straight-through products of paper alg. 1.
//
//  * matmul_dx replaces the TPU kernel `_matmul_dx_kernel` of
//    src/repro/kernels/fxp_matmul.py (reached through `matmul_dx`):
//    dx = (dy @ wq^T) * scale. dy is (M, N) bf16 or f32, wq the forward's
//    (K, N) int8 words, the scale a device scalar (bf16 or f32, 2^-FL) read
//    by the kernel, and dx (M, K) bf16 or f32.
//  * matmul_dw replaces `_matmul_dw_kernel` (reached through `matmul_dw`):
//    dw = x^T @ dy with f32 accumulation over M. x is (M, K), dy (M, N),
//    both bf16 or both f32; dw is (K, N) f32, or bf16 rounded to nearest
//    even (the cast of `_fxp_dense_diff_bwd` onto the bf16 receiver).
// Any <M, K, N>: every load is bounds-checked, so ragged tails contribute
// exact zeros, and every store is masked.
//
// What bounds them on an H100: at the training shapes (M = batch * seq in
// the thousands) the 2*M*K*N operations; the bytes (dy, x, the int8 words
// and the output) are read or written once and are a few percent of that
// time at the bf16 tensor-core rate.
//
// Design (first, simple version; the tensor-core path is later work): a
// shared-memory-tiled SIMT GEMM, 128x128 output tiles, the contraction in
// steps of 16, 256 threads each holding an 8x8 f32 accumulator (rows and
// columns in two groups of four, so the shared-memory reads are float4s
// that spread over the banks). Products are exact in f32 (an int8 word or
// a bf16 value times a bf16 value fits 16 significand bits); only the sums
// round.
//  * dx: each block owns a 128x128 tile of dx and loops over N itself. It
//    loads the dy tile and the (128 k x 16 n) tile of words, both
//    contiguous along n, so the transposed read of wq needs no transposed
//    copy; the words become f32 between the global load and the
//    shared-memory store, so no dequantized weight reaches device memory.
//  * dw: the TPU kernel carries its accumulator across the M grid; here
//    blocks run in any order, so each block owns a 128x128 tile of dw and
//    loops over all of M itself (no atomics, no second pass).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 128;   // output tile edge
constexpr int BC = 16;    // contraction step
constexpr int NT = 256;   // threads: 16 x 16, 8 x 8 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ float read_scale(const void* scale, int scale_bf16) {
  return scale_bf16 ? __bfloat162float(*static_cast<const __nv_bfloat16*>(scale))
                    : *static_cast<const float*>(scale);
}

// Eight consecutive elements of a row as f32, by one vector load (the
// caller has checked 16-byte alignment of every row start and that all
// eight lie in bounds).
__device__ __forceinline__ void load8_vec(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8_vec(const int8_t* p, float (&v)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const char4 a = *reinterpret_cast<const char4*>(&u.x);
  const char4 b = *reinterpret_cast<const char4*>(&u.y);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// p[0..7] as f32, of which the first `n` are in bounds (n may be <= 0);
// the rest read as zeros.
template <typename T>
__device__ __forceinline__ void load8(const T* p, int n, bool vec, float (&v)[8]) {
  if (vec && n >= 8) {
    load8_vec(p, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = j < n ? to_f32(p[j]) : 0.f;
}

// Row (or column) of the tile held by thread coordinate t, slot i < 8:
// two groups of four, 64 apart.
__device__ __forceinline__ int tile_idx(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

// acc[i][j] += sum_c A[c][row i] * B[c][col j] over one BC step.
__device__ __forceinline__ void mma_step(const float (*As)[BT], const float (*Bs)[BT],
                                         int ty, int tx, float (&acc)[8][8]) {
#pragma unroll
  for (int c = 0; c < BC; ++c) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[c][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[c][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[c][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[c][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// dx = (dy @ wq^T) * scale

template <typename TY, typename TO>
__global__ void __launch_bounds__(NT)
matmul_dx_kernel(const TY* __restrict__ dy, const int8_t* __restrict__ w,
                 const void* __restrict__ scale, int scale_bf16,
                 TO* __restrict__ dx, int M, int N, int K, int vec_dy, int vec_w) {
  __shared__ __align__(16) float As[BC][BT];   // dy tile, n-major
  __shared__ __align__(16) float Bs[BC][BT];   // word tile, n-major
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BT, k0 = blockIdx.x * BT;
  const int lr = tid >> 1, lc = (tid & 1) * 8;   // loader: row, first column

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += BC) {
    float v[8];
    const int gn = n0 + lc;
    const int gm = m0 + lr;
    load8(dy + (size_t)gm * N + gn, gm < M ? N - gn : 0, vec_dy, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) As[lc + j][lr] = v[j];
    const int gk = k0 + lr;
    load8(w + (size_t)gk * N + gn, gk < K ? N - gn : 0, vec_w, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) Bs[lc + j][lr] = v[j];
    __syncthreads();
    mma_step(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  const float s = read_scale(scale, scale_bf16);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + tile_idx(ty, i);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gk = k0 + tile_idx(tx, j);
      if (gk < K) dx[(size_t)gm * K + gk] = from_f32<TO>(acc[i][j] * s);
    }
  }
}

// ---------------------------------------------------------------------------
// dw = x^T @ dy

template <typename TX, typename TO>
__global__ void __launch_bounds__(NT)
matmul_dw_kernel(const TX* __restrict__ x, const TX* __restrict__ dy,
                 TO* __restrict__ dw, int M, int K, int N, int vec_x, int vec_dy) {
  __shared__ __align__(16) float As[BC][BT];   // x tile, m-major
  __shared__ __align__(16) float Bs[BC][BT];   // dy tile, m-major
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.y * BT, n0 = blockIdx.x * BT;
  const int lr = tid >> 4, lc = (tid & 15) * 8;  // loader: row (m), first column

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int m0 = 0; m0 < M; m0 += BC) {
    float v[8];
    const int gm = m0 + lr;
    load8(x + (size_t)gm * K + k0 + lc, gm < M ? K - (k0 + lc) : 0, vec_x, v);
    *reinterpret_cast<float4*>(&As[lr][lc]) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(&As[lr][lc + 4]) = make_float4(v[4], v[5], v[6], v[7]);
    load8(dy + (size_t)gm * N + n0 + lc, gm < M ? N - (n0 + lc) : 0, vec_dy, v);
    *reinterpret_cast<float4*>(&Bs[lr][lc]) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(&Bs[lr][lc + 4]) = make_float4(v[4], v[5], v[6], v[7]);
    __syncthreads();
    mma_step(As, Bs, ty, tx, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gk = k0 + tile_idx(ty, i);
    if (gk >= K) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tile_idx(tx, j);
      if (gn < N) dw[(size_t)gk * N + gn] = from_f32<TO>(acc[i][j]);
    }
  }
}

// Vector loads need every row start on a 16-byte boundary: the base
// pointer aligned and the row length a multiple of eight elements.
bool rows_aligned(const void* p, int ld) {
  return ld % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename TY, typename TO>
cudaError_t launch_dx(const void* dy, const int8_t* w, const void* scale, int sb,
                      void* dx, int M, int N, int K, cudaStream_t st) {
  const dim3 grid((K + BT - 1) / BT, (M + BT - 1) / BT);
  matmul_dx_kernel<TY, TO><<<grid, NT, 0, st>>>(
      static_cast<const TY*>(dy), w, scale, sb, static_cast<TO*>(dx), M, N, K,
      rows_aligned(dy, N), rows_aligned(w, N));
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t launch_dw(const void* x, const void* dy, void* dw, int M, int K, int N,
                      cudaStream_t st) {
  const dim3 grid((N + BT - 1) / BT, (K + BT - 1) / BT);
  matmul_dw_kernel<TX, TO><<<grid, NT, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(dy), static_cast<TO*>(dw),
      M, K, N, rows_aligned(x, K), rows_aligned(dy, N));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Both return cudaGetLastError().

// dx (M, K) = (dy (M, N) @ w (K, N) int8 ^T) * scale.
int matmul_dx_launch(const void* dy, int dy_dtype, const void* w,
                     const void* scale, int scale_dtype, void* dx, int dx_dtype,
                     int M, int N, int K, void* stream) {
  if (M <= 0 || K <= 0) return (int)cudaGetLastError();
  const int8_t* wp = static_cast<const int8_t*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sb = scale_dtype == 1;
  cudaError_t err;
  if (dy_dtype == 1 && dx_dtype == 1)
    err = launch_dx<__nv_bfloat16, __nv_bfloat16>(dy, wp, scale, sb, dx, M, N, K, st);
  else if (dy_dtype == 1 && dx_dtype == 0)
    err = launch_dx<__nv_bfloat16, float>(dy, wp, scale, sb, dx, M, N, K, st);
  else if (dy_dtype == 0 && dx_dtype == 1)
    err = launch_dx<float, __nv_bfloat16>(dy, wp, scale, sb, dx, M, N, K, st);
  else
    err = launch_dx<float, float>(dy, wp, scale, sb, dx, M, N, K, st);
  return (int)err;
}

// dw (K, N) = x (M, K)^T @ dy (M, N); x and dy share `in_dtype`.
int matmul_dw_launch(const void* x, const void* dy, int in_dtype, void* dw,
                     int dw_dtype, int M, int K, int N, void* stream) {
  if (K <= 0 || N <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_dtype == 1 && dw_dtype == 1)
    err = launch_dw<__nv_bfloat16, __nv_bfloat16>(x, dy, dw, M, K, N, st);
  else if (in_dtype == 1 && dw_dtype == 0)
    err = launch_dw<__nv_bfloat16, float>(x, dy, dw, M, K, N, st);
  else if (in_dtype == 0 && dw_dtype == 1)
    err = launch_dw<float, __nv_bfloat16>(x, dy, dw, M, K, N, st);
  else
    err = launch_dw<float, float>(x, dy, dw, M, K, N, st);
  return (int)err;
}

}  // extern "C"

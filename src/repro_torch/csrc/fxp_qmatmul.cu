// The quantize-prologue dense layer: the matmul reads the f32 MASTER weight
// and draws its <8, FL> words in registers on the way into shared memory, so
// no word tensor exists in device memory (paper alg. 1 ln. 9-11 fused into
// the forward's and the backward's products).
//
//  * fxp_qmatmul replaces the TPU kernel `_fxp_qmatmul_kernel` of
//    src/repro/kernels/fxp_matmul.py (reached through `fxp_qmatmul`):
//    y = (x @ Q(w)) * 2^-fl. x is (M, K) bf16 or f32, w the (K, N) f32
//    master, y (M, N) bf16 or f32.
//  * matmul_qdx replaces `_matmul_qdx_kernel` (reached through
//    `matmul_qdx`): dx = (dy @ Q(w)^T) * 2^-fl, dy (M, N), dx (M, K), the
//    same words drawn again from the same (K, N) master read along n.
//
// The word of element (k, n) (`_quantize_w_tile`, fxp_matmul.py:329-342):
// s = w * 2^fl; mode 1 rounds stochastically, floor(s) + [u < s - floor(s)]
// with u the portable counter hash of the uint32 index k * N + n (the
// murmur3 finalizer of idx + (uint32)seed * 0x9E3779B9, u = (h >> 8) *
// 2^-24), mode 0 to nearest, half to even (rintf); then clipped to
// [-128, 127]. The words depend on the element alone, not on the tiling, so
// the forward and dx draw the same words, and for a 2-D leaf they are
// `sr_quantize_fused_int8`'s. FL is read from device memory (no host
// synchronisation); seed and mode are host ints. Products are exact in f32
// (a word times a bf16 value fits 16 significand bits); the f32 sums round;
// the scale 2^-fl is applied once to the f32 sum. Any <M, K, N>: elements
// out of range are zero and are never hashed.
//
// What bounds them on an H100: at the training shapes (M = batch * seq in
// the thousands) the 2*M*K*N operations at the bf16 tensor-core rate; the
// bytes (x or dy, the f32 master, the output) are a few percent of that.
//
// Design (first, simple version; the tensor-core path is later work): the
// SIMT tiling of fxp_matmul_bwd.cu, 128x128 output tiles, the contraction in
// steps of 16, 256 threads each holding an 8x8 f32 accumulator. Each block
// quantizes the 16 x 128 master tile it needs (2048 hashes per step against
// 262144 multiply-adds), so the master is re-read, and its words redrawn,
// once per 128-row block of the output.
//  * qmatmul: the x tile is read along k and transposed into shared memory;
//    the master tile is read along n, 8 elements a thread.
//  * qdx: each block owns a 128x128 tile of dx and loops over N; the dy
//    tile and the (128 k x 16 n) master tile are both read along n and
//    transposed into shared memory, so the transposed read of w needs no
//    transposed copy.

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

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float pow2i(int e) {
  e = min(max(e, -126), 127);
  return __int_as_float((e + 127) << 23);
}

// The <8, fl> word of a master element with flat index idx (as a float).
struct Quant {
  float scale;
  uint32_t seed_mix;
  int mode;

  __device__ __forceinline__ float operator()(float w, uint32_t idx) const {
    const float s = __fmul_rn(w, scale);
    float q;
    if (mode == 1) {
      uint32_t h = idx + seed_mix;
      h ^= h >> 16;
      h *= 0x7FEB352Du;
      h ^= h >> 15;
      h *= 0x846CA68Bu;
      h ^= h >> 16;
      const float u = __fmul_rn((float)(h >> 8), 1.0f / 16777216.0f);
      const float f = floorf(s);
      q = __fadd_rn(f, u < __fsub_rn(s, f) ? 1.0f : 0.0f);
    } else {
      q = rintf(s);
    }
    // a NaN passes, as jnp.clip's
    return q < -128.0f ? -128.0f : (q > 127.0f ? 127.0f : q);
  }
};

// Eight consecutive elements of a row as f32, by vector loads (the caller
// has checked 16-byte alignment of every row start and that all eight lie
// in bounds).
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

// The words of master row k, columns n .. n+7 (those < N), zero elsewhere.
__device__ __forceinline__ void load8_words(const float* __restrict__ w, int k,
                                            int n, int K, int N, bool vec,
                                            const Quant& quant, float (&v)[8]) {
  const int live = k < K ? N - n : 0;
  load8(w + (size_t)k * N + n, live, vec, v);
  const uint32_t idx = (uint32_t)k * (uint32_t)N + (uint32_t)n;
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = j < live ? quant(v[j], idx + (uint32_t)j) : 0.f;
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

// out[(r0 + row) * ld + c0 + col] = acc * scale for the tile's live part.
template <typename TO>
__device__ __forceinline__ void store_tile(TO* __restrict__ out, const float (&acc)[8][8],
                                           float scale, int r0, int c0, int R, int C,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + tile_idx(ty, i);
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + tile_idx(tx, j);
      if (c < C) out[(size_t)r * C + c] = from_f32<TO>(__fmul_rn(acc[i][j], scale));
    }
  }
}

// ---------------------------------------------------------------------------
// y = (x @ Q(w)) * 2^-fl

template <typename TX, typename TO>
__global__ void __launch_bounds__(NT)
fxp_qmatmul_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ fl, uint32_t seed_mix, int mode,
                   TO* __restrict__ y, int M, int N, int K, int vec_x, int vec_w) {
  __shared__ __align__(16) float As[BC][BT];   // x tile, k-major
  __shared__ __align__(16) float Bs[BC][BT];   // word tile, k-major
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BT, n0 = blockIdx.x * BT;
  const int ar = tid >> 1, ac = (tid & 1) * 8;   // x loader: row m, first k
  const int br = tid >> 4, bc = (tid & 15) * 8;  // word loader: row k, first n
  const int f = *fl;
  const Quant quant{pow2i(f), seed_mix, mode};

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BC) {
    float v[8];
    const int gm = m0 + ar, gk = k0 + ac;
    load8(x + (size_t)gm * K + gk, gm < M ? K - gk : 0, vec_x, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) As[ac + j][ar] = v[j];
    load8_words(w, k0 + br, n0 + bc, K, N, vec_w, quant, v);
    *reinterpret_cast<float4*>(&Bs[br][bc]) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(&Bs[br][bc + 4]) = make_float4(v[4], v[5], v[6], v[7]);
    __syncthreads();
    mma_step(As, Bs, ty, tx, acc);
    __syncthreads();
  }
  store_tile(y, acc, pow2i(-f), m0, n0, M, N, ty, tx);
}

// ---------------------------------------------------------------------------
// dx = (dy @ Q(w)^T) * 2^-fl

template <typename TY, typename TO>
__global__ void __launch_bounds__(NT)
matmul_qdx_kernel(const TY* __restrict__ dy, const float* __restrict__ w,
                  const int* __restrict__ fl, uint32_t seed_mix, int mode,
                  TO* __restrict__ dx, int M, int N, int K, int vec_dy, int vec_w) {
  __shared__ __align__(16) float As[BC][BT];   // dy tile, n-major
  __shared__ __align__(16) float Bs[BC][BT];   // word tile, n-major
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BT, k0 = blockIdx.x * BT;
  const int lr = tid >> 1, lc = (tid & 1) * 8;   // loader: row, first column
  const int f = *fl;
  const Quant quant{pow2i(f), seed_mix, mode};

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += BC) {
    float v[8];
    const int gn = n0 + lc, gm = m0 + lr;
    load8(dy + (size_t)gm * N + gn, gm < M ? N - gn : 0, vec_dy, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) As[lc + j][lr] = v[j];
    load8_words(w, k0 + lr, gn, K, N, vec_w, quant, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) Bs[lc + j][lr] = v[j];
    __syncthreads();
    mma_step(As, Bs, ty, tx, acc);
    __syncthreads();
  }
  store_tile(dx, acc, pow2i(-f), m0, k0, M, K, ty, tx);
}

// Vector loads need every row start on a 16-byte boundary: the base
// pointer aligned and the row length a multiple of eight elements.
bool rows_aligned(const void* p, int ld) {
  return ld % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename TA, typename TO>
cudaError_t launch(bool qdx, const void* a, const float* w, const int* fl, int seed,
                   int mode, void* out, int M, int N, int K, cudaStream_t st) {
  const uint32_t seed_mix = (uint32_t)seed * 0x9E3779B9u;
  const TA* ap = static_cast<const TA*>(a);
  TO* op = static_cast<TO*>(out);
  const int vec_w = rows_aligned(w, N);
  if (qdx) {
    const dim3 grid((K + BT - 1) / BT, (M + BT - 1) / BT);
    matmul_qdx_kernel<TA, TO><<<grid, NT, 0, st>>>(ap, w, fl, seed_mix, mode, op, M, N,
                                                   K, rows_aligned(a, N), vec_w);
  } else {
    const dim3 grid((N + BT - 1) / BT, (M + BT - 1) / BT);
    fxp_qmatmul_kernel<TA, TO><<<grid, NT, 0, st>>>(ap, w, fl, seed_mix, mode, op, M, N,
                                                    K, rows_aligned(a, K), vec_w);
  }
  return cudaGetLastError();
}

cudaError_t dispatch(bool qdx, const void* a, int a_dtype, const void* w,
                     const void* fl, int seed, int mode, void* out, int out_dtype,
                     int M, int N, int K, void* stream) {
  const float* wp = static_cast<const float*>(w);
  const int* flp = static_cast<const int*>(fl);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(qdx, a, wp, flp, seed, mode, out, M, N, K, st);
  if (a_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(qdx, a, wp, flp, seed, mode, out, M, N, K, st);
  if (a_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(qdx, a, wp, flp, seed, mode, out, M, N, K, st);
  return launch<float, float>(qdx, a, wp, flp, seed, mode, out, M, N, K, st);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. `fl` is a device int32 scalar;
// `seed` the int32 seed, `mode` 1 (SR) or 0 (round to nearest). Both return
// cudaGetLastError().

// y (M, N) = (x (M, K) @ Q(w (K, N) f32)) * 2^-fl.
int fxp_qmatmul_launch(const void* x, int x_dtype, const void* w, const void* fl,
                       int seed, int mode, void* y, int y_dtype, int M, int N,
                       int K, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  return (int)dispatch(false, x, x_dtype, w, fl, seed, mode, y, y_dtype, M, N, K,
                       stream);
}

// dx (M, K) = (dy (M, N) @ Q(w (K, N) f32)^T) * 2^-fl.
int matmul_qdx_launch(const void* dy, int dy_dtype, const void* w, const void* fl,
                      int seed, int mode, void* dx, int dx_dtype, int M, int N,
                      int K, void* stream) {
  if (M <= 0 || K <= 0) return (int)cudaGetLastError();
  return (int)dispatch(true, dy, dy_dtype, w, fl, seed, mode, dx, dx_dtype, M, N, K,
                       stream);
}

}  // extern "C"

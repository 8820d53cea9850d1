// Fixed-point matmul with the dequantize in registers: y = (x @ wq) * 2^-FL.
//
// Replaces the TPU kernel `_fxp_matmul_kernel` of
// src/repro/kernels/fxp_matmul.py (reached through `fxp_matmul`, its
// pallas_call). x is (M, K) bf16 or f32, wq is (K, N) int8 words, the scale
// is a device scalar (bf16 or f32) applied in f32 once to the f32 sum, and
// y is (M, N) bf16 or f32. Any <M, K, N>: elements out of range read as
// zeros, so ragged K tails contribute exact zeros, and every store is
// masked.
//
// What bounds it on an H100: at decode (M = batch) the int8 weight bytes,
// K*N per call, over 3.35 TB/s; at prefill and in training (M = batch*seq
// in the hundreds or thousands) the 2*M*K*N operations at the bf16
// tensor-core rate. No kernel writes a dequantized weight to device
// memory: the words are converted on the way from device memory to the
// products, so the bytes moved are the int8 words.
//
// Three kernels, chosen by the wrapper by dtype and M alone:
//  * bf16 x, M > 16 (prefill, training): fxp_matmul_tc, on the tensor
//    cores. It is matmul_dx_tc's pipeline (tc_words.cuh) with the operands
//    swapped: x is A, K-major by TMA (boxes of 64 k x 256 rows); the words
//    (K, N) arrive by TMA in boxes of 64 n x 64 k, and producer warpgroups
//    convert them to bf16 (exact) into the MN-major swizzled layout that
//    fxp_qmatmul_tc writes for its drawn words, which wgmma reads with the
//    transpose bit. A CTA owns 256 rows and 64 columns of y, with two
//    consumer warpgroups and two producer warpgroups taking the steps of
//    64 along k in turn, the registers split 168 / 88 by setmaxnreg; the
//    accumulators restart every 32 steps into round-to-nearest totals
//    (wgmma's sums round toward zero). Rows past M read as zeros and are
//    not stored, so it takes any M. It replaces a SIMT kernel that ran at
//    15x torch.matmul's time (PERF.md section 6).
//  * f32 x, M > 16: a shared-memory-tiled SIMT GEMM, 64x64 output tiles,
//    K in steps of 32, 256 threads each holding a 4x4 f32 accumulator; f32
//    FMA on exact products (an int8 word and a bf16 activation are both
//    exact in f32). Words come in 4-byte vector loads where N and the
//    pointer allow it, and are stored to shared memory already converted
//    to f32.
//  * M <= 16 (decode, either dtype): a split-K GEMV. Each warp owns 128
//    columns (4 per lane, one 4-byte load of words per k) and a chunk of K,
//    accumulates all M rows in registers, and adds its partial sums into
//    an f32 workspace with atomicAdd; a second small kernel applies the
//    scale and writes y. The many independent loads per warp keep the
//    memory system busy where a tiled kernel would leave most SMs idle.
//    The order of the f32 atomic sums varies from run to run (last-bit
//    differences).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"
#include "tc_words.cuh"

namespace {

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
  return __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ float read_scale(const void* scale, int scale_bf16) {
  return scale_bf16 ? __bfloat162float(*static_cast<const __nv_bfloat16*>(scale))
                    : *static_cast<const float*>(scale);
}

// ---------------------------------------------------------------------------
// Tiled kernel (M > 16)

constexpr int BM = 64, BN = 64, BK = 32, TM = 4, TN = 4;
constexpr int NT = (BM / TM) * (BN / TN);  // 256 threads

template <typename TX, typename TY>
__global__ void __launch_bounds__(NT)
fxp_matmul_tiled(const TX* __restrict__ x, const int8_t* __restrict__ w,
                 const void* __restrict__ scale, int scale_bf16,
                 TY* __restrict__ y, int M, int N, int K, int vec4) {
  __shared__ float As[BK][BM + 1];             // x tile, k-major (+1: no bank conflicts)
  __shared__ __align__(16) float Bs[BK][BN];   // word tile, converted to f32
  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN), tc = tid % (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: consecutive threads read consecutive k (coalesced).
#pragma unroll
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
    }
    // word tile: 4 words per thread and load (BK*BN/4 = 512 loads), stored
    // as one float4, so a quarter-warp's stores cover 128 contiguous bytes.
#pragma unroll
    for (int i = tid; i < BK * BN / 4; i += NT) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const int gk = k0 + r, gn = n0 + c;
      float4 f;
      if (vec4 && gk < K && gn + 4 <= N) {
        const char4 v = *reinterpret_cast<const char4*>(w + (size_t)gk * N + gn);
        f = make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
      } else {
        const int8_t* wr = w + (size_t)gk * N + gn;
        const bool rk = gk < K;
        f = make_float4(rk && gn < N ? (float)wr[0] : 0.f,
                        rk && gn + 1 < N ? (float)wr[1] : 0.f,
                        rk && gn + 2 < N ? (float)wr[2] : 0.f,
                        rk && gn + 3 < N ? (float)wr[3] : 0.f);
      }
      *reinterpret_cast<float4*>(&Bs[r][c]) = f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][tr * TM + i];
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tc * TN]);
      const float bb[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float s = read_scale(scale, scale_bf16);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + tr * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tc * TN + j;
      if (gn < N) y[(size_t)gm * N + gn] = from_f32<TY>(acc[i][j] * s);
    }
  }
}

// ---------------------------------------------------------------------------
// Split-K GEMV (M <= 16)

constexpr int SK_MAXM = 16;
constexpr int SK_WARPS = 8;              // warps per block
constexpr int SK_COLS = 128;             // columns per warp (4 per lane)

template <typename TX>
__global__ void __launch_bounds__(SK_WARPS * 32)
fxp_matmul_splitk(const TX* __restrict__ x, const int8_t* __restrict__ w,
                  float* __restrict__ ws, int M, int N, int K, int kc,
                  int vec4) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // blockIdx.x: column tile; blockIdx.y * SK_WARPS + warp: K chunk.
  const int kchunk = blockIdx.y * SK_WARPS + warp;
  const int k_begin = kchunk * kc;
  if (k_begin >= K) return;
  const int k_end = min(K, k_begin + kc);
  const int n = blockIdx.x * SK_COLS + lane * 4;
  if (n >= N) return;

  float acc[SK_MAXM][4];
#pragma unroll
  for (int m = 0; m < SK_MAXM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  const bool full4 = vec4 && (n + 4 <= N);
#pragma unroll 4
  for (int k = k_begin; k < k_end; ++k) {
    float wv[4];
    const int8_t* wr = w + (size_t)k * N + n;
    if (full4) {
      const char4 c = *reinterpret_cast<const char4*>(wr);
      wv[0] = (float)c.x; wv[1] = (float)c.y; wv[2] = (float)c.z; wv[3] = (float)c.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = (n + j < N) ? (float)wr[j] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < SK_MAXM; ++m) {
      if (m < M) {
        const float xv = to_f32(x[(size_t)m * K + k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < SK_MAXM; ++m) {
    if (m < M) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) atomicAdd(&ws[(size_t)m * N + n + j], acc[m][j]);
    }
  }
}

template <typename TY>
__global__ void fxp_matmul_finish(const float* __restrict__ ws,
                                  const void* __restrict__ scale, int scale_bf16,
                                  TY* __restrict__ y, long long total) {
  const float s = read_scale(scale, scale_bf16);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x)
    y[i] = from_f32<TY>(ws[i] * s);
}

template <typename TX, typename TY>
cudaError_t launch(const void* x, const int8_t* w, const void* scale,
                   int scale_bf16, void* y, float* ws, int M, int N, int K,
                   cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  TY* yp = static_cast<TY*>(y);
  const int vec4 = (N % 4 == 0) && ((uintptr_t)w % 4 == 0);
  if (M <= SK_MAXM) {
    const int col_tiles = (N + SK_COLS - 1) / SK_COLS;
    // K chunk: 32 rows of words per warp, doubled until the grid holds at
    // most ~8k warps (fewer atomics where N is large).
    int kc = 32;
    while (kc < K && (long long)col_tiles * ((K + kc - 1) / kc) > 8192) kc *= 2;
    const int chunks = K > 0 ? (K + kc - 1) / kc : 1;
    const dim3 grid(col_tiles, (chunks + SK_WARPS - 1) / SK_WARPS);
    cudaError_t err = cudaMemsetAsync(ws, 0, sizeof(float) * (size_t)M * N, stream);
    if (err != cudaSuccess) return err;
    fxp_matmul_splitk<TX><<<grid, SK_WARPS * 32, 0, stream>>>(xp, w, ws, M, N, K, kc, vec4);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long total = (long long)M * N;
    const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
    fxp_matmul_finish<TY><<<blocks, 256, 0, stream>>>(ws, scale, scale_bf16, yp, total);
    return cudaGetLastError();
  }
  if constexpr (std::is_same<TX, float>::value) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    fxp_matmul_tiled<TX, TY><<<grid, NT, 0, stream>>>(xp, w, scale, scale_bf16, yp, M, N, K,
                                                      vec4);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;   // bf16 x with M > 16 takes fxp_matmul_tc
  }
}

// ---------------------------------------------------------------------------
// Tensor cores (bf16 x, M > 16): tc_words.cuh's pipeline, the words MN-major

namespace tcfw {

// steps summed by wgmma before promotion, as fxp_qmatmul_tc: over K <= 8192
// the drift stays well inside check_fxp_matmul's bounds
// (tests/test_torch_tc_accumulation.py)
constexpr int PROMOTE = 32;
struct fxp_matmul_tc;                    // names the kernel

template <typename TO>
cudaError_t launch(const void* x, int ldx, const int8_t* w, const void* scale, int sb,
                   void* y, int M, int N, int K, cudaStream_t st) {
  return tc_words::launch<fxp_matmul_tc, true, PROMOTE, TO>(x, ldx, w, K, N, scale, sb, y, M,
                                                             N, K, st);
}

}  // namespace tcfw

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. `ws` is an (M, N) f32 workspace,
// used (and may be null) only when M <= 16. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for bf16 x with M > 16 (fxp_matmul_tc_launch's).
int fxp_matmul_launch(const void* x, int x_dtype, const void* w,
                      const void* scale, int scale_dtype, void* y, int y_dtype,
                      void* ws, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const int8_t* wp = static_cast<const int8_t*>(w);
  float* wsp = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sb = scale_dtype == 1;
  cudaError_t err;
  if (x_dtype == 1 && y_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, wp, scale, sb, y, wsp, M, N, K, st);
  else if (x_dtype == 1 && y_dtype == 0)
    err = launch<__nv_bfloat16, float>(x, wp, scale, sb, y, wsp, M, N, K, st);
  else if (x_dtype == 0 && y_dtype == 1)
    err = launch<float, __nv_bfloat16>(x, wp, scale, sb, y, wsp, M, N, K, st);
  else
    err = launch<float, float>(x, wp, scale, sb, y, wsp, M, N, K, st);
  return (int)err;
}

// The tensor-core branch of fxp_matmul: x (M, K) bf16 with rows of `ldx`
// elements (ldx >= K, a multiple of 8, x 16-byte aligned), y (M, N) f32 or
// bf16. Returns cudaGetLastError(), or cudaErrorInvalidValue for a layout
// it does not take or a tensor map that cuTensorMapEncodeTiled refuses.
int fxp_matmul_tc_launch(const void* x, int ldx, const void* w, const void* scale,
                         int scale_dtype, void* y, int y_dtype, int M, int N, int K,
                         void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (ldx < K || ldx % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int8_t* wp = static_cast<const int8_t*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sb = scale_dtype == 1;
  return (int)(y_dtype == 1
                   ? tcfw::launch<__nv_bfloat16>(x, ldx, wp, scale, sb, y, M, N, K, st)
                   : tcfw::launch<float>(x, ldx, wp, scale, sb, y, M, N, K, st));
}

}  // extern "C"

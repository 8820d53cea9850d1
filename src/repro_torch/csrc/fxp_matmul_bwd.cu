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
// Design, on f32 dy and for dw: a shared-memory-tiled SIMT GEMM, 128x128
// output tiles, the contraction in steps of 16, 256 threads each holding an
// 8x8 f32 accumulator (rows and columns in two groups of four, so the
// shared-memory reads are float4s that spread over the banks). Products
// are exact in f32 (an int8 word or a bf16 value times a bf16 value fits
// 16 significand bits); only the sums round.
//  * dx: each block owns a 128x128 tile of dx and loops over N itself. It
//    loads the dy tile and the (128 k x 16 n) tile of words, both
//    contiguous along n, so the transposed read of wq needs no transposed
//    copy; the words become f32 between the global load and the
//    shared-memory store, so no dequantized weight reaches device memory.
//  * dw: the TPU kernel carries its accumulator across the M grid; here
//    blocks run in any order, so each block owns a 128x128 tile of dw and
//    loops over all of M itself (no atomics, no second pass).
//
// dx on bf16 dy (the main path) runs on the tensor cores (matmul_dx_tc),
// the "TN" product of matmul_qdx_tc (fxp_qmatmul.cu) with the words read
// instead of drawn: dx[m][k] = sum_n dy[m][n] wq[k][n], both operands
// K-major. A CTA owns 256 rows and 64 columns of dx, with two consumer
// warpgroups on wgmma and two producer warpgroups that take the steps of
// 64 along n in turn. For its step a
// producer warpgroup's first thread loads the dy tile (128-byte swizzle)
// and, two of its steps ahead, the int8 word tile (no swizzle) into its
// staging ring, both by TMA; its threads convert the words to bf16 (exact)
// into the swizzled layout wgmma reads. The consumers restart their f32
// accumulators every 8 steps into round-to-nearest totals (wgmma's sums
// round toward zero, and the head's contraction is N = 128256) and scale
// by the device scalar in the epilogue. No cluster: nothing is drawn, so
// nothing is shared.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tc_gemm.cuh"

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


// ---------------------------------------------------------------------------
// dx = (dy @ wq^T) * scale on the tensor cores (bf16 dy)

namespace tcdx {

constexpr int BM = 256;                  // rows of dx per CTA
constexpr int BN = 64;                   // columns of dx (word rows) per CTA
constexpr int BK = 64;                   // contraction step along n
constexpr int STAGES = 5;                // dy / word ring
constexpr int AHEAD = 3;                 // int8 word staging ring of a producer
// steps summed by wgmma before promotion, as matmul_qdx_tc: at the head's
// N = 128256 the drift stays within check_matmul_bwd's f32 bound
// (tests/test_torch_tc_accumulation.py)
constexpr int PROMOTE = 8;
constexpr int CONSUMERS = 2;             // warpgroups of 128 rows
constexpr int PRODUCERS = 2;             // warpgroups taking turns by step
constexpr int THREADS = (CONSUMERS + PRODUCERS) * 128;
constexpr int PRODUCER_REGS = 88;        // setmaxnreg: 256 x 88 + 256 x 168
constexpr int CONSUMER_REGS = 168;       //   = the 512 x 128 the launch holds
constexpr int A_ELEMS = BM * BK;         // dy tile
constexpr int B_ELEMS = BN * BK;         // word tile as bf16
constexpr int W_BYTES = BN * BK;         // word tile as int8, staged
constexpr int PIECES = W_BYTES / 8 / 128;  // 8-word pieces a producer thread
constexpr size_t SMEM = 1024 + 2 * (size_t)STAGES * (A_ELEMS + B_ELEMS) +
                        (size_t)PRODUCERS * AHEAD * W_BYTES + 16 * STAGES +
                        16 * PRODUCERS * AHEAD;
static_assert(BK == tc_gemm::BK && BN == tc_gemm::COLS && BM == CONSUMERS * tc_gemm::ROWS,
              "the consumers' tiling");

// Eight int8 words as eight bf16 (exact), packed.
__device__ __forceinline__ uint4 words_bf16(uint2 u) {
  const char4 a = *reinterpret_cast<const char4*>(&u.x);
  const char4 b = *reinterpret_cast<const char4*>(&u.y);
  const float f[8] = {(float)a.x, (float)a.y, (float)a.z, (float)a.w,
                      (float)b.x, (float)b.y, (float)b.z, (float)b.w};
  uint32_t packed[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
    packed[e] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

template <typename TO>
__global__ void __launch_bounds__(THREADS, 1)
matmul_dx_tc(const __grid_constant__ CUtensorMap dymap,
             const __grid_constant__ CUtensorMap wmap, const int8_t* __restrict__ w,
             const void* __restrict__ scale, int scale_bf16, TO* __restrict__ dx, int M,
             int N, int K, int w_tma) {
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* Bs = As + STAGES * A_ELEMS;
  int8_t* Ws = reinterpret_cast<int8_t*>(Bs + STAGES * B_ELEMS);  // word staging
  uint64_t* full = reinterpret_cast<uint64_t*>(Ws + PRODUCERS * AHEAD * W_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* wfull = empty + STAGES;               // per producer warpgroup
  uint64_t* wempty = wfull + PRODUCERS * AHEAD;

  const int m0 = blockIdx.x * BM, k0 = blockIdx.y * BN;
  const int n_steps = (N + BK - 1) / BK;
  const int tid = threadIdx.x, t = tid % 128;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1 + 128);         // a producer warpgroup, dy's bytes
      sm90::mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < PRODUCERS * AHEAD; ++s) {
      sm90::mbar_init(&wfull[s], 1);              // the word tile's TMA
      sm90::mbar_init(&wempty[s], 128);           // the converters
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg >= CONSUMERS) {
    sm90::regs_dec<PRODUCER_REGS>();
    // The two producer warpgroups take the steps in turn (warpgroup pw the
    // steps j = 2 i + pw), so two steps' loads and conversions are in
    // flight. A warpgroup's first thread loads the int8 word tile of its
    // steps (BN rows of wq along k, 64 along n) by TMA into the warpgroup's
    // staging ring, AHEAD - 1 of its steps ahead, and the dy tile of each
    // step. Each thread converts PIECES 8-word pieces to bf16 (exact) and
    // stores them in the K-major swizzled layout (row r at r * 128 bytes,
    // piece c ^ (r % 8)). Words whose rows TMA cannot address (N % 16 != 0)
    // are read directly.
    const int pw = wg - CONSUMERS;
    int8_t* Wp = Ws + pw * AHEAD * W_BYTES;
    uint64_t* wf = wfull + pw * AHEAD;
    uint64_t* we = wempty + pw * AHEAD;
    const int n_mine = (n_steps - pw + PRODUCERS - 1) / PRODUCERS;
    auto stage_words = [&](int i) {
      sm90::mbar_arrive_expect_tx(&wf[i % AHEAD], W_BYTES);
      sm90::tma_load_2d(Wp + (i % AHEAD) * W_BYTES, &wmap, &wf[i % AHEAD],
                        (PRODUCERS * i + pw) * BK, k0);
    };
    if (w_tma && t == 0)
      for (int i = 0; i < AHEAD - 1 && i < n_mine; ++i) stage_words(i);
    for (int i = 0; i < n_mine; ++i) {
      const int j = PRODUCERS * i + pw;
      const int s = j % STAGES, slot = i % AHEAD, n0 = j * BK;
      uint4 pieces[PIECES];
      if (w_tma) {
        const int ahead = i + AHEAD - 1;
        if (t == 0 && ahead < n_mine) {
          sm90::mbar_wait(&we[ahead % AHEAD], ((ahead / AHEAD) & 1) ^ 1);
          stage_words(ahead);
        }
        sm90::mbar_wait(&wf[slot], (i / AHEAD) & 1);
#pragma unroll
        for (int q = 0; q < PIECES; ++q) {
          const int p = t + 128 * q;               // row p / 8, piece p % 8
          pieces[q] = words_bf16(
              *reinterpret_cast<const uint2*>(Wp + slot * W_BYTES + p * 8));
        }
        sm90::mbar_arrive(&we[slot]);
      } else {
#pragma unroll
        for (int q = 0; q < PIECES; ++q) {
          const int p = t + 128 * q, k = k0 + p / 8, n = n0 + 8 * (p % 8);
          const int live = k < K ? N - n : 0;
          alignas(8) int8_t b[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) b[e] = e < live ? w[(size_t)k * N + n + e] : 0;
          pieces[q] = words_bf16(*reinterpret_cast<const uint2*>(b));
        }
      }
      sm90::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      if (t == 0) {
        sm90::mbar_arrive_expect_tx(&full[s], 2 * A_ELEMS);
        sm90::tma_load_2d(As + s * A_ELEMS, &dymap, &full[s], n0, m0);
      }
      __nv_bfloat16* Bt = Bs + s * B_ELEMS;
#pragma unroll
      for (int q = 0; q < PIECES; ++q) {
        const int p = t + 128 * q, r = p / 8, c = p % 8;
        *reinterpret_cast<uint4*>(Bt + r * BK + ((c ^ (r & 7)) * 8)) = pieces[q];
      }
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&full[s]);
    }
  } else {
    sm90::regs_inc<CONSUMER_REGS>();
    // A consumer warpgroup: rows m0 + 128 wg .. of dx (tc_gemm.cuh).
    float tot[2][tc_gemm::ACC];
    const int lane = t % 32;
    tc_gemm::consume<false, STAGES, PROMOTE>(
        tot, As + wg * 128 * BK, A_ELEMS, Bs, B_ELEMS, n_steps,
        [&](int s, uint32_t parity) { sm90::mbar_wait(&full[s], parity); },
        [&](int s) {
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(&empty[s]);
        });
    tc_gemm::store_tile(tot, read_scale(scale, scale_bf16), dx, M, K, m0 + wg * 128, k0, t);
  }
}

template <typename TO>
cudaError_t launch(const void* dy, int ldy, const int8_t* w, const void* scale, int sb,
                   void* dx, int M, int N, int K, cudaStream_t st) {
  if (N <= 0)
    return cudaMemsetAsync(dx, 0, (size_t)M * K * sizeof(TO), st);
  // dy (M, N) with rows of ldy elements: boxes of 64 n x BM rows
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)ldy * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {BK, BM};
  CUtensorMap map, wmap = {};
  if (!sm90::bf16_map(&map, dy, 2, dims, strides, box)) return cudaErrorInvalidValue;
  // the int8 words (K, N): boxes of 64 n x BN rows, when rows are 16-byte
  // aligned
  const int w_tma = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (w_tma) {
    const cuuint64_t wdims[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t wstrides[1] = {(cuuint64_t)N};
    const cuuint32_t wbox[2] = {BK, BN};
    if (!sm90::int8_map(&wmap, w, 2, wdims, wstrides, wbox)) return cudaErrorInvalidValue;
  }
  const cudaError_t err = sm90::allow_smem<matmul_dx_tc<TO>>(SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (K + BN - 1) / BN);
  matmul_dx_tc<TO><<<grid, THREADS, SMEM, st>>>(
      map, wmap, w, scale, sb, static_cast<TO*>(dx), M, N, K, w_tma);
  return cudaGetLastError();
}

}  // namespace tcdx

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

// The tensor-core branch of matmul_dx: dy (M, N) bf16 with rows of `ldy`
// elements (ldy >= N, a multiple of 8, dy 16-byte aligned), dx (M, K) f32
// or bf16. Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// layout it does not take or a tensor map that cuTensorMapEncodeTiled
// refuses.
int matmul_dx_tc_launch(const void* dy, int ldy, const void* w, const void* scale,
                        int scale_dtype, void* dx, int dx_dtype, int M, int N, int K,
                        void* stream) {
  if (M <= 0 || K <= 0) return (int)cudaGetLastError();
  if (ldy < N || ldy % 8 != 0 || reinterpret_cast<uintptr_t>(dy) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int8_t* wp = static_cast<const int8_t*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sb = scale_dtype == 1;
  return (int)(dx_dtype == 1
                   ? tcdx::launch<__nv_bfloat16>(dy, ldy, wp, scale, sb, dx, M, N, K, st)
                   : tcdx::launch<float>(dy, ldy, wp, scale, sb, dx, M, N, K, st));
}

}  // extern "C"

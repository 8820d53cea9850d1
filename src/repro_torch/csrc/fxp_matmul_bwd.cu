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
// Design, on f32 inputs: a shared-memory-tiled SIMT GEMM, 128x128 output
// tiles, the contraction in steps of 16, 256 threads each holding an 8x8
// f32 accumulator (rows and columns in two groups of four, so the
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
// On bf16 inputs (the main path) both run on the tensor cores:
//  * matmul_dx_tc: tc_words.cuh's pipeline, the "TN" product of
//    matmul_qdx_tc (fxp_qmatmul.cu) with the words read instead of drawn:
//    dx[m][k] = sum_n dy[m][n] wq[k][n], both operands K-major. A CTA owns
//    256 rows and 64 columns of dx; two producer warpgroups take the steps
//    of 64 along n in turn, load dy and the int8 words by TMA and convert
//    the words to bf16 for two consumer warpgroups on wgmma. The
//    accumulators restart every 8 steps (the head's contraction is
//    N = 128256).
//  * matmul_dw_tc replaces a SIMT kernel that ran at 17x torch.matmul's
//    time (PERF.md section 6). dw = x^T @ dy contracts over the rows of
//    both operands, so both are MN-major for wgmma (both transpose bits
//    set) and arrive by TMA exactly as they lie in memory: nothing is
//    converted, and one producer thread keeps a 5-stage ring full while
//    three consumer warpgroups only issue products. A CTA owns 192 rows
//    (k) and 128 columns (n) of dw, a warpgroup 64 x 128 as m64n128
//    products (the registers split 160 / 32 by setmaxnreg). What bounds
//    it: the bf16 operations (the head's 1.63 ms at 989 TFLOP/s) against
//    the output (its f32 dw is 1.58 GB, 0.47 ms of HBM time), and a
//    short contraction (M = 2048 is 32 steps), so the ring's fill and the
//    epilogue are a large share of a tile's life. Against the first
//    design (256 x 64 tiles, two warpgroups of 128 x 64) the wider tile
//    reads 1.5x less from L2 and shared memory per operation and took
//    ~2x torch.matmul's time down to ~1.3x; the grid is ordered so that
//    the CTAs in flight share few x and dy panels (at K = 8192 a k-fastest
//    order re-read x from device memory). Rows of x or dy past M read as
//    zeros (TMA's fill), so an M tail adds exact zeros; the accumulators
//    restart every 16 steps, which holds the drift at M = 131072 too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tc_gemm.cuh"
#include "tc_words.cuh"

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
// dx = (dy @ wq^T) * scale on the tensor cores (bf16 dy): tc_words.cuh's
// pipeline with both operands K-major

namespace tcdx {

// steps summed by wgmma before promotion: at the head's N = 128256 the
// drift stays within check_matmul_bwd's f32 bound
// (tests/test_torch_tc_accumulation.py)
constexpr int PROMOTE = 8;
struct matmul_dx_tc;                    // names the kernel

template <typename TO>
cudaError_t launch(const void* dy, int ldy, const int8_t* w, const void* scale, int sb,
                   void* dx, int M, int N, int K, cudaStream_t st) {
  return tc_words::launch<matmul_dx_tc, false, PROMOTE, TO>(dy, ldy, w, K, N, scale, sb, dx,
                                                            M, K, N, st);
}

}  // namespace tcdx

// ---------------------------------------------------------------------------
// dw = x^T @ dy on the tensor cores (bf16 x and dy)

namespace tcdw {

// A CTA owns BM rows (along k) and BN columns (along n) of dw; each of its
// WGS consumer warpgroups 64 rows as one m64n128 product a step. Both
// operands arrive as they lie in memory, rows along the contraction m:
// A = x^T is MN-major, BM / 64 boxes of 64 k x 64 m a stage; B = dy is
// MN-major, BN / 64 boxes of 64 n x 64 m. Nothing is converted, so one
// producer thread keeps the ring full by TMA and the consumers only issue
// wgmma.
constexpr int WGS = 3;                   // consumer warpgroups
constexpr int BN = 128;                  // columns of dw per CTA
constexpr int BM = WGS * 64;             // rows of dw per CTA
constexpr int BK = 64;                   // contraction step along m
constexpr int STAGES = 5;                // x / dy ring
constexpr int GROUP = 16;                // row blocks of a group in the grid's order
// steps summed by wgmma before promotion: at M = 2048 and at the
// registry's microbatch of 32 x 4096 = 131072 rows the drift stays under a
// tenth of check_matmul_bwd's f32 bound (tests/test_torch_tc_accumulation.py)
constexpr int PROMOTE = 16;
constexpr int THREADS = (WGS + 1) * 128;  // and a producer warpgroup
// setmaxnreg: the producer thread needs few registers; a consumer holds
// 64 + 64 f32 accumulators (wgmma's and the promoted totals)
constexpr int PRODUCER_REGS = 32;        // 128 x 32 + 384 x 160
constexpr int CONSUMER_REGS = 160;       //   = the 512 x 128 the launch holds
static_assert(128 * (PRODUCER_REGS + WGS * CONSUMER_REGS) ==
                  THREADS * (65536 / THREADS / 8 * 8),
              "the split adds up to the registers the launch holds");
constexpr int CHUNK = 64 * BK;           // one 64-wide chunk of a tile
constexpr int A_ELEMS = BM * BK;         // x tile
constexpr int B_ELEMS = BN * BK;         // dy tile
constexpr size_t SMEM = 1024 + 2 * (size_t)STAGES * (A_ELEMS + B_ELEMS) + 16 * STAGES;
static_assert(BK == tc_gemm::BK && BN == 2 * tc_gemm::COLS, "the consumers' m64n128 products");

template <typename TO>
__global__ void __launch_bounds__(THREADS, 1)
matmul_dw_tc(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap dymap, TO* __restrict__ dw, int M, int K,
             int N) {
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* As = sm90::align1024<__nv_bfloat16>(smem_raw);
  __nv_bfloat16* Bs = As + STAGES * A_ELEMS;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * B_ELEMS);
  uint64_t* empty = full + STAGES;

  // The grid's order: row blocks (along k) fastest within groups of
  // GROUP, column blocks next, then the groups. So the CTAs in flight
  // share a few dy panels and at most GROUP x panels, each read from
  // device memory about once and from L2 by the rest, whatever K and N
  // (K = 3072 is one group; at K = 8192 a k-fastest order took 14% longer).
  const int row_blocks = (K + BM - 1) / BM, col_blocks = (N + BN - 1) / BN;
  const int per_group = GROUP * col_blocks, first = (blockIdx.x / per_group) * GROUP;
  const int in_group = min(row_blocks - first, GROUP), b = blockIdx.x % per_group;
  const int k0 = (first + b % in_group) * BM, n0 = (b / in_group) * BN;
  const int n_steps = (M + BK - 1) / BK;
  const int tid = threadIdx.x, t = tid % 128;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);               // the producer, the TMA bytes
      sm90::mbar_init(&empty[s], WGS * 4);        // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == WGS) {
    sm90::regs_dec<PRODUCER_REGS>();
    // The producer thread: per step of 64 rows of x and dy, the chunks that
    // hold a row or a column of dw (a chunk wholly past K or N is not
    // loaded: what it would feed is never stored). Rows past M read as
    // zeros.
    if (t == 0) {
      const int a_chunks = min(BM / 64, (K - k0 + 63) / 64);
      const int b_chunks = min(BN / 64, (N - n0 + 63) / 64);
      const uint32_t bytes = 2 * (a_chunks + b_chunks) * CHUNK;
      for (int j = 0; j < n_steps; ++j) {
        const int s = j % STAGES;
        sm90::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], bytes);
        for (int c = 0; c < a_chunks; ++c)
          sm90::tma_load_2d(As + s * A_ELEMS + c * CHUNK, &xmap, &full[s], k0 + 64 * c,
                            j * BK);
        for (int c = 0; c < b_chunks; ++c)
          sm90::tma_load_2d(Bs + s * B_ELEMS + c * CHUNK, &dymap, &full[s], n0 + 64 * c,
                            j * BK);
      }
    }
  } else {
    sm90::regs_inc<CONSUMER_REGS>();
    // A consumer warpgroup: rows k0 + 64 wg .. of dw, A and B MN-major.
    float tot[1][BN / 2];
    const int lane = t % 32;
    tc_gemm::consume<true, true, STAGES, PROMOTE>(
        tot, As + wg * CHUNK, A_ELEMS, Bs, B_ELEMS, n_steps,
        [&](int s, uint32_t parity) { sm90::mbar_wait(&full[s], parity); },
        [&](int s) {
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(&empty[s]);
        });
    tc_gemm::store_tile(tot, 1.f, dw, K, N, k0 + wg * 64, n0, t);
  }
}

template <typename TO>
cudaError_t launch(const void* x, int ldx, const void* dy, int ldy, void* dw, int M, int K,
                   int N, cudaStream_t st) {
  if (M <= 0)
    return cudaMemsetAsync(dw, 0, (size_t)K * N * sizeof(TO), st);
  // x (M, K) and dy (M, N), rows of ldx / ldy elements: boxes of 64
  // columns x 64 rows
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xstrides[1] = {(cuuint64_t)ldx * sizeof(__nv_bfloat16)};
  const cuuint64_t ddims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t dstrides[1] = {(cuuint64_t)ldy * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, BK};
  CUtensorMap xmap, dymap;
  if (!sm90::bf16_map(&xmap, x, 2, xdims, xstrides, box) ||
      !sm90::bf16_map(&dymap, dy, 2, ddims, dstrides, box))
    return cudaErrorInvalidValue;
  const cudaError_t err = sm90::allow_smem<matmul_dw_tc<TO>>(SMEM);
  if (err != cudaSuccess) return err;
  const int blocks = ((K + BM - 1) / BM) * ((N + BN - 1) / BN);
  matmul_dw_tc<TO><<<blocks, THREADS, SMEM, st>>>(xmap, dymap, static_cast<TO*>(dw), M, K,
                                                N);
  return cudaGetLastError();
}

}  // namespace tcdw

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError().

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

// dw (K, N) = x (M, K)^T @ dy (M, N), x and dy f32 (bf16 operands take
// matmul_dw_tc_launch).
int matmul_dw_launch(const void* x, const void* dy, void* dw, int dw_dtype, int M, int K,
                     int N, void* stream) {
  if (K <= 0 || N <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dw_dtype == 1 ? launch_dw<float, __nv_bfloat16>(x, dy, dw, M, K, N, st)
                             : launch_dw<float, float>(x, dy, dw, M, K, N, st));
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

// The tensor-core branch of matmul_dw: x (M, K) and dy (M, N) bf16 with
// rows of `ldx` / `ldy` elements (ldx >= K and ldy >= N, multiples of 8,
// both 16-byte aligned), dw (K, N) f32 or bf16 (rounded to nearest even);
// M = 0 writes zeros. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a layout it does not take or a tensor map that cuTensorMapEncodeTiled
// refuses.
int matmul_dw_tc_launch(const void* x, int ldx, const void* dy, int ldy, void* dw,
                        int dw_dtype, int M, int K, int N, void* stream) {
  if (K <= 0 || N <= 0) return (int)cudaGetLastError();
  if (ldx < K || ldx % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 || ldy < N ||
      ldy % 8 != 0 || reinterpret_cast<uintptr_t>(dy) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dw_dtype == 1
                   ? tcdw::launch<__nv_bfloat16>(x, ldx, dy, ldy, dw, M, K, N, st)
                   : tcdw::launch<float>(x, ldx, dy, ldy, dw, M, K, N, st));
}

}  // extern "C"

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
// On f32 x / dy both take the SIMT tiling of fxp_matmul_bwd.cu: 128x128
// output tiles, the contraction in steps of 16, 256 threads each holding
// an 8x8 f32 accumulator. Each block quantizes
// the 16 x 128 master tile it needs (2048 hashes per step against 262144
// multiply-adds), so the master is re-read, and its words redrawn, once
// per 128-row block of the output.
//  * qmatmul: the x tile is read along k and transposed into shared memory;
//    the master tile is read along n, 8 elements a thread.
//  * qdx (f32 dy): each block owns a 128x128 tile of dx and loops over N;
//    the dy tile and the (128 k x 16 n) master tile are both read along n
//    and transposed into shared memory, so the transposed read of w needs
//    no transposed copy.
//
// matmul_qdx on bf16 dy (the main path) runs on the tensor cores
// (matmul_qdx_tc): dx[m][k] = sum_n dy[m][n] Q(w)[k][n], both operands
// K-major for wgmma (dy rows and master rows are contiguous along n), the
// plain "TN" product. A cluster of two CTAs owns 512 rows of dx and 64 of
// its columns. Each CTA has two consumer warpgroups of 128 rows (two
// m64n64k16 products per 16-wide step) and two producer warpgroups, with
// the registers split 168 / 88 by setmaxnreg. Per step of 64 along n, the
// first producer thread loads the CTA's 256 x 64 dy tile by TMA (128-byte
// swizzle) and, two steps ahead, its half (32 rows) of the f32 master
// tile by TMA into a staging ring. Each producer thread draws 8 words of
// that half exactly as Quant does (the same index k * N + n, so the words
// are bit-identical to the SIMT branch's) and stores them as bf16 in the
// swizzled layout wgmma reads; one thread then copies the 4 KB half into
// the peer's tile with a bulk copy that completes on the peer's full
// barrier. So each word is drawn once per 512 rows of M, and no word
// leaves the SM pair. A 5-stage ring of dy and word tiles lets the
// drawing of later steps overlap the products of earlier ones. Int8 words
// and bf16 dy values are exact in bf16, so every product is exact. wgmma's
// f32 accumulation rounds toward zero, so every 8 steps (512 along n) the
// accumulators restart and their sum is added into a register total with
// round-to-nearest (at N = 128256 the drift would otherwise pass the
// tolerance). The 2^-fl scale is applied once in the epilogue. The pairs
// that share a word tile are adjacent in the grid, so the master is read
// from device memory about once and from L2 by the rest. dy rows must be
// 16-byte aligned for TMA (the wrapper pads a row length that is not a
// multiple of 8); a master whose rows are not (N % 4 != 0) is read by the
// producer threads directly.
//
// fxp_qmatmul on bf16 x (the main path of the prologue) runs on the tensor
// cores too (fxp_qmatmul_tc), on the same skeleton with the operands
// swapped: y[m][n] = sum_k x[m][k] Q(w)[k][n], A = x K-major by TMA, B =
// the word tile MN-major (the master's rows run along n, so the drawn
// words are stored n-contiguous and wgmma reads them with the transpose
// bit). A cluster of two CTAs owns 512 rows of y and 64 of its columns;
// per step of 64 along k each CTA draws 32 rows of the 64 x 64 word tile
// from its TMA-staged master half and sends them to the peer by one bulk
// copy, so each word is drawn once per 512 rows (4 times at M = 2048; the
// SIMT kernel draws it once per 128). The contraction is at most d_ff =
// 8192 here, so the accumulators are promoted every 32 steps (2048 along
// k) rather than 8. Both kernels' consumer warpgroups are tc_gemm.cuh's.
//
// Measured on an H100 (PERF.md): matmul_qdx_tc and fxp_qmatmul_tc take
// 2.8-3.8x cuBLAS, ~1.1 us per 64-wide step. matmul_dx_tc
// (fxp_matmul_bwd.cu), the same pipeline with nothing drawn and no
// cluster, takes ~0.55 us a step with two producer warpgroups taking the
// steps in turn: the producers' chain of waits, not the products, sets
// the step. Two producer warpgroups in turn did not help fxp_qmatmul_tc,
// whose step waits on its cluster peer as well; nor did a 4-CTA cluster
// of 128 x 128 tiles (about twice as long).

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


// ---------------------------------------------------------------------------
// dx = (dy @ Q(w)^T) * 2^-fl on the tensor cores (bf16 dy)

namespace tcq {

constexpr int BM = 256;                  // rows of dx per CTA; a pair: 512
constexpr int BN = 64;                   // columns of dx (master rows) per CTA
constexpr int BK = 64;                   // contraction step along n
constexpr int STAGES = 5;                // dy / word ring
constexpr int AHEAD = 3;                 // master staging ring
constexpr int PROMOTE = 8;               // steps summed by wgmma before promotion
constexpr int CONSUMERS = 2;             // warpgroups of 128 rows
constexpr int PRODUCERS = 2;             // warpgroups drawing words
constexpr int THREADS = (CONSUMERS + PRODUCERS) * 128;
constexpr int A_ELEMS = BM * BK;         // dy tile
constexpr int B_ELEMS = BN * BK;         // word tile (both halves)
constexpr int HALF = BN / 2;             // word rows this CTA draws
constexpr int W_ELEMS = HALF * BK;       // master tile this CTA stages per step
constexpr int PRODUCER_REGS = 88;        // setmaxnreg: 256 x 88 + 256 x 168
constexpr int CONSUMER_REGS = 168;       //   = the 512 x 128 the launch holds
static_assert(W_ELEMS == PRODUCERS * 128 * 8, "one 8-word piece per producer thread");
static_assert(BK == tc_gemm::BK && BN == tc_gemm::COLS && BM == CONSUMERS * tc_gemm::ROWS,
              "the consumers' tiling");
constexpr size_t SMEM = 1024 + 2 * (size_t)STAGES * (A_ELEMS + B_ELEMS) +
                        4 * (size_t)AHEAD * W_ELEMS + 16 * STAGES + 16 * AHEAD;

template <typename TO>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
matmul_qdx_tc(const __grid_constant__ CUtensorMap dymap,
              const __grid_constant__ CUtensorMap wmap, const float* __restrict__ w,
              const int* __restrict__ fl, uint32_t seed_mix, int mode,
              TO* __restrict__ dx, int M, int N, int K, int w_tma) {
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* Bs = As + STAGES * A_ELEMS;
  float* Ws = reinterpret_cast<float*>(Bs + STAGES * B_ELEMS);  // master staging
  uint64_t* full = reinterpret_cast<uint64_t*>(Ws + AHEAD * W_ELEMS);
  uint64_t* empty = full + STAGES;
  uint64_t* wfull = empty + STAGES;         // master staging ring
  uint64_t* wempty = wfull + AHEAD;

  // The two CTAs of a cluster own rows m0 .. m0 + 511 between them and
  // share the word tile of columns k0 .. k0 + 63, each drawing half of it;
  // the pairs of one column block are adjacent in the grid.
  const uint32_t rank = sm90::cluster_rank(), peer = rank ^ 1;
  const int m0 = blockIdx.x * BM, k0 = blockIdx.y * BN;
  const int n_steps = (N + BK - 1) / BK;
  // the warpgroup index through a shuffle, so the compiler sees that it is
  // warp-uniform (else it serialises the wgmma of a divergent-looking path)
  const int tid = threadIdx.x, t = tid % 128;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // this CTA's producers and the TMA bytes (dy, and the peer's half of
      // the words, which its bulk copy completes here)
      sm90::mbar_init(&full[s], 1 + PRODUCERS * 128);
      // one arrival per consumer warp of both CTAs
      sm90::mbar_init(&empty[s], 2 * CONSUMERS * 4);
    }
    for (int s = 0; s < AHEAD; ++s) {
      sm90::mbar_init(&wfull[s], 1);                 // the master tile's TMA
      sm90::mbar_init(&wempty[s], PRODUCERS * 128);  // the drawers
    }
    sm90::fence_barrier_init();
  }
  sm90::cluster_sync();     // both CTAs' barriers exist before any peer arrives

  // The two roles never reconverge (each ends in its own cluster sync), so
  // the compiler applies the register split.
  if (wg >= CONSUMERS) {
    sm90::regs_dec<PRODUCER_REGS>();
    // The producer warpgroups. Thread pt owns one 8-word piece of this
    // CTA's half of the word tile: row r, columns 8c .. 8c + 7 of each
    // step. The first producer thread loads this CTA's half of the master
    // by TMA into a staging ring, AHEAD - 1 steps ahead (TMA's copies do
    // not hold up the barrier arrivals' release, which copies of the
    // thread's own would), and this CTA's dy tile. Each thread reads its
    // master piece, draws the words as Quant does and stores them into
    // this CTA's word tile; once all of the half is stored, one thread
    // copies it into the peer's tile (a bulk copy that completes on the
    // peer's full barrier), so no thread waits on a remote store. A master
    // whose rows TMA cannot address (N % 4 != 0) is read directly.
    const int pt = tid - CONSUMERS * 128;
    const int r = HALF * rank + (pt >> 3), c = pt & 7, k = k0 + r;
    const int kr = k0 + HALF * rank;          // the master rows of this CTA
    auto stage_master = [&](int j) {          // into slot j % AHEAD
      sm90::mbar_arrive_expect_tx(&wfull[j % AHEAD], 4 * W_ELEMS);
      sm90::tma_load_2d(Ws + (j % AHEAD) * W_ELEMS, &wmap, &wfull[j % AHEAD], j * BK, kr);
    };
    if (w_tma && pt == 0)
      for (int j = 0; j < AHEAD - 1 && j < n_steps; ++j) stage_master(j);
    const Quant quant{pow2i(*fl), seed_mix, mode};
    for (int j = 0; j < n_steps; ++j) {
      const int s = j % STAGES, n0 = j * BK, slot = j % AHEAD;
      float v[8];
      if (w_tma) {
        const int ahead = j + AHEAD - 1;      // its slot was read at step j - 1
        if (pt == 0 && ahead < n_steps) {
          sm90::mbar_wait(&wempty[ahead % AHEAD], ((ahead / AHEAD) & 1) ^ 1);
          stage_master(ahead);
        }
        sm90::mbar_wait(&wfull[slot], (j / AHEAD) & 1);
        const float4* src = reinterpret_cast<const float4*>(Ws + slot * W_ELEMS + pt * 8);
        const float4 lo = src[0], hi = src[1];
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
        sm90::fence_proxy_async();   // these reads before the slot's refill by TMA
        sm90::mbar_arrive(&wempty[slot]);
      } else {
        load8(w + (size_t)k * N + n0 + 8 * c, k < K ? N - n0 - 8 * c : 0, false, v);
      }
      const int n = n0 + 8 * c;
      const int live = k < K ? N - n : 0;
      const uint32_t idx = (uint32_t)k * (uint32_t)N + (uint32_t)n;
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const float a = e < live ? quant(v[e], idx + (uint32_t)e) : 0.f;
        const float b = e + 1 < live ? quant(v[e + 1], idx + (uint32_t)e + 1) : 0.f;
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
        packed[e / 2] = *reinterpret_cast<const uint32_t*>(&h);
      }
      const uint4 v4 = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      // stage s is free in both CTAs
      sm90::mbar_wait_cluster(&empty[s], ((j / STAGES) & 1) ^ 1);
      if (pt == 0) {
        // this CTA's dy tile and the peer's word half complete here
        sm90::mbar_arrive_expect_tx(&full[s], 2 * (A_ELEMS + W_ELEMS));
        sm90::tma_load_2d(As + s * A_ELEMS, &dymap, &full[s], n0, m0);
      }
      __nv_bfloat16* Bt = Bs + s * B_ELEMS;
      *reinterpret_cast<uint4*>(Bt + r * BK + ((c ^ (r & 7)) * 8)) = v4;
      sm90::fence_proxy_async();
      sm90::named_sync(1, PRODUCERS * 128);   // this CTA's half is stored
      if (pt == 0) {
        const __nv_bfloat16* half = Bt + HALF * rank * BK;
        sm90::bulk_copy_to_peer(sm90::peer_addr(half, peer), half, 2 * W_ELEMS,
                                sm90::peer_addr(&full[s], peer));
      }
      sm90::mbar_arrive(&full[s]);
    }
    // no CTA leaves while its peer may still copy into it or arrive on it
    sm90::cluster_sync();
  } else {
    sm90::regs_inc<CONSUMER_REGS>();
    // A consumer warpgroup: rows m0 + 128 wg .. of dx (tc_gemm.cuh). wgmma's
    // f32 accumulation rounds toward zero, which over a long contraction
    // (the LM head's N = 128256) drifts past the tolerance, so the
    // accumulators are promoted every PROMOTE steps. A stage is released
    // to the producers of both CTAs.
    float tot[2][tc_gemm::ACC];
    const int lane = t % 32;
    tc_gemm::consume<false, false, STAGES, PROMOTE>(
        tot, As + wg * 128 * BK, A_ELEMS, Bs, B_ELEMS, n_steps,
        [&](int s, uint32_t parity) { sm90::mbar_wait_cluster(&full[s], parity); },
        [&](int s) {
          __syncwarp();
          if (lane == 0) {                  // stage s is read in this warp
            sm90::mbar_arrive(&empty[s]);
            sm90::mbar_arrive_cluster(sm90::peer_addr(&empty[s], peer));
          }
        });
    tc_gemm::store_tile(tot, pow2i(-*fl), dx, M, K, m0 + wg * 128, k0, t);
    sm90::cluster_sync();
  }
}

template <typename TO>
cudaError_t launch(const void* dy, int ldy, const float* w, const int* fl, int seed,
                   int mode, void* dx, int M, int N, int K, cudaStream_t st) {
  if (N <= 0)
    return cudaMemsetAsync(dx, 0, (size_t)M * K * sizeof(TO), st);
  // dy (M, N) with rows of ldy elements; boxes of 64 n x 256 rows.
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)ldy * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {BK, BM};
  CUtensorMap map, wmap = {};
  if (!sm90::bf16_map(&map, dy, 2, dims, strides, box)) return cudaErrorInvalidValue;
  // the f32 master (K, N): boxes of 64 n x 32 rows, when its rows are
  // 16-byte aligned
  const int w_tma = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (w_tma) {
    const cuuint64_t wdims[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t wstrides[1] = {(cuuint64_t)N * sizeof(float)};
    const cuuint32_t wbox[2] = {BK, HALF};
    if (!sm90::f32_map(&wmap, w, 2, wdims, wstrides, wbox)) return cudaErrorInvalidValue;
  }
  const cudaError_t err = sm90::allow_smem<matmul_qdx_tc<TO>>(SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(2 * ((M + 2 * BM - 1) / (2 * BM)), (K + BN - 1) / BN);
  matmul_qdx_tc<TO><<<grid, THREADS, SMEM, st>>>(
      map, wmap, w, fl, (uint32_t)seed * 0x9E3779B9u, mode, static_cast<TO*>(dx), M, N, K,
      w_tma);
  return cudaGetLastError();
}

}  // namespace tcq

// ---------------------------------------------------------------------------
// y = (x @ Q(w)) * 2^-fl on the tensor cores (bf16 x)

namespace tcf {

// A cluster of two CTAs owns 512 rows of y and 64 of its columns; each CTA
// has 256 rows, and a consumer warpgroup 128 as two m64n64 products. Per
// step of 64 along k the pair shares one 64 x 64 word tile, of which each
// CTA draws 32 rows (2048 words, eight a producer thread).
constexpr int BM = 256;                  // rows of y per CTA; a pair: 512
constexpr int BN = 64;                   // columns of y per CTA
constexpr int BK = 64;                   // contraction step along k
constexpr int STAGES = 5;                // x / word ring
constexpr int AHEAD = 3;                 // master staging ring
// steps summed by wgmma before promotion: over K <= 8192 the drift stays
// well inside check_qmatmul's bounds at this interval
// (tests/test_torch_tc_accumulation.py)
constexpr int PROMOTE = 32;
constexpr int CONSUMERS = 2;             // warpgroups of 128 rows
constexpr int PRODUCERS = 2;             // warpgroups drawing words
constexpr int THREADS = (CONSUMERS + PRODUCERS) * 128;
constexpr int HALF = BK / 2;             // word rows this CTA draws
constexpr int A_ELEMS = BM * BK;         // x tile
constexpr int B_ELEMS = BK * BN;         // word tile (both halves)
constexpr int W_ELEMS = HALF * BN;       // master tile this CTA stages per step
constexpr int PRODUCER_REGS = 88;        // setmaxnreg: 256 x 88 + 256 x 168
constexpr int CONSUMER_REGS = 168;       //   = the 512 x 128 the launch holds
static_assert(W_ELEMS == PRODUCERS * 128 * 8, "one 8-word piece per producer thread");
static_assert(BK == tc_gemm::BK && BN == tc_gemm::COLS && BM == CONSUMERS * tc_gemm::ROWS,
              "the consumers' tiling");
constexpr size_t SMEM = 1024 + 2 * (size_t)STAGES * (A_ELEMS + B_ELEMS) +
                        4 * (size_t)AHEAD * W_ELEMS + 16 * STAGES + 16 * AHEAD;

template <typename TO>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
fxp_qmatmul_tc(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap, const float* __restrict__ w,
               const int* __restrict__ fl, uint32_t seed_mix, int mode,
               TO* __restrict__ y, int M, int N, int K, int w_tma) {
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* Bs = As + STAGES * A_ELEMS;
  float* Ws = reinterpret_cast<float*>(Bs + STAGES * B_ELEMS);  // master staging
  uint64_t* full = reinterpret_cast<uint64_t*>(Ws + AHEAD * W_ELEMS);
  uint64_t* empty = full + STAGES;
  uint64_t* wfull = empty + STAGES;
  uint64_t* wempty = wfull + AHEAD;

  // The two CTAs of a cluster own rows m0 .. m0 + 511 between them and
  // share the word tile of columns n0 .. n0 + 63; CTA `rank` draws rows
  // HALF * rank .. of each 64-row step. The pairs of one column block are
  // adjacent in the grid, so the master is read from device memory about
  // once and from L2 by the rest.
  const uint32_t rank = sm90::cluster_rank(), peer = rank ^ 1;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int n_steps = (K + BK - 1) / BK;
  const int tid = threadIdx.x, t = tid % 128;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // this CTA's producers and the TMA bytes (x, and the peer's half of
      // the words, which its bulk copy completes here)
      sm90::mbar_init(&full[s], 1 + PRODUCERS * 128);
      // one arrival per consumer warp of both CTAs
      sm90::mbar_init(&empty[s], 2 * CONSUMERS * 4);
    }
    for (int s = 0; s < AHEAD; ++s) {
      sm90::mbar_init(&wfull[s], 1);
      sm90::mbar_init(&wempty[s], PRODUCERS * 128);
    }
    sm90::fence_barrier_init();
  }
  sm90::cluster_sync();

  if (wg >= CONSUMERS) {
    sm90::regs_dec<PRODUCER_REGS>();
    // Producer thread pt owns one 8-word piece of this CTA's half: tile row
    // r (k0 + r along k), columns 8c .. 8c + 7 (n0 + 8c along n). The first
    // producer thread stages the half's master rows by TMA, AHEAD - 1 steps
    // ahead, and loads the x tile; each thread draws its words as Quant
    // does and stores them as bf16 in the MN-major swizzled layout (row r
    // at r * 128 bytes, piece c ^ (r % 8)); once the half is stored, one
    // thread copies it into the peer's tile by one bulk copy.
    const int pt = tid - CONSUMERS * 128;
    const int r = HALF * rank + pt / 8, c = pt % 8;
    const int kr = HALF * rank;               // this CTA's first tile row
    auto stage_master = [&](int j) {
      sm90::mbar_arrive_expect_tx(&wfull[j % AHEAD], 4 * W_ELEMS);
      sm90::tma_load_2d(Ws + (j % AHEAD) * W_ELEMS, &wmap, &wfull[j % AHEAD], n0,
                        j * BK + kr);
    };
    if (w_tma && pt == 0)
      for (int j = 0; j < AHEAD - 1 && j < n_steps; ++j) stage_master(j);
    const Quant quant{pow2i(*fl), seed_mix, mode};
    const int n = n0 + 8 * c;
    for (int j = 0; j < n_steps; ++j) {
      const int s = j % STAGES, slot = j % AHEAD, k = j * BK + r;
      float v[8];
      if (w_tma) {
        const int ahead = j + AHEAD - 1;
        if (pt == 0 && ahead < n_steps) {
          sm90::mbar_wait(&wempty[ahead % AHEAD], ((ahead / AHEAD) & 1) ^ 1);
          stage_master(ahead);
        }
        sm90::mbar_wait(&wfull[slot], (j / AHEAD) & 1);
        const float4* src = reinterpret_cast<const float4*>(Ws + slot * W_ELEMS + pt * 8);
        const float4 lo = src[0], hi = src[1];
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
        sm90::fence_proxy_async();   // these reads before the slot's refill by TMA
        sm90::mbar_arrive(&wempty[slot]);
      } else {
        load8(w + (size_t)k * N + n, k < K ? N - n : 0, false, v);
      }
      const int live = k < K ? N - n : 0;
      const uint32_t idx = (uint32_t)k * (uint32_t)N + (uint32_t)n;
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const float a = e < live ? quant(v[e], idx + (uint32_t)e) : 0.f;
        const float b = e + 1 < live ? quant(v[e + 1], idx + (uint32_t)e + 1) : 0.f;
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
        packed[e / 2] = *reinterpret_cast<const uint32_t*>(&h);
      }
      const uint4 v4 = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      // stage s is free in both CTAs
      sm90::mbar_wait_cluster(&empty[s], ((j / STAGES) & 1) ^ 1);
      if (pt == 0) {
        // this CTA's x tile and the peer's word half complete here
        sm90::mbar_arrive_expect_tx(&full[s], 2 * (A_ELEMS + W_ELEMS));
        sm90::tma_load_2d(As + s * A_ELEMS, &xmap, &full[s], j * BK, m0);
      }
      __nv_bfloat16* Bt = Bs + s * B_ELEMS;
      *reinterpret_cast<uint4*>(Bt + r * BN + ((c ^ (r & 7)) * 8)) = v4;
      sm90::fence_proxy_async();
      sm90::named_sync(1, PRODUCERS * 128);   // this CTA's half is stored
      if (pt == 0) {
        const __nv_bfloat16* half = Bt + kr * BN;
        sm90::bulk_copy_to_peer(sm90::peer_addr(half, peer), half, 2 * W_ELEMS,
                                sm90::peer_addr(&full[s], peer));
      }
      sm90::mbar_arrive(&full[s]);
    }
    sm90::cluster_sync();
  } else {
    sm90::regs_inc<CONSUMER_REGS>();
    // A consumer warpgroup: rows m0 + 128 wg .. of y (tc_gemm.cuh), B
    // MN-major; a stage is released to the producers of both CTAs.
    float tot[2][tc_gemm::ACC];
    const int lane = t % 32;
    tc_gemm::consume<false, true, STAGES, PROMOTE>(
        tot, As + wg * 128 * BK, A_ELEMS, Bs, B_ELEMS, n_steps,
        [&](int s, uint32_t parity) { sm90::mbar_wait_cluster(&full[s], parity); },
        [&](int s) {
          __syncwarp();
          if (lane == 0) {
            sm90::mbar_arrive(&empty[s]);
            sm90::mbar_arrive_cluster(sm90::peer_addr(&empty[s], peer));
          }
        });
    tc_gemm::store_tile(tot, pow2i(-*fl), y, M, N, m0 + wg * 128, n0, t);
    sm90::cluster_sync();
  }
}

template <typename TO>
cudaError_t launch(const void* x, int ldx, const float* w, const int* fl, int seed,
                   int mode, void* y, int M, int N, int K, cudaStream_t st) {
  if (K <= 0)
    return cudaMemsetAsync(y, 0, (size_t)M * N * sizeof(TO), st);
  // x (M, K) with rows of ldx elements: boxes of 64 k x 256 rows
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)ldx * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {BK, BM};
  CUtensorMap xmap, wmap = {};
  if (!sm90::bf16_map(&xmap, x, 2, dims, strides, box)) return cudaErrorInvalidValue;
  // the f32 master (K, N): boxes of 64 n x 32 rows, when its rows are
  // 16-byte aligned; else the producer threads read it directly
  const int w_tma = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (w_tma) {
    const cuuint64_t wdims[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t wstrides[1] = {(cuuint64_t)N * sizeof(float)};
    const cuuint32_t wbox[2] = {BN, HALF};
    if (!sm90::f32_map(&wmap, w, 2, wdims, wstrides, wbox)) return cudaErrorInvalidValue;
  }
  const cudaError_t err = sm90::allow_smem<fxp_qmatmul_tc<TO>>(SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(2 * ((M + 2 * BM - 1) / (2 * BM)), (N + BN - 1) / BN);
  fxp_qmatmul_tc<TO><<<grid, THREADS, SMEM, st>>>(
      xmap, wmap, w, fl, (uint32_t)seed * 0x9E3779B9u, mode, static_cast<TO*>(y), M, N, K,
      w_tma);
  return cudaGetLastError();
}

}  // namespace tcf

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

// The tensor-core branch of matmul_qdx: dy (M, N) bf16 with rows of `ldy`
// elements (ldy >= N, a multiple of 8, dy 16-byte aligned), dx (M, K) f32
// or bf16. Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// layout it does not take or a tensor map that cuTensorMapEncodeTiled refuses.
int matmul_qdx_tc_launch(const void* dy, int ldy, const void* w, const void* fl, int seed,
                         int mode, void* dx, int dx_dtype, int M, int N, int K,
                         void* stream) {
  if (M <= 0 || K <= 0) return (int)cudaGetLastError();
  if (ldy < N || ldy % 8 != 0 || reinterpret_cast<uintptr_t>(dy) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const float* wp = static_cast<const float*>(w);
  const int* flp = static_cast<const int*>(fl);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dx_dtype == 1
                   ? tcq::launch<__nv_bfloat16>(dy, ldy, wp, flp, seed, mode, dx, M, N,
                                                K, st)
                   : tcq::launch<float>(dy, ldy, wp, flp, seed, mode, dx, M, N, K, st));
}

// The tensor-core branch of fxp_qmatmul: x (M, K) bf16 with rows of `ldx`
// elements (ldx >= K, a multiple of 8, x 16-byte aligned), y (M, N) f32 or
// bf16. Returns cudaGetLastError(), or cudaErrorInvalidValue for a layout
// it does not take or a tensor map that cuTensorMapEncodeTiled refuses.
int fxp_qmatmul_tc_launch(const void* x, int ldx, const void* w, const void* fl, int seed,
                          int mode, void* y, int y_dtype, int M, int N, int K,
                          void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (ldx < K || ldx % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const float* wp = static_cast<const float*>(w);
  const int* flp = static_cast<const int*>(fl);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(y_dtype == 1
                   ? tcf::launch<__nv_bfloat16>(x, ldx, wp, flp, seed, mode, y, M, N, K, st)
                   : tcf::launch<float>(x, ldx, wp, flp, seed, mode, y, M, N, K, st));
}

}  // extern "C"

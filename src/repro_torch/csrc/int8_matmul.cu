// W8A8 matmul: out = f32(sum_k xq[m, k] * wq[k, n]) * s, the sum exact in
// int32, s = f32(sx) * f32(sw) formed once by the caller.
//
// Replaces the TPU kernel `_int8_matmul_kernel` of
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
// its bytes (MK + KN + 4MN) below. Two kernels, chosen by the wrapper by
// shape and alignment alone:
//  * int8_matmul_tc, where TMA can address both operands (K and N
//    multiples of 16, both bases 16-byte aligned): wgmma m64n256k32 s8 x s8
//    with s32 accumulators, exact for K <= 131071 (the wrapper's bound), so
//    no promotion. A CTA owns 128 rows and 256 columns of out: two consumer
//    warpgroups of 64 x 256, one producer warpgroup (registers 208 / 88 by
//    setmaxnreg). 8-bit wgmma operands must both be K-major (the ISA has no
//    transpose bit for them): xq's tile arrives by TMA as it lies (128
//    k bytes x 128 rows, 128-byte swizzle); wq (K, N) has n contiguous, so
//    its tile (128 k x 256 n) arrives by TMA as it lies into a staging
//    ring, and the producer threads transpose it in 4 x 4 byte blocks by
//    __byte_perm into the swizzled K-major layout wgmma reads (16 rows of
//    4 bytes in, 4 rows of 16 bytes out a thread and unit, both without
//    bank conflicts). fence.proxy.async orders the threads' writes before
//    wgmma reads them and their staging reads before the slot's TMA
//    refill. TMA's zero fill gives the tails; nothing leaves the kernel
//    but out. It replaces, on these shapes, a SIMT __dp4a kernel that ran
//    at ~39x its bound (2.44x torch._int_mm, PERF.md section 6).
//  * int8_matmul_dp4a, any other shape: SIMT __dp4a (four int8 products
//    summed into an int32, exact) on a 128 x 128 output tile per block of
//    256 threads, 8 x 8 outputs per thread (rows ty + 16i, columns tx +
//    16j), k in steps of 32. The (K, N) row-major words have n contiguous,
//    and __dp4a wants four consecutive k of one n in one register: each
//    step loads the x tile and the w tile byte by byte (coalesced, zero
//    past the edges) into shared memory, the w tile transposed to [n][k],
//    rows padded to 9 words so that the 16 columns a warp reads fall in
//    distinct banks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// SIMT __dp4a (shapes TMA cannot address)

namespace dp4a {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int NT = 256;
constexpr int TM = 8, TN = 8;
constexpr int KW = BK / 4;      // int32 words of k per tile row
constexpr int LD = KW + 1;      // padded row stride in words

__global__ void __launch_bounds__(NT)
int8_matmul_dp4a(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
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

cudaError_t launch(const int8_t* x, const int8_t* w, const float* s, float* out, int M, int K,
                   int N, cudaStream_t st) {
  const long long gy = ((long long)N + BN - 1) / BN;
  if (gy > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(((long long)M + BM - 1) / BM), (unsigned)gy);
  int8_matmul_dp4a<<<grid, NT, 0, st>>>(x, w, s, out, M, K, N);
  return cudaGetLastError();
}

}  // namespace dp4a

// ---------------------------------------------------------------------------
// Tensor cores (K % 16 == 0, N % 16 == 0, both bases 16-byte aligned)

namespace tc8 {

constexpr int BM = 128;                  // rows of out a CTA: two consumer warpgroups of 64
constexpr int BN = 256;                  // columns of out a CTA: one m64n256k32 a warpgroup
constexpr int BK = 128;                  // k a stage: one 128-byte swizzled row of A and of B
constexpr int STAGES = 3;                // A / B ring
constexpr int AHEAD = 2;                 // word staging ring
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER_REGS = 88;        // setmaxnreg: 128 x 88 + 256 x 208
constexpr int CONSUMER_REGS = 208;       //   = the 384 x 168 the launch holds
constexpr int A_BYTES = BM * BK;         // xq tile, K-major, swizzled
constexpr int B_BYTES = BN * BK;         // wq tile transposed: K-major, swizzled
constexpr int W_BYTES = BK * BN;         // wq tile as it lies: [k][n]
constexpr size_t SMEM = 1024 + (size_t)STAGES * (A_BYTES + B_BYTES) +
                        (size_t)AHEAD * W_BYTES + 16 * (STAGES + AHEAD);

// Four rows of four bytes (r[i] holds bytes [i][0..3]) as four columns
// (c[e] holds bytes [0..3][e]).
__device__ __forceinline__ void transpose4(const uint32_t* r, uint32_t* c) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140u);   // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140u);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362u);   // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362u);
  c[0] = __byte_perm(t0, t1, 0x5410u);
  c[1] = __byte_perm(t0, t1, 0x7632u);
  c[2] = __byte_perm(t2, t3, 0x5410u);
  c[3] = __byte_perm(t2, t3, 0x7632u);
}

__global__ void __launch_bounds__(THREADS, 1)
int8_matmul_tc(const __grid_constant__ CUtensorMap amap,
               const __grid_constant__ CUtensorMap wmap, const float* __restrict__ s,
               float* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* As = sm90::align1024<uint8_t>(smem_raw);
  uint8_t* Bs = As + STAGES * A_BYTES;
  uint8_t* Ws = Bs + STAGES * B_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Ws + AHEAD * W_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* wfull = empty + STAGES;
  uint64_t* wempty = wfull + AHEAD;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int n_steps = (K + BK - 1) / BK;
  const int tid = threadIdx.x, t = tid % 128;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      sm90::mbar_init(&full[i], 1 + 128);         // A's bytes, then the transposers
      sm90::mbar_init(&empty[i], CONSUMERS * 4);  // one arrival per consumer warp
    }
    for (int i = 0; i < AHEAD; ++i) {
      sm90::mbar_init(&wfull[i], 1);              // the staged tile's TMA
      sm90::mbar_init(&wempty[i], 128);           // the transposers
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    sm90::regs_dec<PRODUCER_REGS>();
    // The producer warpgroup. Its first thread keeps the staging ring
    // AHEAD - 1 steps ahead and loads the A tile of each step; every thread
    // transposes 4 units of the staged [k][n] tile a step: a unit is the
    // 16 k of chunk c and the 4 n of group g (16 rows of 4 bytes read,
    // 4 rows of 16 bytes written at chunk c ^ (n % 8) of row n). Thread
    // (warp, lane) takes g = 32 (warp % 2) + lane, so a warp's reads cover
    // 32 distinct banks, and c = (2q + warp / 2 + lane) % 8 for its units
    // q = 0..3, so that the 8 lanes of a quarter-warp store to 8 distinct
    // 16-byte positions.
    const int warp = t / 32, lane = t % 32;
    const int g = 32 * (warp % 2) + lane;
    auto stage_words = [&](int j) {
      sm90::mbar_arrive_expect_tx(&wfull[j % AHEAD], W_BYTES);
      sm90::tma_load_2d(Ws + (j % AHEAD) * W_BYTES, &wmap, &wfull[j % AHEAD], n0, j * BK);
    };
    if (t == 0)
      for (int j = 0; j < AHEAD - 1 && j < n_steps; ++j) stage_words(j);
    for (int j = 0; j < n_steps; ++j) {
      const int st = j % STAGES, slot = j % AHEAD;
      if (t == 0) {
        const int ahead = j + AHEAD - 1;
        if (ahead < n_steps) {
          sm90::mbar_wait(&wempty[ahead % AHEAD], ((ahead / AHEAD) & 1) ^ 1);
          stage_words(ahead);
        }
      }
      sm90::mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);
      if (t == 0) {
        sm90::mbar_arrive_expect_tx(&full[st], A_BYTES);
        sm90::tma_load_2d(As + st * A_BYTES, &amap, &full[st], j * BK, m0);
      }
      sm90::mbar_wait(&wfull[slot], (j / AHEAD) & 1);
      const uint8_t* W = Ws + slot * W_BYTES;
      uint8_t* B = Bs + st * B_BYTES;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = (2 * q + warp / 2 + lane) % 8;
        uint32_t r[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          r[i] = *reinterpret_cast<const uint32_t*>(W + (16 * c + i) * BN + 4 * g);
        uint32_t col[4][4];                       // col[b][e]: n = 4g + e, k = 16c + 4b ..
#pragma unroll
        for (int b = 0; b < 4; ++b) transpose4(r + 4 * b, col[b]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * g + e;
          *reinterpret_cast<uint4*>(B + n * BK + ((c ^ (n % 8)) * 16)) =
              make_uint4(col[0][e], col[1][e], col[2][e], col[3][e]);
        }
      }
      // the threads' writes before wgmma reads them, and their reads of the
      // staging slot before its TMA refill (async proxy)
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&wempty[slot]);
      sm90::mbar_arrive(&full[st]);
    }
  } else {
    sm90::regs_inc<CONSUMER_REGS>();
    // A consumer warpgroup: rows m0 + 64 wg .. + 63, the CTA's 256 columns;
    // 4 k32 products a stage, one commit group a stage, a stage released
    // once the products that read it are done.
    int32_t acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    const int lane = t % 32;
    for (int j = 0; j < n_steps; ++j) {
      const int st = j % STAGES;
      sm90::mbar_wait(&full[st], (j / STAGES) & 1);
      sm90::wgmma_fence();
      const uint8_t* A = As + st * A_BYTES + wg * 64 * BK;
      const uint8_t* B = Bs + st * B_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        sm90::wgmma_ss_n256_s8(acc, sm90::desc128(A + 32 * kk, 16, 1024),
                               sm90::desc128(B + 32 * kk, 16, 1024), j > 0 || kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (j > 0) {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[(j - 1) % STAGES]);
      }
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    // the wgmma fragment: warp w, lane (g, tig) holds rows 16 w + g (+ 8)
    // and columns 8 jb + 2 tig (+ 1)
    const float sc = *s;
    const int w4 = t / 32, gr = lane / 4, tig = lane % 4;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = m0 + wg * 64 + w4 * 16 + gr + 8 * rr;
      if (row >= M) continue;
      float* o = out + (size_t)row * N;
#pragma unroll
      for (int jb = 0; jb < BN / 8; ++jb) {
        const int c = n0 + 8 * jb + 2 * tig;
        if (c < N)                               // N % 16 == 0: the pair is in range
          *reinterpret_cast<float2*>(o + c) =
              make_float2(__fmul_rn(__int2float_rn(acc[4 * jb + 2 * rr]), sc),
                          __fmul_rn(__int2float_rn(acc[4 * jb + 2 * rr + 1]), sc));
      }
    }
  }
}

cudaError_t launch(const int8_t* x, const int8_t* w, const float* s, float* out, int M, int K,
                   int N, cudaStream_t st) {
  // xq (M, K): boxes of 128 k x 128 rows, swizzled; wq (K, N): boxes of
  // 256 n x 128 k as they lie
  const cuuint64_t adims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t astrides[1] = {(cuuint64_t)K};
  const cuuint32_t abox[2] = {BK, BM};
  const cuuint64_t wdims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t wstrides[1] = {(cuuint64_t)N};
  const cuuint32_t wbox[2] = {BN, BK};
  CUtensorMap amap, wmap;
  if (!sm90::int8_map_sw128(&amap, x, 2, adims, astrides, abox) ||
      !sm90::int8_map(&wmap, w, 2, wdims, wstrides, wbox))
    return cudaErrorInvalidValue;
  const long long gy = ((long long)N + BN - 1) / BN;
  if (gy > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = sm90::allow_smem<int8_matmul_tc>(SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (unsigned)gy);
  int8_matmul_tc<<<grid, THREADS, SMEM, st>>>(amap, wmap, s, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace tc8

}  // namespace

extern "C" {

// out (M, N) f32 = f32(xq (M, K) int8 @ wq (K, N) int8, exact int32) * *s,
// s a device f32 scalar, on the SIMT __dp4a kernel (any shape). Returns
// cudaGetLastError().
int int8_matmul_launch(const void* xq, const void* wq, const void* s, void* out,
                       int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  return (int)dp4a::launch(static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
                           static_cast<const float*>(s), static_cast<float*>(out), M, K, N,
                           static_cast<cudaStream_t>(stream));
}

// The same on the tensor cores: K > 0, K and N multiples of 16, xq and wq
// 16-byte aligned. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a shape or layout TMA cannot address.
int int8_matmul_tc_launch(const void* xq, const void* wq, const void* s, void* out,
                          int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (K <= 0 || K % 16 != 0 || N % 16 != 0 || reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wq) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return (int)tc8::launch(static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
                          static_cast<const float*>(s), static_cast<float*>(out), M, K, N,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"

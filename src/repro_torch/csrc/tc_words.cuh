// The int8-word GEMM on the tensor cores shared by matmul_dx_tc
// (fxp_matmul_bwd.cu) and fxp_matmul_tc (fxp_matmul.cu):
//
//   out (M, C) = (A (M, L) bf16 @ B) * scale, B (L, C) the int8 words w
//   read in place, w (rows, cols) row-major;
//   dx (MN false): out = dx, A = dy, C = rows (K), L = cols (N), B = w^T,
//     both operands K-major;
//   forward (MN true): out = y, A = x, C = cols (N), L = rows (K), B = w,
//     B MN-major (its rows, the words' rows, run along the contraction).
//
// A CTA owns BM = 256 rows and BN = 64 columns of the output, with two
// consumer warpgroups on wgmma (tc_gemm.cuh) and two producer warpgroups
// that take the steps of 64 along the contraction in turn. For its step a
// producer warpgroup's first thread loads the A tile (128-byte swizzle)
// and, AHEAD - 1 of its steps ahead, the 64 x 64 int8 word tile (no
// swizzle) into its staging ring, both by TMA; its threads convert the
// words to bf16 (exact) into the swizzled layout wgmma reads. The staged
// word tile is 64 word rows of 64 bytes in either direction, and the
// converted tile the same 64 rows of 128 bytes: for dx a word row is an
// output column, so the tile is K-major; for the forward a word row is a
// contraction row, so the same bytes are MN-major and wgmma reads them
// with the transpose bit. Words whose rows TMA cannot address (cols % 16
// != 0 or a misaligned base) are read directly. The consumers restart
// their f32 accumulators every PROMOTE steps into round-to-nearest totals
// (wgmma's sums round toward zero) and scale by the device scalar in the
// epilogue. No cluster: nothing is drawn, so nothing is shared.
//
// What bounds it: the producers' chain of waits and conversions, ~0.65 us
// a step against ~0.28 us of tensor work (PERF.md section 7). A 128 x 128
// tile (warpgroups of 64 x 128, eight pieces a producer thread) reads
// 1.5x less from L2 and made matmul_dw_tc 1.5x faster, but timed 5-15%
// slower here (PERF.md section 6): a producer's chain, not the operands'
// bandwidth, sets this pipeline's step.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tc_gemm.cuh"

namespace tc_words {

constexpr int BM = 256;                  // output rows per CTA
constexpr int BN = 64;                   // output columns per CTA (= BK: a staged
                                         // word tile is 64 x 64 either way)
constexpr int BK = 64;                   // contraction step
constexpr int STAGES = 5;                // A / word ring
constexpr int AHEAD = 3;                 // int8 word staging ring of a producer
constexpr int CONSUMERS = 2;             // warpgroups of BM / 2 rows
constexpr int PRODUCERS = 2;             // warpgroups taking turns by step
constexpr int MT = BM / (CONSUMERS * 64);  // m64 products of a consumer
constexpr int THREADS = (CONSUMERS + PRODUCERS) * 128;
constexpr int PRODUCER_REGS = 88;        // setmaxnreg: 256 x 88 + 256 x 168
constexpr int CONSUMER_REGS = 168;       //   = the 512 x 128 the launch holds
constexpr int A_ELEMS = BM * BK;         // A tile
constexpr int B_ELEMS = BN * BK;         // word tile as bf16
constexpr int W_BYTES = BN * BK;         // word tile as int8, staged
constexpr int PIECES = W_BYTES / 8 / 128;  // 8-word pieces a producer thread
constexpr size_t SMEM = 1024 + 2 * (size_t)STAGES * (A_ELEMS + B_ELEMS) +
                        (size_t)PRODUCERS * AHEAD * W_BYTES + 16 * STAGES +
                        16 * PRODUCERS * AHEAD;
static_assert(BK == tc_gemm::BK && BN == tc_gemm::COLS && BM == CONSUMERS * tc_gemm::ROWS,
              "the consumers' tiling");

__device__ __forceinline__ float read_scale(const void* scale, int scale_bf16) {
  return scale_bf16 ? __bfloat162float(*static_cast<const __nv_bfloat16*>(scale))
                    : *static_cast<const float*>(scale);
}

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

// `Name`, a type each user declares (fxp_matmul_tc, matmul_dx_tc), only
// names the kernel, so that a profile tells the two apart.
template <typename Name, bool MN, int PROMOTE, typename TO>
__global__ void __launch_bounds__(THREADS, 1)
words_gemm_tc(const __grid_constant__ CUtensorMap amap,
              const __grid_constant__ CUtensorMap wmap, const int8_t* __restrict__ w,
              int rows, int cols, const void* __restrict__ scale, int scale_bf16,
              TO* __restrict__ out, int M, int C, int L, int w_tma) {
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* As = sm90::align1024<__nv_bfloat16>(smem_raw);
  __nv_bfloat16* Bs = As + STAGES * A_ELEMS;
  int8_t* Ws = reinterpret_cast<int8_t*>(Bs + STAGES * B_ELEMS);  // word staging
  uint64_t* full = reinterpret_cast<uint64_t*>(Ws + PRODUCERS * AHEAD * W_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* wfull = empty + STAGES;               // per producer warpgroup
  uint64_t* wempty = wfull + PRODUCERS * AHEAD;

  const int m0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int n_steps = (L + BK - 1) / BK;
  const int tid = threadIdx.x, t = tid % 128;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1 + 128);         // a producer warpgroup, A's bytes
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
    // flight. The word tile of step j, 64 word rows of 64 bytes, starts at
    // word row r0, column q0: for dx at the CTA's output columns and the
    // step's contraction, for the forward the other way round. Each thread
    // converts PIECES 8-word pieces (staged row p / ROW, piece p % ROW) and
    // stores them as 64 rows of 128 bytes: row r at r * 128 bytes, piece
    // c ^ (r % 8) (K-major for dx, MN-major for the forward).
    const int pw = wg - CONSUMERS;
    int8_t* Wp = Ws + pw * AHEAD * W_BYTES;
    uint64_t* wf = wfull + pw * AHEAD;
    uint64_t* we = wempty + pw * AHEAD;
    const int n_mine = (n_steps - pw + PRODUCERS - 1) / PRODUCERS;
    constexpr int ROW = BN / 8;                  // pieces a staged word row
    auto origin = [&](int i, int& r0, int& q0) {
      const int l0 = (PRODUCERS * i + pw) * BK;
      r0 = MN ? l0 : c0;
      q0 = MN ? c0 : l0;
    };
    auto stage_words = [&](int i) {
      int r0, q0;
      origin(i, r0, q0);
      sm90::mbar_arrive_expect_tx(&wf[i % AHEAD], W_BYTES);
      sm90::tma_load_2d(Wp + (i % AHEAD) * W_BYTES, &wmap, &wf[i % AHEAD], q0, r0);
    };
    if (w_tma && t == 0)
      for (int i = 0; i < AHEAD - 1 && i < n_mine; ++i) stage_words(i);
    for (int i = 0; i < n_mine; ++i) {
      const int j = PRODUCERS * i + pw;
      const int s = j % STAGES, slot = i % AHEAD;
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
          const int p = t + 128 * q;
          pieces[q] = words_bf16(
              *reinterpret_cast<const uint2*>(Wp + slot * W_BYTES + p * 8));
        }
        // the generic reads of the slot before the TMA that refills it
        // (async proxy): without the fence a refill could land under
        // reads still in flight, one word row of a step in a thousand
        // calls at the head (and nearly every call with AHEAD = 2)
        sm90::fence_proxy_async();
        sm90::mbar_arrive(&we[slot]);
      } else {
        int r0, q0;
        origin(i, r0, q0);
#pragma unroll
        for (int q = 0; q < PIECES; ++q) {
          const int p = t + 128 * q, r = r0 + p / ROW, c = q0 + 8 * (p % ROW);
          const int live = r < rows ? cols - c : 0;
          alignas(8) int8_t b[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) b[e] = e < live ? w[(size_t)r * cols + c + e] : 0;
          pieces[q] = words_bf16(*reinterpret_cast<const uint2*>(b));
        }
      }
      sm90::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      if (t == 0) {
        sm90::mbar_arrive_expect_tx(&full[s], 2 * A_ELEMS);
        sm90::tma_load_2d(As + s * A_ELEMS, &amap, &full[s], j * BK, m0);
      }
      __nv_bfloat16* Bt = Bs + s * B_ELEMS;
#pragma unroll
      for (int q = 0; q < PIECES; ++q) {
        const int p = t + 128 * q, r = p / ROW, c = p % ROW;
        *reinterpret_cast<uint4*>(Bt + r * BK + ((c ^ (r & 7)) * 8)) = pieces[q];
      }
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&full[s]);
    }
  } else {
    sm90::regs_inc<CONSUMER_REGS>();
    // A consumer warpgroup: rows m0 + 64 MT wg .. of the output
    // (tc_gemm.cuh).
    float tot[MT][BN / 2];
    const int lane = t % 32;
    tc_gemm::consume<false, MN, STAGES, PROMOTE>(
        tot, As + wg * MT * 64 * BK, A_ELEMS, Bs, B_ELEMS, n_steps,
        [&](int s, uint32_t parity) { sm90::mbar_wait(&full[s], parity); },
        [&](int s) {
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(&empty[s]);
        });
    tc_gemm::store_tile(tot, read_scale(scale, scale_bf16), out, M, C, m0 + wg * MT * 64, c0,
                        t);
  }
}

// out (M, C) as above; a (M, L) bf16 with rows of `lda` elements (lda >= L,
// a multiple of 8, 16-byte aligned: the caller has checked), w (rows, cols)
// int8. M and C > 0.
template <typename Name, bool MN, int PROMOTE, typename TO>
cudaError_t launch(const void* a, int lda, const int8_t* w, int rows, int cols,
                   const void* scale, int sb, void* out, int M, int C, int L,
                   cudaStream_t st) {
  if (L <= 0)
    return cudaMemsetAsync(out, 0, (size_t)M * C * sizeof(TO), st);
  // A (M, L): boxes of 64 along the contraction x BM rows
  const cuuint64_t dims[2] = {(cuuint64_t)L, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)lda * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {BK, BM};
  CUtensorMap amap, wmap = {};
  if (!sm90::bf16_map(&amap, a, 2, dims, strides, box)) return cudaErrorInvalidValue;
  // the int8 words (rows, cols): boxes of 64 word rows of 64 bytes, when
  // rows are 16-byte aligned
  const int w_tma = cols % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (w_tma) {
    const cuuint64_t wdims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t wstrides[1] = {(cuuint64_t)cols};
    const cuuint32_t wbox[2] = {BN, BK};
    if (!sm90::int8_map(&wmap, w, 2, wdims, wstrides, wbox)) return cudaErrorInvalidValue;
  }
  const cudaError_t err = sm90::allow_smem<words_gemm_tc<Name, MN, PROMOTE, TO>>(SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (C + BN - 1) / BN);
  words_gemm_tc<Name, MN, PROMOTE, TO><<<grid, THREADS, SMEM, st>>>(
      amap, wmap, w, rows, cols, scale, sb, static_cast<TO*>(out), M, C, L, w_tma);
  return cudaGetLastError();
}

}  // namespace tc_words

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
//  * M <= 16 (decode, either dtype): fxp_matmul_gemv, one launch, no
//    workspace, no atomics. Its bound is the word bytes. A CTA of 8 warps
//    owns 128 columns of y and a range of K; a lane reads 8 bytes of a word
//    row at M <= 4 (4 above), keeps 8 rows in flight (4 at M > 8, whose
//    64 accumulators take one CTA an SM) and converts words to f32 by a
//    byte permute into 0x4B0000xx and one subtract (exact, no I2F, whose
//    rate is an eighth of the FMAs'). The
//    ring's reloads are unconditional (the last row again past the end):
//    ptxas schedules predicated ones after the whole block of rows, and
//    the warp then waits a full memory latency every block. x's chunk
//    comes by cp.async while the first rows load, and is converted once
//    to f32 [k][m] in shared memory (one 16-byte read a row at M <= 4).
//    The k rows of the CTA's range go round-robin to its slots (8 warps x
//    the rows a warp reads at once); each slot sums its rows in order, the
//    warp adds its slots by a shuffle, the CTA its 8 warps in order; the
//    CTAs of a thread-block cluster (up to 8, along K, sized by the
//    wrapper's plan from the shape) each hold a partial, and rank 0 adds
//    them in rank order through distributed shared memory, applies the
//    scale once and stores y. So the sum order is a fixed function of the
//    shape, and repeated calls give equal bits. What still bounds it is
//    the memory system's rate for this access pattern (128-byte pieces of
//    many rows; about 2.4 TB/s at the LM head, PERF.md section 7): wider
//    pieces a warp, deeper rings and fewer or more CTAs all timed slower.
//    It replaces a split-K kernel with f32 atomicAdd, a memset and a
//    second launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// GEMV (M <= 16)

namespace gemv {

constexpr int MAX_M = 16;
constexpr int WARPS = 8;                 // warps of a CTA
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 128;                // columns of y a CTA owns: 128 bytes of a word row
constexpr int ACC = 32;                  // f32 accumulators a lane at M <= 8: MB x CPT
constexpr int X_BYTES = 49152;           // a chunk of x in shared memory, as f32
constexpr int RING = 8;                  // word rows in flight a lane at M <= 8
constexpr int MAX_CLUSTER = 8;

// The lanes' layout for an M bucket MB (4, 8, 16).
template <int MB>
struct Shape {
  static constexpr int CPT = ACC / MB < 4 ? 4 : ACC / MB;   // columns a lane: 8, 4, 4
  static constexpr int LPR = COLS / CPT;         // lanes along a word row: 16, 32, 32
  static constexpr int KR = 32 / LPR;            // word rows a warp reads at once: 2, 1, 1
  static constexpr int SLOTS = WARPS * KR;       // k slots of a CTA: 16, 8, 8
  static constexpr int UNROLL = MB * CPT > ACC ? RING / 2 : RING;  // rows in flight: 8, 8, 4
  static constexpr int MIN_CTAS = MB * CPT > ACC ? 1 : 2;  // an SM's CTAs: 128 registers or 255
  static constexpr int XC = X_BYTES / (4 * MB);  // x columns a chunk: 3072, 1536, 768
  // shared memory: x as f32 [XC][MB] and as it lies [MB][XC] (X_BYTES
  // each at most), then the warps' partials in the same bytes; this CTA's
  // partial [MB][COLS] after them
  static constexpr int PART = WARPS * MB * COLS * 4;
  static constexpr int REGION = 2 * X_BYTES > PART ? 2 * X_BYTES : PART;
  static constexpr size_t SMEM = REGION + MB * COLS * 4;
};

// CPT bytes of a word row at p (in range, CPT-aligned) as CPT / 4 words.
template <int CPT>
__device__ __forceinline__ void load_vec(uint32_t (&u)[CPT / 4], const int8_t* p) {
  if constexpr (CPT == 16) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    u[0] = v.x; u[1] = v.y; u[2] = v.z; u[3] = v.w;
  } else if constexpr (CPT == 8) {
    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
    u[0] = v.x; u[1] = v.y;
  } else {
    u[0] = __ldcs(reinterpret_cast<const unsigned int*>(p));
  }
}

// The same bytewise, the columns past `live` zero (the edge of N, a
// misaligned or ragged word matrix).
template <int CPT>
__device__ __forceinline__ void load_bytes(uint32_t (&u)[CPT / 4], const int8_t* p, int live) {
#pragma unroll
  for (int q = 0; q < CPT / 4; ++q) {
    u[q] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * q + e < live) u[q] |= (uint32_t)(uint8_t)p[4 * q + e] << (8 * e);
  }
}

// Four int8 words (bytes of u) as f32, exactly: each byte's sign bit
// flipped (b + 128 in 0..255) and permuted under 0x4B000000 gives the f32
// 2^23 + b + 128; subtracting 2^23 + 128 leaves b.
__device__ __forceinline__ void words_f32(uint32_t u, float* f) {
  const uint32_t v = u ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540u + e)) - 8388736.f;
}

// One word row into the lane's sums: acc[m][j] += x[m] * w[j], x the MB
// f32 of the row at xr.
template <int MB, int CPT>
__device__ __forceinline__ void fma_row(float (&acc)[MB][CPT], const uint32_t (&u)[CPT / 4],
                                        const float* xr) {
  float wf[CPT];
#pragma unroll
  for (int e = 0; e < CPT / 4; ++e) words_f32(u[e], wf + 4 * e);
#pragma unroll
  for (int m0 = 0; m0 < MB; m0 += 4) {   // x four rows at a time: few registers live
    const float4 v = *reinterpret_cast<const float4*>(xr + m0);
    const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[m0 + m][j] = fmaf(xv[m], wf[j], acc[m0 + m][j]);
  }
}

// y (M, N) = (x (M, K) @ w (K, N)) * scale for M <= MB. The grid is
// (ceil(N / 128), cs) in clusters of (1, cs, 1); rank r sums the k rows
// [r kc, min(K, (r + 1) kc)).
template <int MB, typename TX, typename TY>
__global__ void __launch_bounds__(THREADS, Shape<MB>::MIN_CTAS)
fxp_matmul_gemv(const TX* __restrict__ x, const int8_t* __restrict__ w,
                const void* __restrict__ scale, int scale_bf16, TY* __restrict__ y, int M,
                int N, int K, int kc, int vec, int x_vec) {
  using S = Shape<MB>;
  constexpr int CPT = S::CPT;
  constexpr int XE = 16 / sizeof(TX);    // x elements a 16-byte copy
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                      // x chunk as f32 [XC][MB]; then the warps' partials
  TX* xraw = reinterpret_cast<TX*>(smem + X_BYTES / 4);   // x chunk as it lies [MB][XC]
  float* cpart = smem + S::REGION / 4;   // this CTA's partial [MB][COLS]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cg = lane % S::LPR, kr = lane / S::LPR;
  const int slot = warp * S::KR + kr;
  const int n = blockIdx.x * COLS + cg * CPT;
  const uint32_t rank = sm90::cluster_rank(), cs = gridDim.y;
  const int k_lo = (int)rank * kc, k_hi = min(K, k_lo + kc);
  const bool full = vec && n + CPT <= N;
  const int live = N - n;
  const size_t step = (size_t)S::SLOTS * N;

  float acc[MB][CPT];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[m][j] = 0.f;

  for (int c0 = k_lo; c0 < k_hi; c0 += S::XC) {
    const int rows = min(S::XC, k_hi - c0);
    // this slot's rows of the chunk, c0 + slot + SLOTS i in order
    const int cnt = slot < rows ? (rows - 1 - slot) / S::SLOTS + 1 : 0;
    const int8_t* wp = w + (size_t)(c0 + slot) * N + n;
    __syncthreads();                     // the previous chunk's reads of xs are done
    // the chunk of x by 16-byte copies without registers where its rows
    // allow, while the first UNROLL word rows are loaded
    if (x_vec) {
      const int per_row = rows / XE;
      for (int i = tid; i < M * per_row; i += THREADS) {
        const int m = i / per_row, v = i % per_row;
        sm90::cp_async16(xraw + m * S::XC + v * XE, x + (size_t)m * K + c0 + v * XE);
      }
    }
    uint32_t u[S::UNROLL][CPT / 4];
    if (full) {
#pragma unroll
      for (int q = 0; q < S::UNROLL; ++q)
        if (q < cnt) load_vec<CPT>(u[q], wp + q * step);
    }
    if (x_vec) {
      sm90::cp_async_wait_all();
      __syncthreads();
      for (int i = tid; i < rows * MB; i += THREADS) {
        const int k = i / MB, m = i % MB;
        xs[i] = m < M ? to_f32(xraw[m * S::XC + k]) : 0.f;
      }
    } else {
      for (int i = tid; i < rows * MB; i += THREADS) {
        const int k = i / MB, m = i % MB;
        xs[i] = m < M ? to_f32(x[(size_t)m * K + c0 + k]) : 0.f;
      }
    }
    __syncthreads();
    if (full) {
      // UNROLL rows in flight: row i's registers take row i + UNROLL once
      // it is summed; whole blocks first, no branch in the loop
      int i0 = 0;
      for (; i0 + S::UNROLL <= cnt; i0 += S::UNROLL) {
#pragma unroll
        for (int q = 0; q < S::UNROLL; ++q) {
          fma_row<MB, CPT>(acc, u[q], xs + (slot + S::SLOTS * (i0 + q)) * MB);
          // unconditional (the last row again past the end): a predicated
          // reload is scheduled after the whole block, which stalls it
          load_vec<CPT>(u[q], wp + min(i0 + q + S::UNROLL, cnt - 1) * step);
        }
      }
#pragma unroll
      for (int q = 0; q < S::UNROLL; ++q)
        if (i0 + q < cnt) fma_row<MB, CPT>(acc, u[q], xs + (slot + S::SLOTS * (i0 + q)) * MB);
    } else {
      // the edge of N, or words a vector load cannot take: bytewise
      for (int i = 0; i < cnt; ++i) {
        uint32_t b[CPT / 4];
        load_bytes<CPT>(b, wp + i * step, live);
        fma_row<MB, CPT>(acc, b, xs + (slot + S::SLOTS * i) * MB);
      }
    }
  }

  // the KR slots of a column group, a tree over the lanes (kr ^ 1, then kr ^ 2)
#pragma unroll
  for (int off = S::LPR; off < 32; off *= 2)
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
  __syncthreads();                       // every read of xs is done: the region takes the partials
  float* part = smem;                    // [WARPS][MB][COLS]
  if (kr == 0) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int j = 0; j < CPT; j += 4)
        *reinterpret_cast<float4*>(part + (warp * MB + m) * COLS + cg * CPT + j) =
            make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2], acc[m][j + 3]);
  }
  __syncthreads();
  // the CTA's partial: each thread owns MB * COLS / THREADS outputs and adds
  // the warps' partials in warp order
  constexpr int OUTS = MB * COLS / THREADS;
  float tot[OUTS];
#pragma unroll
  for (int o = 0; o < OUTS; ++o) {
    const int idx = tid + THREADS * o;
    tot[o] = part[idx];
#pragma unroll
    for (int v = 1; v < WARPS; ++v) tot[o] += part[v * MB * COLS + idx];
  }
  if (cs > 1) {
    // rank 0 adds the cluster's partials in rank order
#pragma unroll
    for (int o = 0; o < OUTS; ++o) cpart[tid + THREADS * o] = tot[o];
    sm90::cluster_sync();
    if (rank == 0) {
      for (uint32_t r = 1; r < cs; ++r)
#pragma unroll
        for (int o = 0; o < OUTS; ++o) tot[o] += sm90::ld_peer_f32(cpart + tid + THREADS * o, r);
    }
    sm90::cluster_sync();                // the peers' partials stay until rank 0 has read them
  }
  if (rank != 0) return;
  const float s = read_scale(scale, scale_bf16);
#pragma unroll
  for (int o = 0; o < OUTS; ++o) {
    const int idx = tid + THREADS * o, m = idx / COLS;
    const int col = blockIdx.x * COLS + idx % COLS;
    if (m < M && col < N) y[(size_t)m * N + col] = from_f32<TY>(__fmul_rn(tot[o], s));
  }
}

template <int MB, typename TX, typename TY>
cudaError_t launch_mb(const TX* x, const int8_t* w, const void* scale, int sb, TY* y, int M,
                      int N, int K, int cs, int kc, cudaStream_t st) {
  const size_t smem = Shape<MB>::SMEM;
  cudaError_t err = sm90::allow_smem<fxp_matmul_gemv<MB, TX, TY>>(smem);
  if (err != cudaSuccess) return err;
  constexpr int CPT = Shape<MB>::CPT;
  const int vec = N % CPT == 0 && reinterpret_cast<uintptr_t>(w) % CPT == 0;
  const int x_vec = K % (16 / sizeof(TX)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + COLS - 1) / COLS, cs, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fxp_matmul_gemv<MB, TX, TY>, x, w, scale, sb, y, M, N, K, kc, vec,
                           x_vec);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t launch(const void* x, const int8_t* w, const void* scale, int sb, void* y, int M,
                   int N, int K, int cs, int kc, cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  TY* yp = static_cast<TY*>(y);
  if (M <= 4) return launch_mb<4>(xp, w, scale, sb, yp, M, N, K, cs, kc, st);
  if (M <= 8) return launch_mb<8>(xp, w, scale, sb, yp, M, N, K, cs, kc, st);
  return launch_mb<16>(xp, w, scale, sb, yp, M, N, K, cs, kc, st);
}

}  // namespace gemv

// f32 x, M > 16: the tiled SIMT kernel
cudaError_t launch_tiled(const float* x, const int8_t* w, const void* scale, int scale_bf16,
                         void* y, int y_bf16, int M, int N, int K, cudaStream_t stream) {
  const int vec4 = (N % 4 == 0) && ((uintptr_t)w % 4 == 0);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (y_bf16)
    fxp_matmul_tiled<float, __nv_bfloat16><<<grid, NT, 0, stream>>>(
        x, w, scale, scale_bf16, static_cast<__nv_bfloat16*>(y), M, N, K, vec4);
  else
    fxp_matmul_tiled<float, float><<<grid, NT, 0, stream>>>(
        x, w, scale, scale_bf16, static_cast<float*>(y), M, N, K, vec4);
  return cudaGetLastError();
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

// dtype codes: 0 = float32, 1 = bfloat16.

// The SIMT branch of fxp_matmul: f32 x with M > 16. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for bf16 x or M <= 16 (the
// tensor-core and GEMV branches').
int fxp_matmul_launch(const void* x, int x_dtype, const void* w,
                      const void* scale, int scale_dtype, void* y, int y_dtype,
                      int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (x_dtype != 0 || M <= gemv::MAX_M) return (int)cudaErrorInvalidValue;
  return (int)launch_tiled(static_cast<const float*>(x), static_cast<const int8_t*>(w), scale,
                           scale_dtype == 1, y, y_dtype == 1, M, N, K,
                           static_cast<cudaStream_t>(stream));
}

// The GEMV branch of fxp_matmul: 0 < M <= 16, x f32 or bf16, y f32 or
// bf16. The wrapper's plan splits K over a cluster of `cs` CTAs (1..8),
// `kc` rows each. Returns cudaGetLastError() (cudaLaunchKernelEx's error
// first), or cudaErrorInvalidValue for M > 16 or a plan that does not
// cover K.
int fxp_matmul_gemv_launch(const void* x, int x_dtype, const void* w, const void* scale,
                           int scale_dtype, void* y, int y_dtype, int M, int N, int K,
                           int cs, int kc, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (M > gemv::MAX_M || cs < 1 || cs > gemv::MAX_CLUSTER || kc < 0 ||
      (long long)cs * kc < K)
    return (int)cudaErrorInvalidValue;
  const int8_t* wp = static_cast<const int8_t*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sb = scale_dtype == 1;
  cudaError_t err;
  if (x_dtype == 1 && y_dtype == 1)
    err = gemv::launch<__nv_bfloat16, __nv_bfloat16>(x, wp, scale, sb, y, M, N, K, cs, kc, st);
  else if (x_dtype == 1)
    err = gemv::launch<__nv_bfloat16, float>(x, wp, scale, sb, y, M, N, K, cs, kc, st);
  else if (y_dtype == 1)
    err = gemv::launch<float, __nv_bfloat16>(x, wp, scale, sb, y, M, N, K, cs, kc, st);
  else
    err = gemv::launch<float, float>(x, wp, scale, sb, y, M, N, K, cs, kc, st);
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

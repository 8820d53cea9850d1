// Flash attention backward (recompute from the stashed logsumexp) for Hopper.
//
//  * flash_dq_tc and flash_dq (its two branches) replace the TPU kernel
//    `_flash_dq_kernel` and
//  * flash_dkv_tc and flash_dkv replace `_flash_dkv_kernel`,
// both of src/repro/kernels/flash_attention.py (reached through
// `flash_attention_bwd`, their two pallas_calls). Inputs as the forward's
// (csrc/flash_attention.cu): q and the output gradient dO are
// (B, Sq, H, D), k and v (B, Skv, Hkv, D), all contiguous and of one dtype
// (bf16 or f32); lse and delta = sum(dO * o) are (B, H, Sq) f32. Outputs in
// that dtype: dq (B, Sq, H, D), dk and dv (B, Skv, Hkv, D) with the rep
// query heads of each GQA group summed. Everything is computed in f32:
//   s = scale * q.k,  t = softcap * tanh(s / softcap) (or s),
//   p = exp(t - lse) where the mask admits the pair, else exactly 0,
//   dp = dO.v,  g = p * (dp - delta) * (1 - (t / softcap)^2 if softcap),
//   dq = scale * sum_keys g k,  dk = scale * sum_rows g q,  dv = sum_rows p dO.
// The mask is the forward's: end-aligned queries (q_offset = Skv - Sq),
// causal kpos <= qpos, window kpos > qpos - window, ragged tails. It is
// applied BEFORE the exp: a row that reaches no key has lse = -1e30, and
// exp(t - lse) would overflow; such rows give dq = 0 and add nothing to
// dk/dv.
//
// What bounds them on an H100: at the training shape (S = 512, D = 128)
// the operations per (query, key) pair that the mask admits (q.k and dO.v
// recomputed, then one product with the tile for dq and two for dk/dv),
// not the bytes. S and dP are recomputed in both kernels, which keeps two
// launches with no atomics (the fused backward of FlashAttention-2/3 adds
// dq across CTAs with f32 atomics, whose order changes from run to run):
// 25% more tensor-core work than a fused kernel with the hi + lo split.
//
// Two branches, chosen by the wrapper from dtype and shape alone:
//
// * tensor cores (flash_dq_tc, flash_dkv_tc), for bf16 with D % 16 == 0 and
//   D <= 128 (llama3.2-3b, smollm). Head dims are padded to 64 or 128 in
//   shared memory by TMA's zero fill. Every product is a wgmma m64nNk16
//   with f32 accumulators: S and dP (or their transposes) with both
//   operands K-major in shared memory; the products with the tile with P
//   or g as the register A operand and Q, K or dO as an MN-major B. P and
//   g are f32 in the reference: each is split into bf16 hi + lo and both
//   halves go into the same accumulator (relative error about 2^-17;
//   without lo the outputs leave one bf16 ulp, tests/
//   test_torch_tc_accumulation.py). Products of bf16 inputs are exact, so
//   only the order of the f32 sums differs; wgmma rounds them toward zero,
//   so the accumulators restart into round-to-nearest totals in shared
//   memory every PROMOTE tiles. Only tiles that straddle the causal
//   diagonal, the window edge, Sq or Skv are masked.
//    - dq: one CTA per (128 query rows, head, batch), the last query tiles
//      (the heaviest under causal) first: two consumer warpgroups of 64
//      rows and a producer warpgroup. The producer loads the CTA's Q and dO
//      once by TMA, then streams the K and V tiles of 64 keys through a
//      2-stage ring (full and empty mbarriers), skipping the tiles no row of
//      the CTA can reach. A consumer forms S = Q K^T and dP = dO V^T, p and
//      g on the fragments, and dQ += g K. The producer gives its registers
//      to the consumers (setmaxnreg): at the launch's 168 a thread the
//      consumers spill.
//    - dkv: one CTA per (64 keys, kv head, batch), the first key tiles (the
//      heaviest under causal) first: one consumer warpgroup that holds the
//      keys' K and V (loaded once by TMA) and a producer warp that streams
//      the Q and dO tiles of 64 rows, with their lse and delta, for every
//      reachable query tile of each of the rep query heads of the group in
//      turn, so the group sum folds into the accumulators as in the TPU
//      kernel. The consumer works transposed (rows are its keys) so that
//      P^T and g^T are register A operands: S^T = K Q^T, dP^T = V dO^T,
//      dV += P^T dO, dK += g^T Q. It holds dK and dV (64 + 64 f32 a thread
//      at D = 128) beside S^T and dP^T: 248 registers, no spill. A CTA of
//      128 keys would halve the grid to 128 CTAs at the training shape
//      (4 batches x 8 kv heads x 4 key tiles), under one wave on 132 SMs;
//      64 keys give 256.
// * SIMT (flash_dq, flash_dkv), for f32 inputs and other head dims, the
//   first simple versions:
//    - dq: one block per (q tile of 16 rows, head, batch), 4 warps of 4
//      rows, walking the kv tiles the mask can reach. Lane j takes key j of
//      a 32-key tile: it computes s and dp for the warp's 4 rows; g is
//      broadcast by shuffle and each lane accumulates D/32 columns of dq.
//    - dkv: one block per (kv tile of 32 keys, kv head, batch), 8 warps of 4
//      keys, looping over the q tiles of all rep query heads of the group
//      that the mask can reach. Lane i takes query row i of a 32-row tile:
//      it computes s and dp against the warp's 4 keys; p and g are broadcast
//      by shuffle and each lane accumulates D/32 columns of dk and dv for
//      its warp's keys.
//   Tiles are staged in shared memory as f32 with rows padded to D/4*4 + 4
//   floats, so a warp's float4 reads of 32 different rows spread over all
//   banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int DMAX = 256;
constexpr int DPL = DMAX / 32;       // accumulator columns per lane
constexpr int TILE = 32;             // keys (dq) or query rows (dkv) per tile
constexpr int DQ_WARPS = 4, DQ_ROWS = 4, DQ_BQ = DQ_WARPS * DQ_ROWS;
constexpr int DKV_WARPS = 8, DKV_KEYS = 4, DKV_BK = DKV_WARPS * DKV_KEYS;

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

__host__ __device__ inline int padded_d(int D) { return ((D + 3) & ~3) + 4; }

// Rows [r0, r0 + rows) of head `hh` of a (B, S, nh, D) tensor into a
// (rows x DP) f32 tile, zeros past S and past D.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int b, int r0,
                                      int rows, int S, int nh, int hh, int D,
                                      int DP, int tid, int nthreads) {
  for (int i = tid; i < rows * DP; i += nthreads) {
    const int r = i / DP, d = i % DP, s = r0 + r;
    dst[i] = (s < S && d < D) ? to_f32(src[(((size_t)b * S + s) * nh + hh) * D + d]) : 0.f;
  }
}

__device__ __forceinline__ bool admitted(int row, int kp, int Sq, int Skv, int q_offset,
                                         int causal, int window) {
  const int qpos = row + q_offset;
  return row < Sq && kp < Skv && (!causal || kp <= qpos) &&
         (window <= 0 || kp > qpos - window);
}

// p and g of one (row, key) pair from its raw dot products.
__device__ __forceinline__ void probs(float qk, float dov, float lse, float delta,
                                      bool valid, float scale, float softcap,
                                      float& p, float& g) {
  float t = qk * scale;
  if (softcap > 0.f) t = softcap * tanhf(t / softcap);
  p = valid ? expf(t - lse) : 0.f;
  g = p * (dov - delta);
  if (softcap > 0.f) {
    const float c = t / softcap;
    g *= 1.f - c * c;
  }
}

// ---------------------------------------------------------------------------
// dq

template <typename T>
__global__ void __launch_bounds__(DQ_WARPS * 32)
flash_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv,
         int H, int Hkv, int D, float scale, int causal, int window, float softcap) {
  extern __shared__ __align__(16) float smem[];
  const int DP = padded_d(D);
  float* Qs = smem;                 // DQ_BQ x DP
  float* Os = Qs + DQ_BQ * DP;      // dO rows
  float* Ks = Os + DQ_BQ * DP;      // TILE x DP
  float* Vs = Ks + TILE * DP;

  const int q0 = blockIdx.x * DQ_BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = DQ_WARPS * 32;
  const int q_offset = Skv - Sq;

  stage(Qs, q, b, q0, DQ_BQ, Sq, H, h, D, DP, tid, nthreads);
  stage(Os, dout, b, q0, DQ_BQ, Sq, H, h, D, DP, tid, nthreads);
  float lr[DQ_ROWS], dr[DQ_ROWS];
#pragma unroll
  for (int r = 0; r < DQ_ROWS; ++r) {
    const int row = q0 + warp * DQ_ROWS + r;
    const size_t at = ((size_t)b * H + h) * Sq + row;
    lr[r] = row < Sq ? lse[at] : 0.f;
    dr[r] = row < Sq ? delta[at] : 0.f;
  }

  // kv tiles the block's rows can reach (as the forward).
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(Skv, q0 + DQ_BQ - 1 + q_offset + 1);
  if (window > 0) kv_lo = max(0, q0 + q_offset - window + 1);
  kv_lo = (kv_lo / TILE) * TILE;

  float acc[DQ_ROWS][DPL];
#pragma unroll
  for (int r = 0; r < DQ_ROWS; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += TILE) {
    __syncthreads();  // Qs/Os staged, or the previous tile consumed
    stage(Ks, k, b, k0, TILE, Skv, Hkv, hk, D, DP, tid, nthreads);
    stage(Vs, v, b, k0, TILE, Skv, Hkv, hk, D, DP, tid, nthreads);
    __syncthreads();

    const int kp = k0 + lane;  // this lane's key
    float qk[DQ_ROWS], dov[DQ_ROWS];
#pragma unroll
    for (int r = 0; r < DQ_ROWS; ++r) qk[r] = dov[r] = 0.f;
    const float* krow = Ks + lane * DP;
    const float* vrow = Vs + lane * DP;
    for (int d = 0; d < DP - 4; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
      const float4 vv = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
      for (int r = 0; r < DQ_ROWS; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(Qs + (warp * DQ_ROWS + r) * DP + d);
        const float4 o = *reinterpret_cast<const float4*>(Os + (warp * DQ_ROWS + r) * DP + d);
        qk[r] = fmaf(a.x, kk.x, fmaf(a.y, kk.y, fmaf(a.z, kk.z, fmaf(a.w, kk.w, qk[r]))));
        dov[r] = fmaf(o.x, vv.x, fmaf(o.y, vv.y, fmaf(o.z, vv.z, fmaf(o.w, vv.w, dov[r]))));
      }
    }

#pragma unroll
    for (int r = 0; r < DQ_ROWS; ++r) {
      const int row = q0 + warp * DQ_ROWS + r;
      float p, g;
      probs(qk[r], dov[r], lr[r], dr[r],
            admitted(row, kp, Sq, Skv, q_offset, causal, window), scale, softcap, p, g);
      for (int j = 0; j < TILE; ++j) {
        const float gj = __shfl_sync(0xffffffffu, g, j);
        const float* kj = Ks + j * DP;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[r][i] = fmaf(gj, kj[d], acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < DQ_ROWS; ++r) {
    const int row = q0 + warp * DQ_ROWS + r;
    if (row >= Sq) continue;
    T* out = dq + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[d] = from_f32<T>(acc[r][i] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dk, dv

template <typename T>
__global__ void __launch_bounds__(DKV_WARPS * 32)
flash_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
          int Sq, int Skv, int H, int Hkv, int D, float scale, int causal, int window,
          float softcap) {
  extern __shared__ __align__(16) float smem[];
  const int DP = padded_d(D);
  float* Ks = smem;                 // DKV_BK x DP
  float* Vs = Ks + DKV_BK * DP;
  float* Qs = Vs + DKV_BK * DP;     // TILE x DP
  float* Os = Qs + TILE * DP;
  float* Ls = Os + TILE * DP;       // TILE
  float* Ds = Ls + TILE;            // TILE

  const int k0 = blockIdx.x * DKV_BK, hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = DKV_WARPS * 32;
  const int q_offset = Skv - Sq;

  stage(Ks, k, b, k0, DKV_BK, Skv, Hkv, hk, D, DP, tid, nthreads);
  stage(Vs, v, b, k0, DKV_BK, Skv, Hkv, hk, D, DP, tid, nthreads);

  // query rows that can reach a key of [k0, k1): qpos >= k0 under causal,
  // qpos <= k1 - 2 + window under a window.
  const int k1 = min(Skv, k0 + DKV_BK);
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window > 0) q_hi = min(Sq, k1 - 1 + window - q_offset);
  q_lo = (q_lo / TILE) * TILE;

  float dka[DKV_KEYS][DPL], dva[DKV_KEYS][DPL];
#pragma unroll
  for (int j = 0; j < DKV_KEYS; ++j)
#pragma unroll
    for (int i = 0; i < DPL; ++i) dka[j][i] = dva[j][i] = 0.f;

  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    for (int q0 = q_lo; q0 < q_hi; q0 += TILE) {
      __syncthreads();  // K/V staged, or the previous q tile consumed
      stage(Qs, q, b, q0, TILE, Sq, H, h, D, DP, tid, nthreads);
      stage(Os, dout, b, q0, TILE, Sq, H, h, D, DP, tid, nthreads);
      if (tid < TILE) {
        const int row = q0 + tid;
        const size_t at = ((size_t)b * H + h) * Sq + row;
        Ls[tid] = row < Sq ? lse[at] : 0.f;
        Ds[tid] = row < Sq ? delta[at] : 0.f;
      }
      __syncthreads();

      const int row = q0 + lane;  // this lane's query row
      float qk[DKV_KEYS], dov[DKV_KEYS];
#pragma unroll
      for (int j = 0; j < DKV_KEYS; ++j) qk[j] = dov[j] = 0.f;
      const float* qrow = Qs + lane * DP;
      const float* orow = Os + lane * DP;
      for (int d = 0; d < DP - 4; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qrow + d);
        const float4 o = *reinterpret_cast<const float4*>(orow + d);
#pragma unroll
        for (int j = 0; j < DKV_KEYS; ++j) {
          const float4 kk = *reinterpret_cast<const float4*>(Ks + (warp * DKV_KEYS + j) * DP + d);
          const float4 vv = *reinterpret_cast<const float4*>(Vs + (warp * DKV_KEYS + j) * DP + d);
          qk[j] = fmaf(a.x, kk.x, fmaf(a.y, kk.y, fmaf(a.z, kk.z, fmaf(a.w, kk.w, qk[j]))));
          dov[j] = fmaf(o.x, vv.x, fmaf(o.y, vv.y, fmaf(o.z, vv.z, fmaf(o.w, vv.w, dov[j]))));
        }
      }
      float p[DKV_KEYS], g[DKV_KEYS];
#pragma unroll
      for (int j = 0; j < DKV_KEYS; ++j) {
        const int kp = k0 + warp * DKV_KEYS + j;
        probs(qk[j], dov[j], Ls[lane], Ds[lane],
              admitted(row, kp, Sq, Skv, q_offset, causal, window), scale, softcap,
              p[j], g[j]);
      }
      for (int i = 0; i < TILE; ++i) {
        const float* qi = Qs + i * DP;
        const float* oi = Os + i * DP;
        float qv[DPL], ov[DPL];
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = lane + 32 * c;
          qv[c] = d < D ? qi[d] : 0.f;
          ov[c] = d < D ? oi[d] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < DKV_KEYS; ++j) {
          const float pi = __shfl_sync(0xffffffffu, p[j], i);
          const float gi = __shfl_sync(0xffffffffu, g[j], i);
#pragma unroll
          for (int c = 0; c < DPL; ++c) {
            dva[j][c] = fmaf(pi, ov[c], dva[j][c]);
            dka[j][c] = fmaf(gi, qv[c], dka[j][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < DKV_KEYS; ++j) {
    const int kp = k0 + warp * DKV_KEYS + j;
    if (kp >= Skv) continue;
    const size_t at = (((size_t)b * Skv + kp) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[at + d] = from_f32<T>(dka[j][c] * scale);
        dv[at + d] = from_f32<T>(dva[j][c]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int B, int Sq,
                      int Skv, int H, int Hkv, int D, float scale, int causal,
                      int window, float softcap, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)(2 * DQ_BQ + 2 * TILE) * padded_d(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + DQ_BQ - 1) / DQ_BQ, H, B);
  flash_dq<T><<<grid, DQ_WARPS * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), Sq, Skv, H, Hkv,
      D, scale, causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int B,
                       int Sq, int Skv, int H, int Hkv, int D, float scale, int causal,
                       int window, float softcap, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)(2 * DKV_BK + 2 * TILE) * padded_d(D)
                                       + 2 * TILE);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Skv + DKV_BK - 1) / DKV_BK, Hkv, B);
  flash_dkv<T><<<grid, DKV_WARPS * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Skv, H, Hkv, D, scale, causal, window, softcap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core branch (bf16, D % 16 == 0, D <= 128)

namespace tcb {

constexpr int DMAX = 128;
constexpr int BK = 64;       // keys per tile of dq, per CTA of dkv
constexpr int BR = 64;       // query rows per warpgroup of dq, per tile of dkv
constexpr int STAGES = 2;    // ring depth
// wgmma's f32 sums round toward zero: the accumulators restart every
// PROMOTE tiles of a kernel's loop and are added into round-to-nearest
// totals in shared memory (the interval from
// tests/test_torch_tc_accumulation.py).
constexpr int PROMOTE = 8;

// The bf16 hi + lo split of two f32 values, each half packed as the
// register of an A fragment (hi rounds a to nearest, lo rounds a - hi,
// which is exact in f32).
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d (64 x 64) = A B^T over DP columns: A and B tiles of 64 rows, K-major,
// stored as 64-column chunks of 4096 elements.
template <int DP>
__device__ __forceinline__ void rows_by_rows(float (&d)[32], const __nv_bfloat16* A,
                                             const __nv_bfloat16* B) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int off = (kk / 4) * 4096 + (kk % 4) * 16;
    sm90::wgmma_ss_n64(d, sm90::desc128(A + off, 16, 1024), sm90::desc128(B + off, 16, 1024),
                       1);
  }
}

// d (64 x DP) += A (64 x 16, registers) B (16 x DP, MN-major).
template <int DP>
__device__ __forceinline__ void regs_by_mn(float (&d)[DP / 2], const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (DP == 64)
    sm90::wgmma_rs_n64_mn(d, a, db, 1);
  else
    sm90::wgmma_rs_n128_mn(d, a, db, 1);
}

// A (64 x 64) as register A fragments: the f32 accumulator fragments of
// a 64 x 64 product split into bf16 hi + lo (k16 block kb of A is
// accumulator blocks 2 kb and 2 kb + 1).
struct Split {
  uint32_t hi[4][4], lo[4][4];
};

__device__ __forceinline__ void split(const float (&x)[32], Split& a) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split2(x[8 * kb + 2 * r], x[8 * kb + 2 * r + 1], a.hi[kb][r], a.lo[kb][r]);
}

// d += A_hi B + A_lo B, B 64 rows along the contraction, MN-major, from `Bt`
// (64-column chunks of 64 rows). A warpgroup splits every fragment of the
// products it starts before a wait first: the A registers of a product in
// flight must not be rewritten.
template <int DP>
__device__ __forceinline__ void split_by_mn(float (&d)[DP / 2], const Split& a,
                                            const __nv_bfloat16* Bt) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const uint64_t db = sm90::desc128(Bt + kb * 16 * 64, 64 * 128, 1024);
    regs_by_mn<DP>(d, a.hi[kb], db);
    regs_by_mn<DP>(d, a.lo[kb], db);
  }
}

// tot[i * 128 + t] += acc[i] (round to nearest); acc restarts at 0.
template <int N>
__device__ __forceinline__ void promote(float (&acc)[N], float* tot, int t) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    tot[i * 128 + t] = __fadd_rn(tot[i * 128 + t], acc[i]);
    acc[i] = 0.f;
  }
}

// tot + acc, times `scale`, for the thread's accumulator fragments of one
// 64-row warpgroup tile: rows `r0` and r0 + 8, columns 8 jb + 2 tig + {0, 1},
// into `out` (rows of `ld` elements, `rows` of them, D columns).
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2], const float* tot, int t,
                                           float scale, __nv_bfloat16* out, size_t ld,
                                           int r0, int rows, int D) {
  const int tig = t % 4;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + 8 * rr;
    if (row >= rows) continue;
    __nv_bfloat16* o = out + (size_t)row * ld;
#pragma unroll
    for (int jb = 0; jb < DP / 8; ++jb) {
      const int col = 8 * jb + 2 * tig, i = 4 * jb + 2 * rr;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(
            __fmul_rn(__fadd_rn(tot[i * 128 + t], acc[i]), scale),
            __fmul_rn(__fadd_rn(tot[(i + 1) * 128 + t], acc[i + 1]), scale));
    }
  }
}

template <int DP>            // D rounded up to a multiple of 64
struct DqCfg {
  static constexpr int NWG = 2;                   // consumer warpgroups
  static constexpr int BQ = BR * NWG;             // query rows per CTA
  static constexpr int CH = DP / 64;              // 64-column chunks
  // + a producer warpgroup, one thread of which starts the loads: with
  // setmaxnreg it gives its registers to the consumers (the launch holds
  // 384 x 168; 128 x 40 + 256 x 232 is the same), which spill at 168
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  static constexpr int Q_ELEMS = BQ * DP;         // the CTA's Q, and its dO
  static constexpr int KV_ELEMS = BK * DP;        // one K or V tile
  static constexpr int ACC = DP / 2;              // dq accumulators a thread
  static constexpr size_t SMEM = 1024 + 2 * (2 * (size_t)Q_ELEMS + 2 * STAGES * KV_ELEMS) +
                                 4 * (size_t)NWG * 128 * ACC + 8 * (1 + 2 * STAGES);
};

template <int DP>
__global__ void __launch_bounds__(DqCfg<DP>::THREADS, 1)
flash_dq_tc(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dq, int B, int Sq, int Skv, int H, int Hkv, int D,
            float scale, int causal, int window, float softcap) {
  using C = DqCfg<DP>;
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* Qs = sm90::align1024<__nv_bfloat16>(smem_raw);
  __nv_bfloat16* Os = Qs + C::Q_ELEMS;
  __nv_bfloat16* Ks = Os + C::Q_ELEMS;
  __nv_bfloat16* Vs = Ks + STAGES * C::KV_ELEMS;
  float* tot = reinterpret_cast<float*>(Vs + STAGES * C::KV_ELEMS);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(tot + C::NWG * 128 * C::ACC);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  // Under causal the last query tiles reach the most keys: they go first.
  const int nq = (Sq + C::BQ - 1) / C::BQ;
  const int tile = blockIdx.x / (H * B), hb = blockIdx.x % (H * B);
  const int h = hb % H, b = hb / H;
  const int q0 = (causal ? nq - 1 - tile : tile) * C::BQ;
  const int hk = h / (H / Hkv);
  const int q_offset = Skv - Sq;
  // kv tiles some row of the CTA can reach
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(Skv, q0 + C::BQ + q_offset);
  if (window > 0) kv_lo = max(0, q0 + q_offset - window + 1);
  kv_lo = (kv_lo / BK) * BK;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    sm90::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], C::NWG * 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == C::NWG) {
    sm90::regs_dec<C::PRODUCER_REGS>();
    // The producer: one thread loads Q and dO once, then streams the K and
    // V tiles.
    if (tid == C::NWG * 128) {
      sm90::mbar_arrive_expect_tx(qbar, 2 * 2 * C::Q_ELEMS);
      for (int w = 0; w < C::NWG; ++w)
        for (int c = 0; c < C::CH; ++c) {
          sm90::tma_load_4d(Qs + (w * C::CH + c) * 4096, &qmap, qbar, c * 64, h,
                            q0 + w * BR, b);
          sm90::tma_load_4d(Os + (w * C::CH + c) * 4096, &omap, qbar, c * 64, h,
                            q0 + w * BR, b);
        }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        sm90::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 4 * C::KV_ELEMS);
        const int k0 = kv_lo + j * BK;
        for (int c = 0; c < C::CH; ++c) {
          sm90::tma_load_4d(Ks + s * C::KV_ELEMS + c * BK * 64, &kmap, &full[s], c * 64, hk,
                            k0, b);
          sm90::tma_load_4d(Vs + s * C::KV_ELEMS + c * BK * 64, &vmap, &full[s], c * 64, hk,
                            k0, b);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: 64 query rows; this thread holds rows r0 and
  // r0 + 8, columns 8 j + 2 tig + {0, 1} of each 8-column block j.
  sm90::regs_inc<C::CONSUMER_REGS>();
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int tig = lane % 4;
  const int r0 = q0 + wg * BR + warp * 16 + lane / 4;
  float lr[2], dr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + 8 * rr;
    const size_t at = ((size_t)b * H + h) * Sq + row;
    lr[rr] = row < Sq ? lse[at] : 0.f;
    dr[rr] = row < Sq ? delta[at] : 0.f;
  }
  const int wg_qmin = q0 + wg * BR + q_offset, wg_qmax = wg_qmin + BR - 1;
  const __nv_bfloat16* Qw = Qs + wg * C::CH * 4096;
  const __nv_bfloat16* Ow = Os + wg * C::CH * 4096;
  float* totw = tot + wg * 128 * C::ACC;
  float acc[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) {
    acc[i] = 0.f;
    totw[i * 128 + t] = 0.f;
  }

  sm90::mbar_wait(qbar, 0);
  int done = 0;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int k0 = kv_lo + j * BK;
    sm90::mbar_wait(&full[s], (j / STAGES) & 1);
    const bool reach = !(causal && k0 > wg_qmax) &&
                       !(window > 0 && k0 + BK - 1 <= wg_qmin - window);
    if (reach) {
      const __nv_bfloat16* Kt = Ks + s * C::KV_ELEMS;
      const __nv_bfloat16* Vt = Vs + s * C::KV_ELEMS;
      float sacc[32], gacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = gacc[i] = 0.f;
      sm90::fence_regs(sacc);
      sm90::fence_regs(gacc);
      sm90::wgmma_fence();
      rows_by_rows<DP>(sacc, Qw, Kt);   // S = Q K^T
      rows_by_rows<DP>(gacc, Ow, Vt);   // dP = dO V^T
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sacc);
      sm90::fence_regs(gacc);

      // p and g on the fragments; only tiles that straddle an edge are masked
      const bool inner = k0 + BK <= Skv && (!causal || k0 + BK - 1 <= wg_qmin) &&
                         (window <= 0 || k0 > wg_qmax - window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int rr = (i >> 1) & 1;
        const int kp = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
        const bool valid =
            inner || admitted(r0 + 8 * rr, kp, Sq, Skv, q_offset, causal, window);
        float p;
        probs(sacc[i], gacc[i], lr[rr], dr[rr], valid, scale, softcap, p, gacc[i]);
      }
      // dQ += g K, K as the MN-major B (the keys along the contraction)
      Split ga;
      split(gacc, ga);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
      split_by_mn<DP>(acc, ga, Kt);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (++done % PROMOTE == 0) promote(acc, totw, t);
    }
    sm90::mbar_arrive(&empty[s]);
  }
  store_rows<DP>(acc, totw, t, scale, dq + ((size_t)b * Sq * H + h) * D, (size_t)H * D, r0,
                 Sq, D);
}

template <int DP>
struct DkvCfg {
  static constexpr int CH = DP / 64;
  static constexpr int THREADS = 128 + 32;        // one consumer warpgroup + the producer warp
  static constexpr int KV_ELEMS = BK * DP;        // the CTA's K, and its V
  static constexpr int R_ELEMS = BR * DP;         // one Q or dO tile
  static constexpr int ACC = DP / 2;              // dk and dv accumulators a thread, each
  static constexpr size_t SMEM = 1024 + 2 * (2 * (size_t)KV_ELEMS + 2 * STAGES * R_ELEMS) +
                                 4 * (2 * 128 * (size_t)ACC + 2 * STAGES * BR) +
                                 8 * (1 + 2 * STAGES);
};

template <int DP>
__global__ void __launch_bounds__(DkvCfg<DP>::THREADS, 1)
flash_dkv_tc(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B, int Sq,
             int Skv, int H, int Hkv, int D, float scale, int causal, int window,
             float softcap) {
  using C = DkvCfg<DP>;
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* Ks = sm90::align1024<__nv_bfloat16>(smem_raw);
  __nv_bfloat16* Vs = Ks + C::KV_ELEMS;
  __nv_bfloat16* Qr = Vs + C::KV_ELEMS;           // ring of Q tiles
  __nv_bfloat16* Or = Qr + STAGES * C::R_ELEMS;   // ring of dO tiles
  float* totk = reinterpret_cast<float*>(Or + STAGES * C::R_ELEMS);
  float* totv = totk + 128 * C::ACC;
  float* Ls = totv + 128 * C::ACC;                // the tiles' lse and delta
  float* Ds = Ls + STAGES * BR;
  uint64_t* kbar = reinterpret_cast<uint64_t*>(Ds + STAGES * BR);
  uint64_t* full = kbar + 1;
  uint64_t* empty = full + STAGES;

  // Under causal the first keys are reached by the most rows: they go first.
  const int tile = blockIdx.x / (Hkv * B), hb = blockIdx.x % (Hkv * B);
  const int hk = hb % Hkv, b = hb / Hkv;
  const int k0 = tile * BK, k1 = min(Skv, k0 + BK);
  const int rep = H / Hkv, q_offset = Skv - Sq;
  // query rows that can reach a key of [k0, k1)
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window > 0) q_hi = min(Sq, k1 - 1 + window - q_offset);
  q_lo = (q_lo / BR) * BR;
  const int nqt = q_hi > q_lo ? (q_hi - q_lo + BR - 1) / BR : 0;
  const int n_tiles = rep * nqt;                  // head-major, as the TPU kernel

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    sm90::mbar_init(kbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 32);              // the producer warp's lanes
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 1) {
    // The producer warp: lane 0 loads K and V once, then every tile's Q and
    // dO; the lanes stage the tile's lse and delta.
    const int lane = tid % 32;
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(kbar, 2 * 2 * C::KV_ELEMS);
      for (int c = 0; c < C::CH; ++c) {
        sm90::tma_load_4d(Ks + c * BK * 64, &kmap, kbar, c * 64, hk, k0, b);
        sm90::tma_load_4d(Vs + c * BK * 64, &vmap, kbar, c * 64, hk, k0, b);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES, h = hk * rep + j / nqt, q0 = q_lo + (j % nqt) * BR;
      sm90::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      for (int e = lane; e < BR; e += 32) {
        const int row = q0 + e;
        const size_t at = ((size_t)b * H + h) * Sq + row;
        Ls[s * BR + e] = row < Sq ? lse[at] : 0.f;
        Ds[s * BR + e] = row < Sq ? delta[at] : 0.f;
      }
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&full[s], 2 * 2 * C::R_ELEMS);
        for (int c = 0; c < C::CH; ++c) {
          sm90::tma_load_4d(Qr + s * C::R_ELEMS + c * BR * 64, &qmap, &full[s], c * 64, h,
                            q0, b);
          sm90::tma_load_4d(Or + s * C::R_ELEMS + c * BR * 64, &omap, &full[s], c * 64, h,
                            q0, b);
        }
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // The consumer warpgroup, in the transposed frame: accumulator rows are
  // the CTA's keys (this thread: kr and kr + 8), columns a tile's query rows
  // (8 j + 2 tig + {0, 1}), so P^T and g^T are register A operands.
  const int t = tid, warp = t / 32, lane = t % 32;
  const int tig = lane % 4;
  const int kr = k0 + warp * 16 + lane / 4;
  float dka[C::ACC], dva[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) {
    dka[i] = dva[i] = 0.f;
    totk[i * 128 + t] = totv[i * 128 + t] = 0.f;
  }

  sm90::mbar_wait(kbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES, q0 = q_lo + (j % nqt) * BR;
    sm90::mbar_wait(&full[s], (j / STAGES) & 1);
    const __nv_bfloat16* Qt = Qr + s * C::R_ELEMS;
    const __nv_bfloat16* Ot = Or + s * C::R_ELEMS;
    float pt[32], gt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) pt[i] = gt[i] = 0.f;
    sm90::fence_regs(pt);
    sm90::fence_regs(gt);
    sm90::wgmma_fence();
    rows_by_rows<DP>(pt, Ks, Qt);   // S^T = K Q^T
    rows_by_rows<DP>(gt, Vs, Ot);   // dP^T = V dO^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(pt);
    sm90::fence_regs(gt);

    const bool inner = q0 + BR <= Sq && k0 + BK <= Skv &&
                       (!causal || k0 + BK - 1 <= q0 + q_offset) &&
                       (window <= 0 || k0 > q0 + BR - 1 + q_offset - window);
    const float* L = Ls + s * BR;
    const float* Dl = Ds + s * BR;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + 2 * tig + (i & 1);
      const bool valid = inner || admitted(q0 + col, kr + 8 * ((i >> 1) & 1), Sq, Skv,
                                           q_offset, causal, window);
      probs(pt[i], gt[i], L[col], Dl[col], valid, scale, softcap, pt[i], gt[i]);
    }
    // dV += P^T dO and dK += g^T Q, dO and Q as MN-major B operands
    Split pa, ga;
    split(pt, pa);
    split(gt, ga);
    sm90::fence_regs(dka);
    sm90::fence_regs(dva);
    sm90::wgmma_fence();
    split_by_mn<DP>(dva, pa, Ot);
    split_by_mn<DP>(dka, ga, Qt);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dka);
    sm90::fence_regs(dva);
    sm90::mbar_arrive(&empty[s]);
    if ((j + 1) % PROMOTE == 0) {
      promote(dka, totk, t);
      promote(dva, totv, t);
    }
  }
  const size_t ld = (size_t)Hkv * D, base = (size_t)b * Skv * Hkv * D + (size_t)hk * D;
  store_rows<DP>(dka, totk, t, scale, dk + base, ld, kr, Skv, D);
  store_rows<DP>(dva, totv, t, 1.f, dv + base, ld, kr, Skv, D);
}

// (B, S, heads, D) bf16 as a 4-D map, innermost first; boxes of 64 columns
// of one head and 64 rows.
bool map4(CUtensorMap* map, const void* base, int S, int heads, int D, int B) {
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {D * e, (cuuint64_t)heads * D * e,
                                 (cuuint64_t)S * heads * D * e};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return sm90::bf16_map(map, base, 4, dims, strides, box);
}

bool maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v, const void* dout,
          int B, int Sq, int Skv, int H, int Hkv, int D) {
  return map4(&m[0], q, Sq, H, D, B) && map4(&m[1], k, Skv, Hkv, D, B) &&
         map4(&m[2], v, Skv, Hkv, D, B) && map4(&m[3], dout, Sq, H, D, B);
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int B, int Sq, int Skv,
                      int H, int Hkv, int D, float scale, int causal, int window,
                      float softcap, cudaStream_t st) {
  using C = DqCfg<DP>;
  CUtensorMap m[4];
  if (!maps(m, q, k, v, dout, B, Sq, Skv, H, Hkv, D)) return cudaErrorInvalidValue;
  const cudaError_t err = sm90::allow_smem<flash_dq_tc<DP>>(C::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((Sq + C::BQ - 1) / C::BQ) * H * B;
  flash_dq_tc<DP><<<grid, C::THREADS, C::SMEM, st>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dq), B, Sq, Skv, H,
      Hkv, D, scale, causal, window, softcap);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int B, int Sq,
                       int Skv, int H, int Hkv, int D, float scale, int causal, int window,
                       float softcap, cudaStream_t st) {
  using C = DkvCfg<DP>;
  CUtensorMap m[4];
  if (!maps(m, q, k, v, dout, B, Sq, Skv, H, Hkv, D)) return cudaErrorInvalidValue;
  const cudaError_t err = sm90::allow_smem<flash_dkv_tc<DP>>(C::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((Skv + BK - 1) / BK) * Hkv * B;
  flash_dkv_tc<DP><<<grid, C::THREADS, C::SMEM, st>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, Sq, Skv, H, Hkv, D, scale, causal, window,
      softcap);
  return cudaGetLastError();
}

bool takes(int D, int Sq, int Skv, int H, int Hkv) {
  return D > 0 && D <= DMAX && D % 16 == 0 && Sq > 0 && Skv > 0 && Hkv > 0 && H % Hkv == 0;
}

}  // namespace tcb

bool bad_shape(int D, int H, int Hkv) {
  return D <= 0 || D > DMAX || Hkv <= 0 || H % Hkv != 0;
}

}  // namespace

extern "C" {

// dtype code: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs share
// it). lse and delta are (B, H, Sq) f32. Both return cudaGetLastError().

int flash_attention_dq_launch(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, const void* delta,
                              void* dq, int dtype, int B, int Sq, int Skv, int H,
                              int Hkv, int D, float scale, int causal, int window,
                              float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaGetLastError();
  if (bad_shape(D, H, Hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  cudaError_t err =
      dtype == 1 ? launch_dq<__nv_bfloat16>(q, k, v, dout, lp, dp, dq, B, Sq, Skv, H, Hkv,
                                            D, scale, causal, window, softcap, st)
                 : launch_dq<float>(q, k, v, dout, lp, dp, dq, B, Sq, Skv, H, Hkv, D,
                                    scale, causal, window, softcap, st);
  return (int)err;
}

int flash_attention_dkv_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta,
                               void* dk, void* dv, int dtype, int B, int Sq, int Skv,
                               int H, int Hkv, int D, float scale, int causal,
                               int window, float softcap, void* stream) {
  if (B <= 0 || Skv <= 0 || Hkv <= 0) return (int)cudaGetLastError();
  if (bad_shape(D, H, Hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  cudaError_t err =
      dtype == 1 ? launch_dkv<__nv_bfloat16>(q, k, v, dout, lp, dp, dk, dv, B, Sq, Skv,
                                             H, Hkv, D, scale, causal, window, softcap, st)
                 : launch_dkv<float>(q, k, v, dout, lp, dp, dk, dv, B, Sq, Skv, H, Hkv, D,
                                     scale, causal, window, softcap, st);
  return (int)err;
}

// The tensor-core branch: bf16 q, k, v, dO and outputs, D % 16 == 0,
// D <= 128, Sq >= 1, Skv >= 1, every base address 16-byte aligned. lse and
// delta as above. Return cudaGetLastError(), or cudaErrorInvalidValue for a
// shape they do not take or a tensor map that cuTensorMapEncodeTiled
// refuses.

int flash_attention_dq_tc_launch(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int B, int Sq, int Skv, int H, int Hkv, int D,
                                 float scale, int causal, int window, float softcap,
                                 void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaGetLastError();
  if (!tcb::takes(D, Sq, Skv, H, Hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  cudaError_t err =
      D <= 64 ? tcb::launch_dq<64>(q, k, v, dout, lp, dp, dq, B, Sq, Skv, H, Hkv, D, scale,
                                   causal, window, softcap, st)
              : tcb::launch_dq<128>(q, k, v, dout, lp, dp, dq, B, Sq, Skv, H, Hkv, D, scale,
                                    causal, window, softcap, st);
  return (int)err;
}

int flash_attention_dkv_tc_launch(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int Sq, int Skv, int H, int Hkv,
                                  int D, float scale, int causal, int window, float softcap,
                                  void* stream) {
  if (B <= 0 || Skv <= 0 || Hkv <= 0) return (int)cudaGetLastError();
  if (!tcb::takes(D, Sq, Skv, H, Hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  cudaError_t err =
      D <= 64 ? tcb::launch_dkv<64>(q, k, v, dout, lp, dp, dk, dv, B, Sq, Skv, H, Hkv, D,
                                    scale, causal, window, softcap, st)
              : tcb::launch_dkv<128>(q, k, v, dout, lp, dp, dk, dv, B, Sq, Skv, H, Hkv, D,
                                     scale, causal, window, softcap, st);
  return (int)err;
}

}  // extern "C"

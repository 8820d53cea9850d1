// Flash attention forward (online softmax) for Hopper.
//
// Replaces the TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (reached through `flash_attention`,
// its pallas_call, with or without `return_lse`). q is (B, Sq, H, D), k and
// v are (B, Skv, Hkv, D), all contiguous, bf16 or f32; o is (B, Sq, H, D)
// in q's dtype and the optional lse is (B, H, Sq) f32. Contract, as the
// TPU kernel's:
//  * GQA: query head h reads kv head h / (H / Hkv);
//  * queries are end-aligned: q_offset = Skv - Sq, qpos = row + q_offset;
//  * causal keeps kpos <= qpos; window > 0 keeps kpos > qpos - window;
//  * softcap > 0 caps the scaled logits: softcap * tanh(s / softcap);
//  * any Sq, Skv; D <= 256;
//  * a row that no key reaches is 0 with lse = -1e30.
// Everything is computed in f32.
//
// What bounds it on an H100: for the serving prefill (S in the hundreds,
// D = 128) the q/k/v/o bytes are small and the 4*D operations per
// (query, key) pair dominate, so operations; at long S it stays so.
// The (Sq x Skv) logits never leave the SM: one block per (q tile of 16
// rows, head, batch) walks the kv tiles that the causal/window mask can
// reach (the rest are skipped), with the running max m, sum l and the
// output accumulator in registers.
//
// Two branches, chosen by the wrapper from dtype and shape alone:
//
// * tensor cores (flash_fwd_tc), for bf16 q/k/v with D % 16 == 0 (every
//   model of the registry: D = 64, 128, 256). One CTA per (64 * NWG query
//   rows, head, batch): NWG consumer warpgroups of 64 rows each (2 for
//   D <= 128, 1 above, for registers) and one producer warp. The producer
//   loads the CTA's Q once by TMA, then streams the K and V tiles of 64
//   keys through a 2-stage ring in shared memory (TMA, 128-byte swizzle,
//   one full and one empty mbarrier per stage), skipping the tiles no row
//   of the CTA can reach. Each consumer computes S = Q K^T with wgmma
//   m64n64k16 (Q and K both K-major in shared memory), runs the online
//   softmax on the accumulator fragments in registers (masking only tiles
//   that straddle the causal diagonal, the window edge or Skv), and
//   accumulates P V with wgmma, P as the register A operand and V as an
//   MN-major B operand. The reference takes P V in f32; to stay within
//   one bf16 ulp of it, P is split into bf16 P_hi + P_lo and both are
//   multiplied into the same f32 accumulator (relative error about 2^-17,
//   1.5x the MMA work of one bf16 P V). Q K^T of bf16 inputs has exact
//   products, so only the order of the f32 sums differs. Head dims are
//   padded to a multiple of 64 in shared memory by TMA's zero fill.
// * SIMT (flash_fwd), for f32 inputs and for bf16 with D % 16 != 0: 4
//   warps, 4 query rows per warp. A kv tile of 32 keys is staged in shared
//   memory as f32; lane j computes the logit of key j for the warp's 4
//   rows, the row max and sum are warp shuffles, and each lane owns D/32
//   output columns of the accumulator, to which every key's probability
//   is broadcast by shuffle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = 4;              // query rows per warp
constexpr int BQ = WARPS * ROWS;     // query rows per block
constexpr int BKV = 32;              // keys per tile (one per lane)
constexpr int DMAX = 256;
constexpr int DPL = DMAX / 32;       // accumulator columns per lane
constexpr float NEG_INF_OUT = -1e30f;

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
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory: Qs (BQ x DP), Ks (BKV x DP), Vs (BKV x D), f32. DP is D
// rounded up to 4 plus 4: float4 reads of a K row by 32 lanes then spread
// over all banks, and the zero tail adds nothing to a dot product.
__host__ __device__ inline int padded_d(int D) { return ((D + 3) & ~3) + 4; }

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          int Sq, int Skv, int H, int Hkv, int D, float scale, int causal,
          int window, float softcap) {
  extern __shared__ __align__(16) float smem[];
  const int DP = padded_d(D);
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BKV * DP;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_offset = Skv - Sq;

  for (int i = tid; i < BQ * DP; i += WARPS * 32) {
    const int r = i / DP, d = i % DP, s = q0 + r;
    Qs[i] = (s < Sq && d < D) ? to_f32(q[(((size_t)b * Sq + s) * H + h) * D + d]) : 0.f;
  }

  // kv tiles the block's rows can reach.
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(Skv, q0 + BQ - 1 + q_offset + 1);
  if (window > 0) kv_lo = max(0, q0 + q_offset - window + 1);
  kv_lo = (kv_lo / BKV) * BKV;

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BKV) {
    __syncthreads();  // Qs written / previous tile consumed
    for (int i = tid; i < BKV * DP; i += WARPS * 32) {
      const int j = i / DP, d = i % DP, kp = k0 + j;
      Ks[i] = (kp < Skv && d < D) ? to_f32(k[(((size_t)b * Skv + kp) * Hkv + hk) * D + d]) : 0.f;
    }
    for (int i = tid; i < BKV * D; i += WARPS * 32) {
      const int j = i / D, d = i % D, kp = k0 + j;
      Vs[i] = (kp < Skv) ? to_f32(v[(((size_t)b * Skv + kp) * Hkv + hk) * D + d]) : 0.f;
    }
    __syncthreads();

    const int kp = k0 + lane;  // this lane's key
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * DP;
    for (int d = 0; d < DP - 4; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(Qs + (warp * ROWS + r) * DP + d);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = q0 + warp * ROWS + r;
      const int qpos = row + q_offset;
      float x = s[r] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const bool valid = row < Sq && kp < Skv && (!causal || kp <= qpos) &&
                         (window <= 0 || kp > qpos - window);
      const float m_new = fmaxf(m[r], warp_max(valid ? x : -INFINITY));
      if (m_new == -INFINITY) continue;  // no key of this row seen yet (warp-uniform)
      const float p = valid ? expf(x - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);  // m = -inf gives 0
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      for (int j = 0; j < BKV; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vrow = Vs + j * D;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[r][i] = fmaf(pj, vrow[d], acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + warp * ROWS + r;
    if (row >= Sq) continue;
    const bool dead = m[r] == -INFINITY;
    const float inv = dead ? 0.f : 1.f / l[r];
    T* orow = o + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = from_f32<T>(dead ? 0.f : acc[r][i] * inv);
    }
    if (lse != nullptr && lane == 0)
      lse[((size_t)b * H + h) * Sq + row] = dead ? NEG_INF_OUT : m[r] + logf(l[r]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Skv, int H, int Hkv, int D,
                   float scale, int causal, int window, float softcap,
                   cudaStream_t stream) {
  const int DP = padded_d(D);
  const size_t smem = sizeof(float) * ((size_t)(BQ + BKV) * DP + (size_t)BKV * D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Skv, H, Hkv, D, scale, causal, window, softcap);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The tensor-core branch (bf16, D % 16 == 0, D <= 256)

namespace tc {

constexpr int BKV = 64;      // keys per tile
constexpr int STAGES = 2;    // K/V ring depth

template <int DP>            // D rounded up to a multiple of 64
struct Cfg {
  static constexpr int NWG = DP <= 128 ? 2 : 1;  // consumer warpgroups
  static constexpr int BQ = 64 * NWG;            // query rows per CTA
  static constexpr int CH = DP / 64;             // 64-column chunks
  static constexpr int THREADS = NWG * 128 + 32; // + the producer warp
  static constexpr int Q_ELEMS = BQ * DP;
  static constexpr int KV_ELEMS = BKV * DP;      // one K or V tile
  static constexpr size_t SMEM = 1024 + 2 * ((size_t)Q_ELEMS + 2 * STAGES * KV_ELEMS) +
                                 8 * (1 + 2 * STAGES);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::THREADS, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
             float* __restrict__ lse, int Sq, int Skv, int H, int Hkv, int D,
             float scale, int causal, int window, float softcap) {
  using C = Cfg<DP>;
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* Ks = Qs + C::Q_ELEMS;
  __nv_bfloat16* Vs = Ks + STAGES * C::KV_ELEMS;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + STAGES * C::KV_ELEMS);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  const int q0 = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q_offset = Skv - Sq;
  // kv tiles some row of the CTA can reach
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(Skv, q0 + C::BQ + q_offset);
  if (window > 0) kv_lo = max(0, q0 + q_offset - window + 1);
  kv_lo = (kv_lo / BKV) * BKV;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BKV - 1) / BKV : 0;

  // the warpgroup index through a shuffle, so the compiler sees that it is
  // warp-uniform (else it serialises the wgmma of a divergent-looking path)
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
    // The producer warp: one thread issues every TMA load.
    if (tid == C::NWG * 128) {
      sm90::mbar_arrive_expect_tx(qbar, 2 * C::Q_ELEMS);
      for (int w = 0; w < C::NWG; ++w)
        for (int c = 0; c < C::CH; ++c)
          sm90::tma_load_4d(Qs + (w * C::CH + c) * 4096, &qmap, qbar, c * 64, h,
                            q0 + w * 64, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        sm90::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 4 * C::KV_ELEMS);
        const int k0 = kv_lo + j * BKV;
        for (int c = 0; c < C::CH; ++c) {
          sm90::tma_load_4d(Ks + s * C::KV_ELEMS + c * BKV * 64, &kmap, &full[s],
                            c * 64, hk, k0, b);
          sm90::tma_load_4d(Vs + s * C::KV_ELEMS + c * BKV * 64, &vmap, &full[s],
                            c * 64, hk, k0, b);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: 64 query rows. This thread holds rows r0 and
  // r0 + 8 of its warp's 16, columns 8 * j + 2 * tig + {0, 1} of each
  // 8-column block j of an accumulator (the wgmma fragment layout).
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tig = lane % 4;
  const int r0 = q0 + wg * 64 + warp * 16 + g;
  const int qpos[2] = {r0 + q_offset, r0 + 8 + q_offset};
  const int wg_qmin = q0 + wg * 64 + q_offset, wg_qmax = wg_qmin + 63;
  const __nv_bfloat16* Qw = Qs + wg * C::CH * 4096;

  float oacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  sm90::mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int k0 = kv_lo + j * BKV;
    sm90::mbar_wait(&full[s], (j / STAGES) & 1);
    const bool reach = !(causal && k0 > wg_qmax) &&
                       !(window > 0 && k0 + BKV - 1 <= wg_qmin - window);
    if (reach) {
      const __nv_bfloat16* Kt = Ks + s * C::KV_ELEMS;
      const __nv_bfloat16* Vt = Vs + s * C::KV_ELEMS;
      float sacc[BKV / 2];
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) sacc[i] = 0.f;
      sm90::fence_regs(sacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int c = kk / 4, sub = (kk % 4) * 16;
        sm90::wgmma_ss_n64(sacc, sm90::desc128(Qw + c * 4096 + sub, 16, 1024),
                           sm90::desc128(Kt + c * BKV * 64 + sub, 16, 1024), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sacc);

      // scale, softcap and mask; only tiles that straddle an edge are masked
      const bool inner = k0 + BKV <= Skv && (!causal || k0 + BKV - 1 <= wg_qmin) &&
                         (window <= 0 || k0 > wg_qmax - window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int rr = (i >> 1) & 1;
        float x = sacc[i] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (!inner) {
          const int kp = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
          const bool valid = kp < Skv && (!causal || kp <= qpos[rr]) &&
                             (window <= 0 || kp > qpos[rr] - window);
          if (!valid) x = -INFINITY;
        }
        sacc[i] = x;
        mx[rr] = fmaxf(mx[rr], x);
      }
      float alpha[2], mu[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        const float m_new = fmaxf(m[rr], mx[rr]);
        mu[rr] = m_new == -INFINITY ? 0.f : m_new;   // no key of the row yet
        alpha[rr] = expf(m[rr] - mu[rr]);            // m = -inf gives 0
        m[rr] = m_new;
        l[rr] *= alpha[rr];
      }
      // P = exp(S - m), split into bf16 hi + lo A fragments: k16 block kb
      // of P is accumulator blocks 2 kb and 2 kb + 1.
      uint32_t phi[BKV / 16][4], plo[BKV / 16][4];
#pragma unroll
      for (int kb = 0; kb < BKV / 16; ++kb) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kb + 2 * r, rr = r & 1;
          const float p0 = expf(sacc[i] - mu[rr]), p1 = expf(sacc[i + 1] - mu[rr]);
          l[rr] += p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          phi[kb][r] = *reinterpret_cast<const uint32_t*>(&hi);
          plo[kb][r] = pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
        }
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
      sm90::fence_regs(oacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < BKV / 16; ++kb) {
        const uint64_t dv = sm90::desc128(Vt + kb * 16 * 64, BKV * 128, 1024);
        if constexpr (DP == 64) {
          sm90::wgmma_rs_n64_mn(oacc, phi[kb], dv, 1);
          sm90::wgmma_rs_n64_mn(oacc, plo[kb], dv, 1);
        } else if constexpr (DP == 128) {
          sm90::wgmma_rs_n128_mn(oacc, phi[kb], dv, 1);
          sm90::wgmma_rs_n128_mn(oacc, plo[kb], dv, 1);
        } else if constexpr (DP == 192) {
          sm90::wgmma_rs_n192_mn(oacc, phi[kb], dv, 1);
          sm90::wgmma_rs_n192_mn(oacc, plo[kb], dv, 1);
        } else {
          sm90::wgmma_rs_n256_mn(oacc, phi[kb], dv, 1);
          sm90::wgmma_rs_n256_mn(oacc, plo[kb], dv, 1);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(oacc);
    }
    sm90::mbar_arrive(&empty[s]);
  }

  // the row sums of the thread's quad, then o = acc / l and lse
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + 8 * rr;
    if (row >= Sq) continue;
    const bool dead = m[rr] == -INFINITY;
    const float inv = dead ? 0.f : 1.f / l[rr];
    __nv_bfloat16* orow = o + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int jb = 0; jb < DP / 8; ++jb) {
      const int col = 8 * jb + 2 * tig;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            oacc[4 * jb + 2 * rr] * inv, oacc[4 * jb + 2 * rr + 1] * inv);
    }
    if (lse != nullptr && tig == 0)
      lse[((size_t)b * H + h) * Sq + row] = dead ? NEG_INF_OUT : m[rr] + logf(l[rr]);
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int Sq, int Skv, int H, int Hkv, int D, float scale,
                   int causal, int window, float softcap, cudaStream_t stream) {
  using C = Cfg<DP>;
  // (B, S, heads, D) bf16 as 4-D maps, innermost first; boxes of 64
  // columns of one head: 64 query rows for Q, BKV keys for K and V.
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t qd[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t qs[3] = {D * e, (cuuint64_t)H * D * e, (cuuint64_t)Sq * H * D * e};
  const cuuint64_t kd[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t ks[3] = {D * e, (cuuint64_t)Hkv * D * e,
                            (cuuint64_t)Skv * Hkv * D * e};
  const cuuint32_t qb[4] = {64, 1, 64, 1}, kb[4] = {64, 1, BKV, 1};
  CUtensorMap qm, km, vm;
  if (!sm90::bf16_map(&qm, q, 4, qd, qs, qb) || !sm90::bf16_map(&km, k, 4, kd, ks, kb) ||
      !sm90::bf16_map(&vm, v, 4, kd, ks, kb))
    return cudaErrorInvalidValue;
  const cudaError_t err = sm90::allow_smem<flash_fwd_tc<DP>>(C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + C::BQ - 1) / C::BQ, H, B);
  flash_fwd_tc<DP><<<grid, C::THREADS, C::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, H, Hkv, D, scale,
      causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype code: 0 = float32, 1 = bfloat16 (q, k, v and o share it). `lse` may
// be null. Returns cudaGetLastError().
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, int dtype, int B, int Sq,
                           int Skv, int H, int Hkv, int D, float scale,
                           int causal, int window, float softcap,
                           void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaGetLastError();
  if (D <= 0 || D > DMAX || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(q, k, v, o, lp, B, Sq, Skv, H, Hkv, D, scale,
                                         causal, window, softcap, st)
                 : launch<float>(q, k, v, o, lp, B, Sq, Skv, H, Hkv, D, scale, causal,
                                 window, softcap, st);
  return (int)err;
}

// The tensor-core branch: bf16 q, k, v and o, D % 16 == 0, D <= 256,
// Skv >= 1, every base address 16-byte aligned. `lse` may be null.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a shape it
// does not take or a tensor map that cuTensorMapEncodeTiled refuses.
int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* o,
                              void* lse, int B, int Sq, int Skv, int H, int Hkv, int D,
                              float scale, int causal, int window, float softcap,
                              void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaGetLastError();
  if (D <= 0 || D > DMAX || D % 16 != 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  const int dp = (D + 63) / 64 * 64;
  cudaError_t err =
      dp == 64    ? tc::launch<64>(q, k, v, o, lp, B, Sq, Skv, H, Hkv, D, scale, causal,
                                   window, softcap, st)
      : dp == 128 ? tc::launch<128>(q, k, v, o, lp, B, Sq, Skv, H, Hkv, D, scale, causal,
                                    window, softcap, st)
      : dp == 192 ? tc::launch<192>(q, k, v, o, lp, B, Sq, Skv, H, Hkv, D, scale, causal,
                                    window, softcap, st)
                  : tc::launch<256>(q, k, v, o, lp, B, Sq, Skv, H, Hkv, D, scale, causal,
                                    window, softcap, st);
  return (int)err;
}

}  // extern "C"

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
// Design (first, simple version; the wgmma path is later work): 4 warps,
// 4 query rows per warp. A kv tile of 32 keys is staged in shared memory
// as f32; lane j computes the logit of key j for the warp's 4 rows (the
// q rows are read from shared memory as broadcasts), the row max and sum
// are warp shuffles, and each lane owns D/32 output columns of the
// accumulator, to which every key's probability is broadcast by shuffle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

}  // extern "C"

// Flash attention backward (recompute from the stashed logsumexp) for Hopper.
//
//  * flash_dq replaces the TPU kernel `_flash_dq_kernel` and
//  * flash_dkv replaces `_flash_dkv_kernel`,
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
// the 8*D operations per (query, key) pair that the mask admits (q.k and
// dO.v recomputed, then two products with the tile), not the bytes.
//
// Design (first, simple version; the wgmma path is later work):
//  * dq: one block per (q tile of 16 rows, head, batch), 4 warps of 4
//    rows, walking the kv tiles the mask can reach. Lane j takes key j of a
//    32-key tile: it computes s and dp for the warp's 4 rows; g is broadcast
//    by shuffle and each lane accumulates D/32 columns of dq.
//  * dkv: one block per (kv tile of 32 keys, kv head, batch), 8 warps of 4
//    keys. It loops over the q tiles of all rep query heads of the GQA
//    group that the mask can reach, so the group sum needs no atomics (the
//    TPU kernel folds the group the same way). Lane i takes query row i of
//    a 32-row tile: it computes s and dp against the warp's 4 keys; p and g
//    are broadcast by shuffle and each lane accumulates D/32 columns of
//    dk and dv for its warp's keys.
// Tiles are staged in shared memory as f32 with rows padded to D/4*4 + 4
// floats, so a warp's float4 reads of 32 different rows spread over all
// banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

}  // extern "C"

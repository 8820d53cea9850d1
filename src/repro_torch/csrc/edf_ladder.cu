// PushDown's EDF ladder (paper alg. 3): the histogram of the master
// weights and of every word-length candidate's round-to-nearest
// re-quantization, in one pass over the subsampled weights.
//
// edf_ladder_launch replaces the TPU kernel `_edf_ladder_kernel` of
// src/repro/kernels/edf_ladder.py (reached through `edf_ladder_hists`).
// For each layer l of w (L, n) f32 it writes counts (1 + T, r_upr) f32:
//  * row 0: bin of every w,
//  * row 1 + t: bin of clip(rint(w * 2^fls[l, t]), -qmax[t] - 1, qmax[t])
//    / 2^fls[l, t] (rint rounds half to even, as jnp.round),
// each bin = clip(floor((v - lo) / max(hi - lo, 1e-12) * r), 0, r - 1) over
// the layer's own [lo, hi] = [min w, max w] with r = r[l] live bins. An
// element whose bin is NaN (hi - lo overflows to inf) is counted in no
// row, as the TPU kernel's one-hot compare counts it nowhere; the NaN test
// comes before the float-to-int cast, which is undefined for NaN. Every
// operation is the reference's, in its order, rounded to nearest without
// contraction (__fsub_rn, __fdiv_rn, __fmul_rn): the bins are bit for bit
// those of the reference, and the counts exact.
//
// The reference runs it under jax.vmap over the layers of a stacked leaf;
// here grid.y is the layer, so one launch covers a leaf.
//
// What bounds it on an H100: nothing of the card's throughput; a switch of
// llama3.2-3b bins 198 layers x 65536 values x 19 rows (52 MB read), so a
// launch is bound by its latency. Design: each block keeps int counters
// for its layer's (1 + T) x r_upr bins in shared memory (exact integer
// atomics, so the counts do not depend on the order), strides over a
// slice of the layer, then adds its counters into an int32 table in
// device memory; a second small kernel converts the table to f32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int PER_THREAD = 16;      // elements per thread and block pass

__device__ __forceinline__ float pow2i(int e) {
  e = min(max(e, -126), 127);
  return __int_as_float((e + 127) << 23);
}

// clip(floor((v - lo) / span * rf), 0, rf - 1) as an int, or -1 for NaN.
__device__ __forceinline__ int bin_of(float v, float lo, float span,
                                      float rf) {
  const float t = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(v, lo), span), rf));
  if (isnan(t)) return -1;
  return (int)fminf(fmaxf(t, 0.0f), __fsub_rn(rf, 1.0f));
}

__global__ void __launch_bounds__(NT)
edf_ladder_kernel(const float* __restrict__ w, const int* __restrict__ fls,
                  const int* __restrict__ r, const float* __restrict__ lo_,
                  const float* __restrict__ hi_,
                  const float* __restrict__ qmax_, int* __restrict__ counts,
                  int n, int T, int r_upr) {
  extern __shared__ unsigned char smem[];
  const int rows = 1 + T;
  int* cnt = reinterpret_cast<int*>(smem);                  // rows x r_upr
  float* scale = reinterpret_cast<float*>(cnt + rows * r_upr);
  float* qmx = scale + T;
  float* qmn = qmx + T;
  const int l = blockIdx.y;
  for (int j = threadIdx.x; j < rows * r_upr; j += NT) cnt[j] = 0;
  for (int t = threadIdx.x; t < T; t += NT) {
    scale[t] = pow2i(fls[l * T + t]);
    qmx[t] = qmax_[t];
    qmn[t] = __fsub_rn(-qmax_[t], 1.0f);
  }
  __syncthreads();
  const float lo = lo_[l];
  const float span = fmaxf(__fsub_rn(hi_[l], lo), 1e-12f);
  const float rf = (float)r[l];
  const float* wl = w + (long long)l * n;
  for (int e = blockIdx.x * NT + threadIdx.x; e < n; e += gridDim.x * NT) {
    const float v = wl[e];
    int b = bin_of(v, lo, span, rf);
    if (b >= 0) atomicAdd(&cnt[b], 1);
    for (int t = 0; t < T; ++t) {
      const float s = scale[t];
      float q = fminf(fmaxf(rintf(__fmul_rn(v, s)), qmn[t]), qmx[t]);
      b = bin_of(__fdiv_rn(q, s), lo, span, rf);
      if (b >= 0) atomicAdd(&cnt[(1 + t) * r_upr + b], 1);
    }
  }
  __syncthreads();
  int* out = counts + (long long)l * rows * r_upr;
  for (int j = threadIdx.x; j < rows * r_upr; j += NT)
    if (cnt[j]) atomicAdd(&out[j], cnt[j]);
}

__global__ void to_f32_kernel(const int* __restrict__ c, float* __restrict__ o,
                              int total) {
  const int j = blockIdx.x * NT + threadIdx.x;
  if (j < total) o[j] = (float)c[j];
}

}  // namespace

extern "C" {

// counts (L, 1+T, r_upr) int32 scratch and out (L, 1+T, r_upr) f32, from
// w (L, n) f32, fls (L, T) int32, r (L,) int32, lo/hi (L,) f32 (each
// layer's min and max) and qmax (T,) f32. Returns cudaGetLastError().
int edf_ladder_launch(const void* w, const void* fls, const void* r,
                      const void* lo, const void* hi, const void* qmax,
                      void* counts, void* out, int L, int n, int T, int r_upr,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int total = L * (1 + T) * r_upr;
  if (total <= 0) return (int)cudaGetLastError();
  if (L > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)total, st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int bx = (n + NT * PER_THREAD - 1) / (NT * PER_THREAD);
    const size_t shm = sizeof(int) * (size_t)(1 + T) * r_upr +
                       sizeof(float) * 3 * (size_t)T;
    edf_ladder_kernel<<<dim3(bx, L), NT, shm, st>>>(
        static_cast<const float*>(w), static_cast<const int*>(fls),
        static_cast<const int*>(r), static_cast<const float*>(lo),
        static_cast<const float*>(hi), static_cast<const float*>(qmax),
        static_cast<int*>(counts), n, T, r_upr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  to_f32_kernel<<<(total + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const int*>(counts), static_cast<float*>(out), total);
  return (int)cudaGetLastError();
}

}  // extern "C"

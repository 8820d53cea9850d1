// PushDown's KL probe (paper alg. 3): the histograms of the master weights w
// and of their quantized copy q over the same bins, in one pass.
//
// kl_hist_launch replaces the TPU kernel `_kl_hist_kernel` of
// src/repro/kernels/kl_hist.py (reached through `kl_hist`). It writes f32
// counts (2, num_bins): row 0 of w, row 1 of q, each element in bin
// clip(floor((x - lo) * inv_span), 0, num_bins - 1) with
// inv_span = num_bins / max(hi - lo, 1e-12) and [lo, hi] = [min w, max w]
// (computed by the caller, as the TPU kernel's wrapper takes them outside
// the kernel). The arithmetic is the TPU kernel's, in its order (it
// multiplies by the inverse span; the jnp oracle divides by the span), each
// step rounded to nearest without contraction (__fsub_rn, __fdiv_rn,
// __fmul_rn). An element whose bin is NaN is counted in no row, as the TPU
// kernel's one-hot compare counts it nowhere; the NaN test comes before the
// float-to-int cast, which is undefined for NaN. The TPU kernel pads its
// lanes with lo and takes their count back from bin 0; here nothing is
// padded, which gives the same counts for a NaN-free w. Counts are exact
// int32 (the TPU kernel's f32 sums are exact up to 2^24 per bin), then
// converted to f32.
//
// What bounds it on an H100: the bytes, 8 read per element (w and q in f32):
// 5.6 GB and 1.68 ms at 3.35 TB/s for a (28, 3072, 8192) leaf. Design: a
// grid-stride pass with float4 loads where the length and pointers allow;
// each warp adds into its own int counters in shared memory (exact integer
// atomics, so the counts do not depend on the order; one copy per warp
// keeps warps apart on the few bins that hold most of a bell-shaped
// tensor); at the end each block adds its counters into an int32 table in
// device memory, and a second small kernel converts the table to f32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_BLOCKS = 132 * 8;

// bin of v, or -1 when it is NaN
__device__ __forceinline__ int kl_bin(float v, float lo, float inv, float top) {
  const float t = floorf(__fmul_rn(__fsub_rn(v, lo), inv));
  if (isnan(t)) return -1;
  return (int)fminf(fmaxf(t, 0.0f), top);
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
kl_hist_kernel(const float* __restrict__ w, const float* __restrict__ q,
               const float* __restrict__ lohi, int* __restrict__ counts,
               long long n, int nb, int copies) {
  extern __shared__ int cnt[];                    // copies x 2 x nb
  for (int j = threadIdx.x; j < copies * 2 * nb; j += NT) cnt[j] = 0;
  __syncthreads();
  const float lo = lohi[0];
  const float d = __fsub_rn(lohi[1], lo);
  const float span = isnan(d) ? d : fmaxf(d, 1e-12f);   // jnp.maximum
  const float inv = __fdiv_rn((float)nb, span);
  const float top = (float)(nb - 1);
  int* mine = cnt + ((threadIdx.x / 32) % copies) * 2 * nb;
  const long long step = (long long)gridDim.x * NT;
  const long long first = (long long)blockIdx.x * NT + threadIdx.x;
  if (VEC) {
    for (long long e = first; e < n / 4; e += step) {
      const float4 a = reinterpret_cast<const float4*>(w)[e];
      const float4 b = reinterpret_cast<const float4*>(q)[e];
      const float va[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int bin = kl_bin(va[i], lo, inv, top);
        if (bin >= 0) atomicAdd(&mine[(i / 4) * nb + bin], 1);
      }
    }
  } else {
    for (long long e = first; e < n; e += step) {
      int bin = kl_bin(w[e], lo, inv, top);
      if (bin >= 0) atomicAdd(&mine[bin], 1);
      bin = kl_bin(q[e], lo, inv, top);
      if (bin >= 0) atomicAdd(&mine[nb + bin], 1);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * nb; j += NT) {
    int c = 0;
    for (int k = 0; k < copies; ++k) c += cnt[k * 2 * nb + j];
    if (c) atomicAdd(&counts[j], c);
  }
}

__global__ void to_f32_kernel(const int* __restrict__ c, float* __restrict__ o,
                              int total) {
  const int j = blockIdx.x * NT + threadIdx.x;
  if (j < total) o[j] = (float)c[j];
}

}  // namespace

extern "C" {

// out (2, nb) f32 counts of w (n) and q (n) f32 over lohi = [lo, hi] (a
// device f32 pair), with counts (2, nb) int32 scratch; `smem_bytes` is the
// shared memory a block may take (one copy of the 2 x nb counters at the
// least). Returns cudaGetLastError().
int kl_hist_launch(const void* w, const void* q, const void* lohi,
                   void* counts, void* out, long long n, int nb,
                   int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int total = 2 * nb;
  if (nb <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)total, st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int per_copy = (int)sizeof(int) * total;
    int copies = smem_bytes / per_copy;
    if (copies > NT / 32) copies = NT / 32;
    if (copies < 1) return (int)cudaErrorInvalidValue;
    const size_t shm = (size_t)copies * per_copy;
    if (shm > 48 * 1024) {
      err = cudaFuncSetAttribute(kl_hist_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)shm);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kl_hist_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)shm);
      if (err != cudaSuccess) return (int)err;
    }
    const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 16 == 0;
    const long long work = vec ? n / 4 : n;
    long long blocks = (work + NT - 1) / NT;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    const float* wp = static_cast<const float*>(w);
    const float* qp = static_cast<const float*>(q);
    const float* rp = static_cast<const float*>(lohi);
    int* cp = static_cast<int*>(counts);
    if (vec)
      kl_hist_kernel<true><<<(unsigned)blocks, NT, shm, st>>>(wp, qp, rp, cp, n,
                                                              nb, copies);
    else
      kl_hist_kernel<false><<<(unsigned)blocks, NT, shm, st>>>(wp, qp, rp, cp, n,
                                                               nb, copies);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  to_f32_kernel<<<(total + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const int*>(counts), static_cast<float*>(out), total);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Stochastic-rounding int8 words of the f32 master, the noise drawn inside
// the kernel from the portable counter-hash stream (paper alg. 1 ln. 9-11:
// the quantized copy of every weight tensor, once per optimizer step).
//
//  * sr_quantize_fused_int8_launch replaces the TPU kernel
//    `_sr_fused_int8_kernel` of src/repro/kernels/sr_quantize.py (reached
//    through `sr_quantize_fused_int8`): an unstacked tensor of n elements,
//    element i drawing u from index i.
//  * sr_quantize_fused_stacked_int8_launch replaces
//    `_sr_fused_stacked_int8_kernel` (reached through
//    `sr_quantize_fused_stacked_int8`): an (L, n_l) stack, layer l at its
//    own FL, element i of layer l drawing u from index l * rows * 512 + i,
//    rows = ceil(n_l / 512). The layer stride is the TPU kernel's padded
//    plane; no padding is needed here, only the index.
//
// Each element: s = x * 2^fl, f = floor(s), q = f + [u < s - f], clipped to
// [-128, 127] as int8; u = (h >> 8) * 2^-24 with h the murmur3 finalizer of
// idx + (uint32)seed * 0x9E3779B9 (uint32 arithmetic, wrapping). 2^fl is
// built from the exponent bits (fl clamped to [-126, 127]), never exp2f.
// The products and differences are written as __fmul_rn / __fsub_rn so that
// no fused multiply-add changes a rounding: the words are bit for bit those
// of the reference's portable stream.
//
// What bounds it on an H100: the bytes, 4 read and 1 written per element
// (3.6 G elements a training step of llama3.2-3b, 18 GB, >= 5.4 ms at
// 3.35 TB/s). Design: elementwise with no reduction; a grid-stride loop
// with one float4 load and one 4-byte store per thread and step wherever
// the layer's length and the pointers allow it, the layer on grid.y, FL
// read once per thread from device memory (no host synchronisation).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr unsigned LANES = 512;     // the TPU kernels' padded row width

__device__ __forceinline__ float pow2i(int e) {
  e = min(max(e, -126), 127);
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ float uniform(uint32_t idx, uint32_t seed_mix) {
  uint32_t h = idx + seed_mix;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return __fmul_rn((float)(h >> 8), 1.0f / 16777216.0f);
}

__device__ __forceinline__ int8_t sr_word(float x, float scale, float u) {
  const float s = __fmul_rn(x, scale);
  const float f = floorf(s);
  float q = __fadd_rn(f, u < __fsub_rn(s, f) ? 1.0f : 0.0f);
  q = fminf(fmaxf(q, -128.0f), 127.0f);
  return (int8_t)(int)q;
}

// grid.y = layer; grid.x strides over the layer's elements (VEC: over
// groups of four).
template <bool VEC>
__global__ void __launch_bounds__(NT)
sr_int8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
               const int* __restrict__ fl, uint32_t seed_mix, long long n_l,
               uint32_t stride) {
  const int l = blockIdx.y;
  const float scale = pow2i(fl[l]);
  const uint32_t base = (uint32_t)l * stride;
  const float* xl = x + (long long)l * n_l;
  int8_t* ql = q + (long long)l * n_l;
  const long long step = (long long)gridDim.x * NT;
  if (VEC) {
    const long long groups = n_l / 4;
    for (long long g = (long long)blockIdx.x * NT + threadIdx.x; g < groups;
         g += step) {
      const float4 v = reinterpret_cast<const float4*>(xl)[g];
      const uint32_t i = base + (uint32_t)(4 * g);
      char4 w;
      w.x = sr_word(v.x, scale, uniform(i, seed_mix));
      w.y = sr_word(v.y, scale, uniform(i + 1u, seed_mix));
      w.z = sr_word(v.z, scale, uniform(i + 2u, seed_mix));
      w.w = sr_word(v.w, scale, uniform(i + 3u, seed_mix));
      reinterpret_cast<char4*>(ql)[g] = w;
    }
  } else {
    for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < n_l;
         e += step)
      ql[e] = sr_word(xl[e], scale, uniform(base + (uint32_t)e, seed_mix));
  }
}

cudaError_t launch(const float* x, int8_t* q, const int* fl, int seed, int L,
                   long long n_l, uint32_t stride, cudaStream_t st) {
  if (L <= 0 || n_l <= 0) return cudaGetLastError();
  const uint32_t seed_mix = (uint32_t)seed * 0x9E3779B9u;
  const bool vec = n_l % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 4 == 0;
  const long long work = vec ? n_l / 4 : n_l;
  // about 16 resident blocks per SM of the 132 in all, split over layers
  long long bx = (work + NT - 1) / NT;
  const long long cap = (2112 + L - 1) / L;
  if (bx > cap) bx = cap;
  const dim3 grid((unsigned)bx, (unsigned)L);
  if (vec)
    sr_int8_kernel<true><<<grid, NT, 0, st>>>(x, q, fl, seed_mix, n_l, stride);
  else
    sr_int8_kernel<false><<<grid, NT, 0, st>>>(x, q, fl, seed_mix, n_l, stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (n) int8 = SR words of x (n) f32 at FL *fl (device int32 scalar).
// Returns cudaGetLastError().
int sr_quantize_fused_int8_launch(const void* x, void* q, const void* fl,
                                  int seed, long long n, void* stream) {
  return (int)launch(static_cast<const float*>(x), static_cast<int8_t*>(q),
                     static_cast<const int*>(fl), seed, 1, n, 0u,
                     static_cast<cudaStream_t>(stream));
}

// q (L, n_l) int8 = SR words of x (L, n_l) f32, layer l at FL fl[l]
// (device int32 (L,)). Returns cudaGetLastError().
int sr_quantize_fused_stacked_int8_launch(const void* x, void* q,
                                          const void* fl, int seed, int L,
                                          long long n_l, void* stream) {
  if (L > 65535) return (int)cudaErrorInvalidValue;
  const uint32_t rows = (uint32_t)((n_l + LANES - 1) / LANES);
  return (int)launch(static_cast<const float*>(x), static_cast<int8_t*>(q),
                     static_cast<const int*>(fl), seed, L, n_l, rows * LANES,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"

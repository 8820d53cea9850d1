// Stochastic-rounding quantize of the f32 master, the noise drawn inside the
// kernel from the portable counter-hash stream (paper alg. 1 ln. 9-11: the
// quantized copy of every weight tensor, once per optimizer step).
//
// Int8 words (the int8_packed container):
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
// The noise given as a tensor:
//  * sr_quantize_launch replaces `_sr_quantize_kernel` (reached through
//    `sr_quantize`): x (n) f32 or bf16 and u (n) f32 U[0,1) in, the grid
//    values at one <WL,FL> out in x's dtype (the reference computes them in
//    f32 and casts them to x's dtype: bf16 is __float2bfloat16_rn of the f32
//    value).
// Grid values in a float container (float32 / bfloat16):
//  * sr_quantize_fused_launch replaces `_sr_fused_kernel` (reached through
//    `sr_quantize_fused`), flat, at one <WL,FL>;
//  * sr_quantize_fused_stacked_launch replaces `_sr_fused_stacked_kernel`
//    (reached through `sr_quantize_fused_stacked`), layer l at
//    <wl[l], fl[l]>, with the same layer stride as the int8 stack.
//
// Each element: s = x * 2^fl, f = floor(s), q = f + [u < s - f]; u = (h >> 8)
// * 2^-24 with h the murmur3 finalizer of idx + (uint32)seed * 0x9E3779B9
// (uint32 arithmetic, wrapping). Int8 words clip q to [-128, 127]. Grid
// values clip q to [-qmax - 1, qmax], qmax = 2^(wl-1) - 1 computed in f32 (at
// WL 32 it rounds to 2^31, as the reference's), and write q / 2^fl as f32 or
// as bf16 rounded to nearest even. 2^e is built from the exponent bits (e
// clamped to [-126, 127]), never exp2f. sr_quantize divides (__fdiv_rn); the
// two fused grid-value entry points multiply by the exact reciprocal 2^-e
// (2^-127, at e = 127, is subnormal and still exact): q is an integer or a
// NaN, so q / 2^e and q * 2^-e are the same real number rounded once, and
// the bits agree as long as nothing flushes subnormals (the build has no
// --use_fast_math). The products and differences are written as __fmul_rn /
// __fsub_rn so that no fused multiply-add changes a rounding: the values are
// bit for bit those of the reference's portable stream.
//
// What bounds them on an H100: the bytes, 4 read per element and 1 (int8),
// 4 (f32) or 2 (bf16) written (sr_quantize: x and u read, 12 bytes per f32
// element and 8 per bf16 element) (3.6 G elements a training step of
// llama3.2-3b: 18 GB for int8 words, 28.9 GB for f32 grid values, >= 5.4
// and 8.6 ms at 3.35 TB/s). Design of the int8 words and of sr_quantize:
// elementwise with no reduction; a grid-stride loop with one float4 load
// and one 4-word store per thread and step wherever the layer's length and
// the pointers allow it, the layer on grid.y, <WL,FL> read once per thread
// from device memory (no host synchronisation). Design of the grid values
// (namespace grid): the (layer, chunk) pairs flattened into one list of
// chunks of CHUNK elements that never cross a layer, walked by a persistent
// grid of CTAS_PER_SM CTAs an SM, so that every SM has equal work and no
// tail wave; one thread streams whole chunks into a ring of STAGES
// shared-memory stages by 1-D bulk copies (96 KB in flight an SM, where a
// grid-stride loop has one 16-byte load a thread), the CTA's threads write
// a chunk's outputs to a staging slot, and one bulk copy stores it. A
// chunk's part whose x or q address is not 16-byte aligned (a head and a
// tail of under 16 bytes, or the whole chunk when x and q cannot be
// aligned together) takes an element path in the same kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int NT = 256;
constexpr unsigned LANES = 512;     // the TPU kernels' padded row width

using sm90::pow2i;

__device__ __forceinline__ float uniform(uint32_t idx, uint32_t seed_mix) {
  uint32_t h = idx + seed_mix;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return __fmul_rn((float)(h >> 8), 1.0f / 16777216.0f);
}

// floor(s) + [u < s - floor(s)], s = x * scale
__device__ __forceinline__ float sr_round(float x, float scale, float u) {
  const float s = __fmul_rn(x, scale);
  const float f = floorf(s);
  return __fadd_rn(f, u < __fsub_rn(s, f) ? 1.0f : 0.0f);
}

// The grid of one layer: the scale 2^fl and, for grid values, the clip
// bounds [-qmax - 1, qmax].
struct Grid {
  float scale, lo, hi;
};

__device__ __forceinline__ Grid grid_of(const int* wl, const int* fl, int l) {
  Grid g;
  g.scale = pow2i(fl[l]);
  if (wl != nullptr) {
    g.hi = __fsub_rn(pow2i(wl[l] - 1), 1.0f);
    g.lo = __fsub_rn(-g.hi, 1.0f);
  }
  return g;
}

template <typename T>
__device__ __forceinline__ T word(float x, const Grid& g, float u);

// int8 words: clip to [-128, 127]
template <>
__device__ __forceinline__ int8_t word<int8_t>(float x, const Grid& g, float u) {
  const float q = fminf(fmaxf(sr_round(x, g.scale, u), -128.0f), 127.0f);
  return (int8_t)(int)q;
}

// grid values: clip (a NaN passes, as torch.clamp's and jnp.clip's), divide
__device__ __forceinline__ float grid_value(float x, const Grid& g, float u) {
  float q = sr_round(x, g.scale, u);
  q = q < g.lo ? g.lo : (q > g.hi ? g.hi : q);
  return __fdiv_rn(q, g.scale);
}
template <>
__device__ __forceinline__ float word<float>(float x, const Grid& g, float u) {
  return grid_value(x, g, u);
}
template <>
__device__ __forceinline__ __nv_bfloat16 word<__nv_bfloat16>(float x, const Grid& g,
                                                            float u) {
  return __float2bfloat16_rn(grid_value(x, g, u));
}

// Four consecutive outputs by one store (the caller has checked alignment).
__device__ __forceinline__ void store4(int8_t* p, const int8_t (&w)[4]) {
  *reinterpret_cast<char4*>(p) = make_char4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store4(float* p, const float (&w)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const __nv_bfloat16 (&w)[4]) {
  __nv_bfloat162 a, b;
  a.x = w[0]; a.y = w[1]; b.x = w[2]; b.y = w[3];
  uint2 v;
  v.x = *reinterpret_cast<const unsigned*>(&a);
  v.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = v;
}

// grid.y = layer; grid.x strides over the layer's elements (VEC: over
// groups of four). `wl` is null for int8 words.
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
sr_kernel(const float* __restrict__ x, T* __restrict__ q,
          const int* __restrict__ wl, const int* __restrict__ fl,
          uint32_t seed_mix, long long n_l, uint32_t stride) {
  const int l = blockIdx.y;
  const Grid g = grid_of(wl, fl, l);
  const uint32_t base = (uint32_t)l * stride;
  const float* xl = x + (long long)l * n_l;
  T* ql = q + (long long)l * n_l;
  const long long step = (long long)gridDim.x * NT;
  if (VEC) {
    const long long groups = n_l / 4;
    for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < groups;
         e += step) {
      const float4 v = reinterpret_cast<const float4*>(xl)[e];
      const uint32_t i = base + (uint32_t)(4 * e);
      const T w[4] = {word<T>(v.x, g, uniform(i, seed_mix)),
                      word<T>(v.y, g, uniform(i + 1u, seed_mix)),
                      word<T>(v.z, g, uniform(i + 2u, seed_mix)),
                      word<T>(v.w, g, uniform(i + 3u, seed_mix))};
      store4(ql + 4 * e, w);
    }
  } else {
    for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < n_l;
         e += step)
      ql[e] = word<T>(xl[e], g, uniform(base + (uint32_t)e, seed_mix));
  }
}

template <typename T>
cudaError_t launch(const float* x, T* q, const int* wl, const int* fl, int seed,
                   int L, long long n_l, uint32_t stride, cudaStream_t st) {
  if (L <= 0 || n_l <= 0) return cudaGetLastError();
  const uint32_t seed_mix = (uint32_t)seed * 0x9E3779B9u;
  const bool vec = n_l % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % (4 * sizeof(T)) == 0;
  const long long work = vec ? n_l / 4 : n_l;
  // about 16 resident blocks per SM of the 132 in all, split over layers
  long long bx = (work + NT - 1) / NT;
  const long long cap = (2112 + L - 1) / L;
  if (bx > cap) bx = cap;
  const dim3 grid((unsigned)bx, (unsigned)L);
  if (vec)
    sr_kernel<T, true><<<grid, NT, 0, st>>>(x, q, wl, fl, seed_mix, n_l, stride);
  else
    sr_kernel<T, false><<<grid, NT, 0, st>>>(x, q, wl, fl, seed_mix, n_l, stride);
  return cudaGetLastError();
}

// Four consecutive inputs of x as f32 (the caller has checked alignment).
__device__ __forceinline__ void load4(const float* p, long long e, float (&v)[4]) {
  const float4 a = reinterpret_cast<const float4*>(p)[e];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, long long e,
                                      float (&v)[4]) {
  const uint2 a = reinterpret_cast<const uint2*>(p)[e];
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ float load1(const float* p, long long e) { return p[e]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p, long long e) {
  return __bfloat162float(p[e]);
}

// SR grid values with the noise u given: q (n) in x's type T.
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
sr_given_kernel(const T* __restrict__ x, const float* __restrict__ u,
                T* __restrict__ q, const int* __restrict__ wl,
                const int* __restrict__ fl, long long n) {
  const Grid g = grid_of(wl, fl, 0);
  const long long step = (long long)gridDim.x * NT;
  if (VEC) {
    const long long groups = n / 4;
    for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < groups;
         e += step) {
      float v[4];
      load4(x, e, v);
      const float4 r = reinterpret_cast<const float4*>(u)[e];
      const T w[4] = {word<T>(v[0], g, r.x), word<T>(v[1], g, r.y),
                      word<T>(v[2], g, r.z), word<T>(v[3], g, r.w)};
      store4(q + 4 * e, w);
    }
  } else {
    for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < n;
         e += step)
      q[e] = word<T>(load1(x, e), g, u[e]);
  }
}

template <typename T>
cudaError_t launch_given(const T* x, const float* u, T* q, const int* wl,
                         const int* fl, long long n, cudaStream_t st) {
  if (n <= 0) return cudaGetLastError();
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % (4 * sizeof(T)) == 0;
  const long long work = vec ? n / 4 : n;
  long long blocks = (work + NT - 1) / NT;
  if (blocks > 2112) blocks = 2112;
  if (vec)
    sr_given_kernel<T, true><<<(unsigned)blocks, NT, 0, st>>>(x, u, q, wl, fl, n);
  else
    sr_given_kernel<T, false><<<(unsigned)blocks, NT, 0, st>>>(x, u, q, wl, fl, n);
  return cudaGetLastError();
}

uint32_t layer_stride(long long n_l) {
  return (uint32_t)((n_l + LANES - 1) / LANES) * LANES;
}

}  // namespace

// The float SR grid values (sr_quantize_fused and sr_quantize_fused_stacked;
// the flat tensor is one layer with stride 0). The plan is mirrored by
// grid_plan, grid_chunk, grid_bulk and grid_split in kernels/sr_quantize.py,
// which the CPU tests emulate.
namespace grid {

// One CTA an SM with 32 KB chunks ran 3-8% faster than two with 16 KB ones
// on an H100 (fewer barriers a byte; PERF.md section 6).
constexpr int NT = 256;              // threads a CTA
constexpr int CHUNK = 8192;          // elements a chunk (32 KB of x)
constexpr int STAGES = 4;            // the ring of x chunks
constexpr int SLOTS = 2;             // staging slots of outputs
constexpr int CTAS_PER_SM = 1;

template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)STAGES * CHUNK * sizeof(float) + (size_t)SLOTS * CHUNK * sizeof(T);
}

struct Plan {
  long long n_l;       // elements a layer
  long long cpl;       // chunks a layer: ceil(n_l / CHUNK)
  long long chunks;    // L * cpl
  uint32_t stride;     // the layer stride of the hash index
  uint32_t seed_mix;
  int period;          // element g is bulk-copied from g % period == phase on;
  int phase;           // period 0: no element is (x and q cannot be aligned)
};

// Chunk c: layer l, elements [g0, g1) of the flat tensor, of which [a, b)
// goes by bulk copies and [g0, a) and [b, g1) by the element path.
struct Span {
  long long l, g0, g1, a, b;
};

__device__ __forceinline__ Span span_of(const Plan& p, long long c) {
  Span s;
  // a 32-bit division wherever both fit (every tensor of a real model)
  s.l = (c | p.cpl) >> 32 ? c / p.cpl : (long long)((uint32_t)c / (uint32_t)p.cpl);
  s.g0 = s.l * p.n_l + (c - s.l * p.cpl) * CHUNK;
  s.g1 = min(s.g0 + CHUNK, (s.l + 1) * p.n_l);
  if (p.period == 0) {
    s.a = s.b = s.g1;
  } else {
    s.a = min(s.g0 + ((p.phase - s.g0) & (p.period - 1)), s.g1);
    s.b = s.a + ((s.g1 - s.a) & ~(long long)(p.period - 1));
  }
  return s;
}

using sm90::recip_pow2i;

template <typename T>
__device__ __forceinline__ T out_of(float v);
template <>
__device__ __forceinline__ float out_of<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 out_of<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// grid_value with the reciprocal product for the division
template <typename T>
__device__ __forceinline__ T value(float x, const Grid& g, float inv, uint32_t i,
                                   uint32_t seed_mix) {
  float q = sr_round(x, g.scale, uniform(i, seed_mix));
  q = q < g.lo ? g.lo : (q > g.hi ? g.hi : q);
  return out_of<T>(__fmul_rn(q, inv));
}

// Persistent: CTA b takes chunks b, b + gridDim.x, ... Thread 0 keeps
// STAGES chunks of x in flight and issues each chunk's store; one barrier a
// chunk hands the stage back and the staging slot to the store.
template <typename T>
__global__ void __launch_bounds__(NT, CTAS_PER_SM)
sr_grid_kernel(const float* __restrict__ x, T* __restrict__ q,
               const int* __restrict__ wl, const int* __restrict__ fl, Plan p) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* ring = reinterpret_cast<float*>(smem);
  T* slots = reinterpret_cast<T*>(smem + (size_t)STAGES * CHUNK * sizeof(float));
  __shared__ uint64_t full[STAGES];
  const int tid = threadIdx.x;
  const long long first = blockIdx.x, step = gridDim.x;
  const long long mine = (p.chunks - 1 - first) / step + 1;

  auto issue = [&](long long i) {
    const Span s = span_of(p, first + i * step);
    const int st = (int)(i % STAGES);
    const uint32_t bytes = (uint32_t)(s.b - s.a) * sizeof(float);
    sm90::mbar_arrive_expect_tx(&full[st], bytes);
    if (bytes) sm90::bulk_load(ring + (size_t)st * CHUNK, x + s.a, bytes, &full[st]);
  };
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) sm90::mbar_init(&full[st], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (long long i = 0; i < STAGES && i < mine; ++i) issue(i);

  long long l = -1;
  Grid g;
  float inv = 0.0f;
  uint32_t base = 0;
  for (long long i = 0; i < mine; ++i) {
    const Span s = span_of(p, first + i * step);
    if (s.l != l) {  // the layer's grid, read when the layer changes
      l = s.l;
      g = grid_of(wl, fl, (int)l);
      inv = recip_pow2i(fl[l]);
      base = (uint32_t)l * p.stride - (uint32_t)(l * p.n_l);
    }
    const int st = (int)(i % STAGES);
    T* slot = slots + (size_t)(i % SLOTS) * CHUNK;
    // the element path: the head [g0, a) and the tail [b, g1)
    const int head = (int)(s.a - s.g0), edge = head + (int)(s.g1 - s.b);
    for (int k = tid; k < edge; k += NT) {
      const long long e = k < head ? s.g0 + k : s.b + (k - head);
      q[e] = value<T>(x[e], g, inv, base + (uint32_t)e, p.seed_mix);
    }
    // the bulk part, four elements a thread and step
    sm90::mbar_wait(&full[st], (uint32_t)(i / STAGES) & 1u);
    const float4* in = reinterpret_cast<const float4*>(ring + (size_t)st * CHUNK);
    const int groups = (int)(s.b - s.a) / 4;
    const uint32_t i0 = base + (uint32_t)s.a;
    for (int k = tid; k < groups; k += NT) {
      const float4 v = in[k];
      const uint32_t e = i0 + 4u * (uint32_t)k;
      const T w[4] = {value<T>(v.x, g, inv, e, p.seed_mix),
                      value<T>(v.y, g, inv, e + 1u, p.seed_mix),
                      value<T>(v.z, g, inv, e + 2u, p.seed_mix),
                      value<T>(v.w, g, inv, e + 3u, p.seed_mix)};
      store4(slot + 4 * k, w);
    }
    // this thread's reads of the stage and writes of the slot, before the
    // async proxy refills the one and stores the other
    sm90::fence_proxy_async();
    // the store issued one chunk ago has read its slot, which the next
    // chunk rewrites after the barrier
    if (tid == 0) sm90::bulk_wait_read<0>();
    __syncthreads();
    if (tid == 0) {
      if (s.b > s.a) {
        sm90::bulk_store(q + s.a, slot, (uint32_t)(s.b - s.a) * sizeof(T));
        sm90::bulk_commit();
      }
      if (i + STAGES < mine) issue(i + STAGES);
    }
  }
  if (tid == 0) sm90::bulk_wait<0>();
}

template <typename T>
cudaError_t launch(const float* x, T* q, const int* wl, const int* fl, int seed,
                   int L, long long n_l, uint32_t stride, cudaStream_t st) {
  if (L <= 0 || n_l <= 0) return cudaGetLastError();
  Plan p;
  p.n_l = n_l;
  p.cpl = (n_l + CHUNK - 1) / CHUNK;
  p.chunks = (long long)L * p.cpl;
  p.stride = stride;
  p.seed_mix = (uint32_t)seed * 0x9E3779B9u;
  // elements whose x and q addresses are both 16-byte aligned: x's every
  // fourth from ex, q's every period-th from eq
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), qa = reinterpret_cast<uintptr_t>(q);
  const int period = 16 / (int)sizeof(T);
  const int ex = (int)((16 - xa % 16) % 16 / 4), eq = (int)((16 - qa % 16) % 16 / sizeof(T));
  const bool bulk = xa % 4 == 0 && qa % sizeof(T) == 0 && eq % 4 == ex;
  p.period = bulk ? period : 0;
  p.phase = bulk ? eq : 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sr_grid_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const long long most = (long long)CTAS_PER_SM * sms;
  const long long ctas = p.chunks < most ? p.chunks : most;
  sr_grid_kernel<T><<<(unsigned)ctas, NT, smem_bytes<T>(), st>>>(x, q, wl, fl, p);
  return cudaGetLastError();
}

}  // namespace grid

namespace {

// Grid values as f32 (out_dtype 0) or bf16 (out_dtype 1).
cudaError_t launch_grid(const void* x, void* q, int out_dtype, const void* wl,
                        const void* fl, int seed, int L, long long n_l,
                        uint32_t stride, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const int* wlp = static_cast<const int*>(wl);
  const int* flp = static_cast<const int*>(fl);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    return grid::launch(xp, static_cast<__nv_bfloat16*>(q), wlp, flp, seed, L,
                        n_l, stride, st);
  return grid::launch(xp, static_cast<float*>(q), wlp, flp, seed, L, n_l, stride,
                      st);
}

}  // namespace

extern "C" {

// q (n) int8 = SR words of x (n) f32 at FL *fl (device int32 scalar).
// Returns cudaGetLastError().
int sr_quantize_fused_int8_launch(const void* x, void* q, const void* fl,
                                  int seed, long long n, void* stream) {
  return (int)launch(static_cast<const float*>(x), static_cast<int8_t*>(q),
                     nullptr, static_cast<const int*>(fl), seed, 1, n, 0u,
                     static_cast<cudaStream_t>(stream));
}

// q (L, n_l) int8 = SR words of x (L, n_l) f32, layer l at FL fl[l]
// (device int32 (L,)). Returns cudaGetLastError().
int sr_quantize_fused_stacked_int8_launch(const void* x, void* q,
                                          const void* fl, int seed, int L,
                                          long long n_l, void* stream) {
  if (L > 65535) return (int)cudaErrorInvalidValue;
  return (int)launch(static_cast<const float*>(x), static_cast<int8_t*>(q),
                     nullptr, static_cast<const int*>(fl), seed, L, n_l,
                     layer_stride(n_l), static_cast<cudaStream_t>(stream));
}

// q (n) = SR grid values of x (n) f32 at <*wl, *fl> (device int32 scalars),
// f32 (out_dtype 0) or bf16 (1). Returns cudaGetLastError().
int sr_quantize_fused_launch(const void* x, void* q, int out_dtype,
                             const void* wl, const void* fl, int seed,
                             long long n, void* stream) {
  return (int)launch_grid(x, q, out_dtype, wl, fl, seed, 1, n, 0u, stream);
}

// q (L, n_l) = SR grid values of x (L, n_l) f32, layer l at <wl[l], fl[l]>
// (device int32 (L,) each), f32 (out_dtype 0) or bf16 (1). Returns
// cudaGetLastError().
int sr_quantize_fused_stacked_launch(const void* x, void* q, int out_dtype,
                                     const void* wl, const void* fl, int seed,
                                     int L, long long n_l, void* stream) {
  if (L > 65535) return (int)cudaErrorInvalidValue;
  return (int)launch_grid(x, q, out_dtype, wl, fl, seed, L, n_l,
                          layer_stride(n_l), stream);
}

// q (n) = SR grid values of x (n) at <*wl, *fl> (device int32 scalars) with
// the noise u (n) f32, in x's type: f32 (dtype 0) or bf16 (1). Returns
// cudaGetLastError().
int sr_quantize_launch(const void* x, const void* u, void* q, int dtype,
                       const void* wl, const void* fl, long long n,
                       void* stream) {
  const float* up = static_cast<const float*>(u);
  const int* wlp = static_cast<const int*>(wl);
  const int* flp = static_cast<const int*>(fl);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_given(static_cast<const __nv_bfloat16*>(x), up,
                             static_cast<__nv_bfloat16*>(q), wlp, flp, n, st);
  return (int)launch_given(static_cast<const float*>(x), up,
                           static_cast<float*>(q), wlp, flp, n, st);
}

}  // extern "C"

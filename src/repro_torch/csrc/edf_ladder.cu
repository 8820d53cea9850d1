// PushDown's EDF ladder (paper alg. 3): the histogram of the master
// weights and of every word-length candidate's round-to-nearest
// re-quantization, in one pass over the subsampled weights.
//
// edf_ladder_launch replaces the TPU kernel `_edf_ladder_kernel` of
// src/repro/kernels/edf_ladder.py:41 (reached through `edf_ladder_hists`
// at :83). For each layer l of w (L, n) f32 it writes counts (1 + T, r_upr)
// f32:
//  * row 0: bin of every w,
//  * row 1 + t: bin of clip(rint(w * 2^fls[l, t]), -qmax[t] - 1, qmax[t])
//    / 2^fls[l, t] (rint rounds half to even, as jnp.round), qmax[t] the
//    f32 of the double 2^(wl[t] - 1) - 1 (2^31 at WL 32),
// each bin = clip(floor((v - lo) / max(hi - lo, 1e-12) * r), 0, r - 1) over
// the layer's own [lo, hi] = [min w, max w] with r = r[l] live bins. An
// element whose bin is NaN (hi - lo overflows to inf) is counted in no
// row, as the TPU kernel's one-hot compare counts it nowhere; the NaN test
// comes before the float-to-int cast, which is undefined for NaN. A layer
// that holds a NaN has NaN for lo and hi, so every bin is NaN and its
// counts are all 0. Every operation is the reference's, in its order,
// rounded to nearest without contraction (__fsub_rn, __fdiv_rn,
// __fmul_rn); the division by 2^fl is the product by its exact reciprocal
// (sm90::recip_pow2i: q is an integer, so the bits agree). The bins are
// bit for bit those of the reference, and the counts exact.
//
// What bounds it on an H100: nothing of the card's throughput. A switch of
// llama3.2-3b bins 198 layers x 65536 values x 19 rows in 9 launches
// (28 or 1 layers each); each input read once and the counts written once,
// at ~166 f32 operations an element on the CUDA cores, is 0.0045 ms at
// (28, 65536) and 0.00016 ms at (1, 65536), while a launch alone costs a
// few microseconds: half of that bound is out of reach at these sizes.
// Measured (chip_smoke.py and tools/edf_ladder_variants.py, NVIDIA H100
// 80GB HBM3 at 700 W; PERF.md §6): 0.055-0.056 ms a call by device time
// at (28, 65536) and 0.042 ms at (1, 65536). The time is each
// thread's chain of dependent work, 19 rows of its 16 elements: a CTA
// alone on an SM (the 8 CTAs of a (1, 65536) call) takes three quarters of
// the time of two CTAs sharing one, 1024 threads a CTA cut the (1, 65536)
// call by a fifth (and slow the (28, 65536) one, whose CTAs then take two
// waves), and the atomics are about 5% of it. The design:
//  * one launch a call, no side work: the kernel finds each layer's lo and
//    hi itself, derives qmax from the ladder it takes by value, and writes
//    f32 counts to `out` (no scratch, memset or second kernel);
//  * a thread-block cluster of CLUSTER CTAs a layer (grid (CLUSTER, L)):
//    CTA c takes the c-th slice of ceil(n / CLUSTER) elements, loaded once
//    into shared memory by a 1-D bulk copy (an element path for the
//    slice's edges that are not 16-byte aligned); the CTAs exchange their
//    slices' min and max through distributed shared memory, so that every
//    CTA holds the same lo and span. A slice longer than SLICE elements is
//    read from device memory twice: once for min and max, once to bin, in
//    chunks of SLICE staged the same way. CLUSTER is 8, the largest
//    portable cluster: at n = 65536 a slice is 32 KB, and the 224 CTAs of
//    a (28, 65536) call fit the card at two CTAs an SM in one wave;
//  * rung after rung over the slice in shared memory, one shared-memory
//    atomic an element and row, in plain loops unrolled by 4 (count() says
//    what was tried instead);
//  * the narrow rungs (WL <= LEVEL_WL, at most 2^WL levels each, LEVELS
//    counters in all) count the integer level q + 2^(wl - 1); after the
//    pass each nonzero level is binned once and its count added to its
//    bin: the bin is a function of q, so the counts are the same. The
//    division stays only where it must: (v - lo) / span, once an element
//    for row 0 and each wide rung, once a level for the narrow ones;
//  * the cluster's counters summed through distributed shared memory,
//    each CTA a slice of the table over its CLUSTER peers in rank order:
//    integer sums, so the result does not depend on order or timing, and no
//    device-memory atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int NT = 512;             // threads a CTA
constexpr int CLUSTER = 8;          // CTAs a layer, one cluster
constexpr int SLICE = 8192;         // elements a CTA holds in shared memory
constexpr int LEVEL_WL = 12;        // rungs of WL <= LEVEL_WL count levels
constexpr int LEVELS = 8192;        // level counters a CTA
constexpr int MAX_T = 32;           // rungs of the ladder
constexpr int COUNT_INTS = 12288;   // (1 + T) x r_upr counters (48 KB)
constexpr int WARPS = NT / 32;

// The WL ladder and where each rung's level counters start (-1: the rung
// bins each element).
struct Ladder {
  int wl[MAX_T];
  int off[MAX_T];
};

using sm90::pow2i;
using sm90::recip_pow2i;

// A layer's bins: lo, span = max(hi - lo, 1e-12), rf live bins, rmax =
// rf - 1.
struct Bins {
  float lo, span, rf, rmax;
};

// clip(floor((v - lo) / span * rf), 0, rf - 1) as an int, or -1 for NaN.
__device__ __forceinline__ int bin_of(float v, const Bins& bn) {
  const float t = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(v, bn.lo), bn.span), bn.rf));
  if (isnan(t)) return -1;
  return (int)fminf(fmaxf(t, 0.0f), bn.rmax);
}

// clip(rint(v * s), qmn, qmx): the rung's level of v, an integer (v is not
// NaN: a layer holding a NaN is not counted).
__device__ __forceinline__ float level(float v, float s, float qmn, float qmx) {
  return fminf(fmaxf(rintf(__fmul_rn(v, s)), qmn), qmx);
}

// Elements [c0, c1) of the layer's row staged at the returned pointer:
// [a, b), whose addresses are 16-byte aligned, by one bulk copy; the head
// [c0, a) and the tail [b, c1) by the threads. `phase`: the flat element
// index g (from w) is 16-byte aligned when g % 4 == phase.
__device__ __forceinline__ float* stage(const float* row, long long g_row, int c0,
                                        int c1, int phase, float* buf, uint64_t* bar,
                                        uint32_t parity) {
  const int a = min(c0 + (int)((phase - (g_row + c0)) & 3), c1);
  const int b = a + ((c1 - a) & ~3);
  float* p = buf + ((c0 - a) & 3);  // p + (a - c0) is 16-byte aligned
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)(b - a) * 4u;
    sm90::mbar_arrive_expect_tx(bar, bytes);
    if (bytes) sm90::bulk_load(p + (a - c0), row + a, bytes, bar);
  }
  const int head = a - c0;
  const int k = threadIdx.x;
  if (k < head + (c1 - b)) {
    const int e = k < head ? k : (b - c0) + (k - head);
    p[e] = row[c0 + e];
  }
  sm90::mbar_wait(bar, parity);
  __syncthreads();
  return p;
}

struct MinMax {
  float mn, mx;
  int nan;
};

__device__ __forceinline__ void take(MinMax& m, float v) {
  if (isnan(v)) {
    m.nan = 1;
  } else {
    m.mn = fminf(m.mn, v);
    m.mx = fmaxf(m.mx, v);
  }
}

__device__ __forceinline__ void take_range(MinMax& m, const float* p, int len) {
  for (int k = threadIdx.x; k < len; k += NT) take(m, p[k]);
}

// The rungs' parameters, in shared memory: the ladder, each rung's level
// counters (off -1: the rung bins each element), 2^fl, 2^-fl and the clip.
struct Rungs {
  int wl[MAX_T], off[MAX_T];
  float scale[MAX_T], inv[MAX_T], qmn[MAX_T], qmx[MAX_T];
};

// Counts the `len` elements at p into cnt (row 0 and the wide rungs) and
// lev (the narrow rungs' levels), rung after rung, one shared-memory
// atomic an element and row, in plain loops unrolled by 4. Each way tried
// to issue fewer atomics took longer (merging a warp's equal counters by
// __match_any_sync 3.7x, by a shuffle and a vote 1.35x, counting levels
// -1, 0 and 1 in registers 1.3x; warp-uniform loops alone 1.2x), and
// neither rounding by magic-number adds nor deeper unrolling gained over
// 4% (tools/edf_ladder_variants.py).
__device__ __forceinline__ void count(const float* p, int len, int* cnt, int* lev,
                                      const Rungs& g, int T, int r_upr, const Bins& bn) {
#pragma unroll 4
  for (int k = threadIdx.x; k < len; k += NT) {
    const int b = bin_of(p[k], bn);
    if (b >= 0) atomicAdd(cnt + b, 1);
  }
  for (int t = 0; t < T; ++t) {
    const float s = g.scale[t], qmn = g.qmn[t], qmx = g.qmx[t];
    const int off = g.off[t];
    if (off >= 0) {
      int* tab = lev + off + (1 << (g.wl[t] - 1));   // level 0
#pragma unroll 4
      for (int k = threadIdx.x; k < len; k += NT)
        atomicAdd(tab + (int)level(p[k], s, qmn, qmx), 1);
      continue;
    }
    const float inv = g.inv[t];
    int* row = cnt + (1 + t) * r_upr;
#pragma unroll 4
    for (int k = threadIdx.x; k < len; k += NT) {
      const int b = bin_of(__fmul_rn(level(p[k], s, qmn, qmx), inv), bn);
      if (b >= 0) atomicAdd(row + b, 1);
    }
  }
}

__global__ void __launch_bounds__(NT, 2)
edf_ladder_kernel(const float* __restrict__ w, const int* __restrict__ fls,
                  const int* __restrict__ r, float* __restrict__ out, int n, int T,
                  int r_upr, int levels, Ladder lad) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint64_t bar;
  __shared__ Rungs g;
  __shared__ float wmn[WARPS], wmx[WARPS];
  __shared__ int wnan[WARPS];
  __shared__ float red[2];
  __shared__ int red_nan;

  const int tid = threadIdx.x, l = blockIdx.y;
  const uint32_t rank = sm90::cluster_rank();
  const int rows = 1 + T, total = rows * r_upr;
  const int S = (n + CLUSTER - 1) / CLUSTER;
  const bool fits = S <= SLICE;
  // 64-bit sums: n may be as large as 2^31 - 1
  const int start = (int)min((long long)rank * S, (long long)n);
  const int end = (int)min((long long)start + S, (long long)n);
  // shared memory: the slice, the level counters, the count table
  float* buf = reinterpret_cast<float*>(smem);
  int* lev = reinterpret_cast<int*>(buf + (n > 0 ? min(S, SLICE) + 4 : 0));
  int* cnt = lev + levels;
  const float* row = w + (long long)l * n;
  const long long g_row = (long long)l * n;
  const int phase = (int)((0u - (uint32_t)(reinterpret_cast<uintptr_t>(w) >> 2)) & 3u);

  if (tid == 0) {
    sm90::mbar_init(&bar, 1);
    sm90::fence_barrier_init();
  }
  for (int j = tid; j < levels + total; j += NT) lev[j] = 0;  // lev, then cnt
  if (tid < T) {
    const int fl = fls[l * T + tid];
    const float q = __double2float_rn(ldexp(1.0, lad.wl[tid] - 1) - 1.0);
    g.wl[tid] = lad.wl[tid];
    g.off[tid] = lad.off[tid];
    g.scale[tid] = pow2i(fl);
    g.inv[tid] = recip_pow2i(fl);
    g.qmx[tid] = q;
    g.qmn[tid] = __fsub_rn(-q, 1.0f);
  }
  __syncthreads();

  // this slice's min and max: from the staged slice, or streamed
  MinMax m = {INFINITY, -INFINITY, 0};
  const float* p = nullptr;
  uint32_t parity = 0;
  if (fits) {
    p = stage(row, g_row, start, end, phase, buf, &bar, parity);
    parity ^= 1u;
    take_range(m, p, end - start);
  } else {
    take_range(m, row + start, end - start);
  }
  for (int o = 16; o > 0; o >>= 1) {
    m.mn = fminf(m.mn, __shfl_xor_sync(0xffffffffu, m.mn, o));
    m.mx = fmaxf(m.mx, __shfl_xor_sync(0xffffffffu, m.mx, o));
    m.nan |= __shfl_xor_sync(0xffffffffu, m.nan, o);
  }
  if ((tid & 31) == 0) {
    wmn[tid >> 5] = m.mn;
    wmx[tid >> 5] = m.mx;
    wnan[tid >> 5] = m.nan;
  }
  __syncthreads();
  if (tid == 0) {
    MinMax c = {INFINITY, -INFINITY, 0};
    for (int i = 0; i < WARPS; ++i) {
      c.mn = fminf(c.mn, wmn[i]);
      c.mx = fmaxf(c.mx, wmx[i]);
      c.nan |= wnan[i];
    }
    red[0] = c.mn;
    red[1] = c.mx;
    red_nan = c.nan;
  }
  // the layer's lo and hi from the cluster's slices, in rank order
  sm90::cluster_sync();
  float lo = INFINITY, hi = -INFINITY;
  int dead = 0;
  for (uint32_t c = 0; c < CLUSTER; ++c) {
    lo = fminf(lo, sm90::ld_peer_f32(&red[0], c));
    hi = fmaxf(hi, sm90::ld_peer_f32(&red[1], c));
    dead |= sm90::ld_peer_s32(&red_nan, c);
  }
  Bins bn;
  bn.lo = lo;
  bn.span = fmaxf(__fsub_rn(hi, lo), 1e-12f);
  bn.rf = (float)min(r[l], r_upr);
  bn.rmax = __fsub_rn(bn.rf, 1.0f);

  if (!dead) {  // a NaN in the layer: every bin NaN, nothing counted
    if (fits) {
      count(p, end - start, cnt, lev, g, T, r_upr, bn);
    } else {
      for (long long c = start; c < end; c += SLICE) {
        const int c0 = (int)c, c1 = (int)min(c + SLICE, (long long)end);
        p = stage(row, g_row, c0, c1, phase, buf, &bar, parity);
        parity ^= 1u;
        count(p, c1 - c0, cnt, lev, g, T, r_upr, bn);
        // the reads of this chunk before the next bulk copy rewrites it
        sm90::fence_proxy_async();
        __syncthreads();
      }
    }
    __syncthreads();
    // each nonzero level of a narrow rung binned once
    for (int t = 0; t < T; ++t) {
      const int off = g.off[t];
      if (off < 0) continue;
      const int half = 1 << (g.wl[t] - 1);
      const float inv = g.inv[t];
      int* dst = cnt + (1 + t) * r_upr;
      for (int k = tid; k < 2 * half; k += NT) {
        const int c = lev[off + k];
        if (c == 0) continue;
        const int b = bin_of(__fmul_rn((float)(k - half), inv), bn);
        if (b >= 0) atomicAdd(dst + b, c);
      }
    }
  }

  // the cluster's counters summed, each CTA a slice of the table
  sm90::cluster_sync();
  const int per = (total + CLUSTER - 1) / CLUSTER;
  const int j1 = min(((int)rank + 1) * per, total);
  float* o = out + (long long)l * total;
  for (int j = (int)rank * per + tid; j < j1; j += NT) {
    int s = 0;
    for (uint32_t c = 0; c < CLUSTER; ++c) s += sm90::ld_peer_s32(cnt + j, c);
    o[j] = (float)s;
  }
  // no CTA leaves while a peer may still read its counters
  sm90::cluster_sync();
}

}  // namespace

extern "C" {

// out (L, 1+T, r_upr) f32 from w (L, n) f32, fls (L, T) int32 and r (L,)
// int32 on the device, and the ladder wl (T,) int32 on the host (T <=
// MAX_T, (1 + T) * r_upr <= COUNT_INTS). Returns cudaGetLastError().
int edf_ladder_launch(const void* w, const void* fls, const void* r, void* out,
                      int L, int n, int T, const int* wl, int r_upr, void* stream) {
  if (L <= 0 || T < 0 || r_upr <= 0) return (int)cudaGetLastError();
  if (L > 65535 || n < 0 || T > MAX_T || (1 + T) * r_upr > COUNT_INTS)
    return (int)cudaErrorInvalidValue;
  Ladder lad;
  int levels = 0;
  for (int t = 0; t < T; ++t) {
    lad.wl[t] = wl[t];
    const bool narrow = wl[t] >= 1 && wl[t] <= LEVEL_WL && levels + (1 << wl[t]) <= LEVELS;
    lad.off[t] = narrow ? levels : -1;
    if (narrow) levels += 1 << wl[t];
  }
  const int S = (n + CLUSTER - 1) / CLUSTER;
  const size_t slice = n > 0 ? (size_t)(S < SLICE ? S : SLICE) + 4 : 0;
  const size_t smem = 4 * (slice + levels + (size_t)(1 + T) * r_upr);
  cudaError_t err = sm90::allow_smem<edf_ladder_kernel>(
      4 * ((size_t)SLICE + 4 + LEVELS + COUNT_INTS));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, L, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, edf_ladder_kernel, static_cast<const float*>(w),
                           static_cast<const int*>(fls), static_cast<const int*>(r),
                           static_cast<float*>(out), n, T, r_upr, levels, lad);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"

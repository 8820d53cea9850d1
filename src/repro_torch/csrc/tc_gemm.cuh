// The consumer side shared by the warp-specialised wgmma GEMMs
// (matmul_qdx_tc and fxp_qmatmul_tc in fxp_qmatmul.cu, matmul_dx_tc in
// fxp_matmul_bwd.cu). Their producers differ (words drawn from a master or
// converted from int8, with or without a cluster peer); what a consumer
// warpgroup does with a filled stage does not:
//  * `consume`: 128 rows x 64 columns of the output as two m64n64k16 bf16
//    products per 16-wide step, A K-major and B K-major or MN-major, read
//    from a ring of STAGES shared-memory stages of 64 along the
//    contraction. wgmma's f32 accumulation rounds toward zero, so the
//    accumulators restart every PROMOTE steps and are added into `tot`
//    with round-to-nearest. A step waits for the previous step's products
//    only, and the last step before a promotion for its own; a stage is
//    released once the products that read it are done. ptxas sees two
//    wait depths on the loop's paths and serialises the products (warning
//    C7517). Nested loops of PROMOTE steps with one depth at the back edge
//    avoid that, but timed no faster for matmul_dx_tc and fxp_qmatmul_tc
//    and slower for matmul_qdx_tc (PERF.md section 7).
//  * `store_tile`: the totals, times a scale (round-to-nearest), into a
//    row-major output, masked at its edges.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace tc_gemm {

constexpr int BK = 64;      // contraction step: one 128-byte swizzled row
constexpr int ROWS = 128;   // output rows of a consumer warpgroup
constexpr int COLS = 64;    // output columns
constexpr int ACC = 32;     // f32 accumulators of an m64n64 product a thread

// D += A * B over one 16-wide step, A K-major; B K-major (`MN` false, rows
// of B along N) or MN-major (`MN` true, rows along the contraction).
template <bool MN>
__device__ __forceinline__ void product(float (&d)[ACC], uint64_t da, uint64_t db,
                                        int keep) {
  if constexpr (MN)
    sm90::wgmma_ss_n64_mn(d, da, db, keep);
  else
    sm90::wgmma_ss_n64(d, da, db, keep);
}

// `At`, `Bt`: stage 0 of this warpgroup's A rows and of the B tile, each
// stage `a_stride` / `b_stride` elements on. `wait_full(s, parity)` waits
// until stage s is filled; `release(s)` is called by every thread of the
// warpgroup once the products that read stage s are done.
template <bool MN, int STAGES, int PROMOTE, typename WaitFull, typename Release>
__device__ __forceinline__ void consume(float (&tot)[2][ACC], const __nv_bfloat16* At,
                                        int a_stride, const __nv_bfloat16* Bt, int b_stride,
                                        int n_steps, WaitFull wait_full, Release release) {
  float acc[2][ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[0][i] = acc[1][i] = tot[0][i] = tot[1][i] = 0.f;
  int pending = -1;                         // a stage whose products may run
  for (int j = 0; j < n_steps; ++j) {
    const int s = j % STAGES;
    const bool first = j % PROMOTE == 0;
    const bool last = j % PROMOTE == PROMOTE - 1 || j == n_steps - 1;
    wait_full(s, (j / STAGES) & 1);
    const __nv_bfloat16* A = At + s * a_stride;
    const __nv_bfloat16* B = Bt + s * b_stride;
    sm90::fence_regs(acc[0]);
    sm90::fence_regs(acc[1]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = MN ? sm90::desc128(B + kk * 16 * 64, 2 * BK * 64, 1024)
                             : sm90::desc128(B + kk * 16, 16, 1024);
      const int keep = !(first && kk == 0);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        product<MN>(acc[mt], sm90::desc128(A + mt * 64 * BK + kk * 16, 16, 1024), db, keep);
    }
    sm90::wgmma_commit();
    if (last)
      sm90::wgmma_wait<0>();
    else
      sm90::wgmma_wait<1>();
    sm90::fence_regs(acc[0]);
    sm90::fence_regs(acc[1]);
    if (pending >= 0) release(pending);
    pending = s;
    if (last) {
      release(s);
      pending = -1;
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        tot[0][i] += acc[0][i];
        tot[1][i] += acc[1][i];
      }
    }
  }
}

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}
// Two consecutive outputs at an even element offset in one store.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// out[r][c] = tot * scale for the warpgroup's rows row0 .. row0 + 127 and
// columns col0 .. col0 + 63 (the wgmma fragment layout, thread t of the
// warpgroup), of an output with `rows` x `cols` elements and row stride
// `cols`.
template <typename TO>
__device__ __forceinline__ void store_tile(const float (&tot)[2][ACC], float scale, TO* out,
                                           int rows, int cols, int row0, int col0, int t) {
  const int lane = t % 32, warp = t / 32, g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + mt * 64 + warp * 16 + g + 8 * rr;
      if (row >= rows) continue;
      TO* o = out + (size_t)row * cols;
#pragma unroll
      for (int jb = 0; jb < COLS / 8; ++jb) {
        const int col = col0 + 8 * jb + 2 * tig;
        const float v0 = __fmul_rn(tot[mt][4 * jb + 2 * rr], scale);
        const float v1 = __fmul_rn(tot[mt][4 * jb + 2 * rr + 1], scale);
        if (cols % 2 == 0 && col + 1 < cols) {   // the pair in one store
          store2(o + col, v0, v1);
        } else {
          if (col < cols) store1(o + col, v0);
          if (col + 1 < cols) store1(o + col + 1, v1);
        }
      }
    }
  }
}

}  // namespace tc_gemm

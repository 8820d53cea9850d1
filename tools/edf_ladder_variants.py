#!/usr/bin/env python3
"""Time variants of the EDF-ladder kernel's counting step on one H100.

Each variant is the shipped ``src/repro_torch/csrc/edf_ladder.cu`` with one
change made to its text, built with the port's nvcc flags under
``build/edf_variants/<name>/`` and called through its C entry point at the
shapes of a llama3.2-3b switch, (28, 65536) and (1, 65536), with the
range-derived FLs and live bins in [50, 150]. It prints, and writes to
``chiprun_out/edf_variants.json``, each variant's device time of one call
(CUDA-graph replay, as ``chip_smoke.graph_time_ms``) and whether its counts
equal the plain version's:

* ``shipped``: the source as it is;
* ``magic_adds``: rint and floor of the clipped values by adding 1.5·2^23
  (rounded to nearest) and 2^23 (rounded toward zero), full-rate adds in
  place of the quarter-rate conversion unit (the same integers);
* ``warp_loop``: every lane of a warp runs the same iterations (a lane
  past the end with no counter), not unrolled;
* ``match_any``: as ``warp_loop``, and each warp merges equal counters
  with ``__match_any_sync``, its lowest lane adding their ``__popc``;
* ``uniform_vote``: on the narrow rungs, one atomic for the whole warp
  where a shuffle and a vote find every lane on one level;
* ``central_vote``: on the narrow rungs, levels -1, 0 and 1 counted in
  10-bit fields of a register, the atomic skipped by a vote where no lane
  needs it;
* ``no_atomics``: the counting step with its atomics taken out (not
  equal: how long the arithmetic alone takes);
* ``nt1024``: 1024 threads a CTA, one CTA an SM;
* ``unroll8``, ``unroll16``: the counting loops unrolled by 8 and 16;
* ``bin_each``: no level counters, every rung bins each element.

    python3 tools/edf_ladder_variants.py
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

WARP_LOOP = """
// Adds 1 to tab[key] for each lane whose key is >= 0; every lane of the
// warp calls it.
__device__ __forceinline__ void add_once(int* tab, int key) {
#if MERGE
  const uint32_t live = __ballot_sync(0xffffffffu, key >= 0);
  if (key >= 0) {
    const uint32_t peers = __match_any_sync(live, key);
    if ((peers & ((1u << (threadIdx.x & 31u)) - 1u)) == 0u) atomicAdd(tab + key, __popc(peers));
  }
#else
  if (key >= 0) atomicAdd(tab + key, 1);
#endif
}

__device__ __forceinline__ void count(const float* p, int len, int* cnt, int* lev,
                                      const Rungs& g, int T, int r_upr, const Bins& bn) {
  const int lane = threadIdx.x & 31, first = threadIdx.x & ~31;
  for (int k0 = first; k0 < len; k0 += NT) {
    const int k = k0 + lane;
    add_once(cnt, k < len ? bin_of(p[k], bn) : -1);
  }
  for (int t = 0; t < T; ++t) {
    const float s = g.scale[t], qmn = g.qmn[t], qmx = g.qmx[t];
    const int off = g.off[t];
    if (off >= 0) {
      const int base = off + (1 << (g.wl[t] - 1));
      for (int k0 = first; k0 < len; k0 += NT) {
        const int k = k0 + lane;
        add_once(lev, k < len ? base + (int)level(p[k], s, qmn, qmx) : -1);
      }
      continue;
    }
    const float inv = g.inv[t];
    int* row = cnt + (1 + t) * r_upr;
    for (int k0 = first; k0 < len; k0 += NT) {
      const int k = k0 + lane;
      add_once(row, k < len ? bin_of(__fmul_rn(level(p[k], s, qmn, qmx), inv), bn) : -1);
    }
  }
}
"""
UNIFORM = """
__device__ __forceinline__ void add_uniform(int* tab, int key) {
  const unsigned m = __activemask();
  const int k0 = __shfl_sync(m, key, __ffs(m) - 1);
  if (__all_sync(m, key == k0)) {
    if ((int)(threadIdx.x & 31) == __ffs(m) - 1) atomicAdd(tab + k0, __popc(m));
  } else {
    atomicAdd(tab + key, 1);
  }
}
"""
NARROW = "atomicAdd(tab + (int)level(p[k], s, qmn, qmx), 1);"
NARROW_LOOP = ("#pragma unroll 4\n      for (int k = threadIdx.x; k < len; k += NT)\n"
               "        " + NARROW + "\n")
CENTRAL = """      const int lane = threadIdx.x & 31, first = threadIdx.x & ~31;
      uint32_t central = 0;
      for (int k0 = first; k0 < len; k0 += NT) {
        const int k = k0 + lane;
        const bool ok = k < len;
        const int q = (int)level(ok ? p[k] : 0.0f, s, qmn, qmx);
        const uint32_t d = (uint32_t)(q + 1);
        const bool in = ok && d <= 2u;
        central += in ? 1u << (10u * d) : 0u;
        const bool need = ok && !in;
        if (__any_sync(0xffffffffu, need)) {
          if (need) atomicAdd(tab + q, 1);
        }
      }
      central = __reduce_add_sync(0xffffffffu, central);
      if (lane == 0)
        for (int j = 0; j < 3; ++j) {
          const int c = (int)((central >> (10 * j)) & 1023u);
          if (c) atomicAdd(tab - 1 + j, c);
        }
"""
BIN_REF = """  const float t = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(v, bn.lo), bn.span), bn.rf));
  if (isnan(t)) return -1;
  return (int)fminf(fmaxf(t, 0.0f), bn.rmax);"""
# floor of the clipped value by y + 2^23 rounded toward zero; rint of the
# clipped value by y + 1.5 * 2^23 (exact for |y| <= 2^22; the clip to
# integer bounds commutes with both)
BIN_MAGIC = """  const float t = __fmul_rn(__fdiv_rn(__fsub_rn(v, bn.lo), bn.span), bn.rf);
  if (isnan(t)) return -1;
  return __float_as_int(__fadd_rz(fminf(fmaxf(t, 0.0f), bn.rmax), 8388608.0f)) - 0x4B000000;"""
LEVEL_REF = "  return fminf(fmaxf(rintf(__fmul_rn(v, s)), qmn), qmx);"
LEVEL_MAGIC = """  if (qmx < 0.0f || qmx >= 4194304.0f) return fminf(fmaxf(rintf(__fmul_rn(v, s)), qmn), qmx);
  return __fsub_rn(__fadd_rn(fminf(fmaxf(__fmul_rn(v, s), qmn), qmx), 12582912.0f), 12582912.0f);"""


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"edf_ladder_variants: the source has changed: {old[:60]!r}")
    return src.replace(old, new)


def _count_span(src: str) -> tuple[int, int]:
    i = src.index("__device__ __forceinline__ void count(")
    return i, src.index("__global__ void __launch_bounds__(NT, 2)", i)


def variants(src: str) -> dict:
    out = {"shipped": src}
    out["magic_adds"] = _replace(_replace(src, BIN_REF, BIN_MAGIC), LEVEL_REF, LEVEL_MAGIC)
    i, j = _count_span(src)
    out["warp_loop"] = src[:i] + "#define MERGE 0\n" + WARP_LOOP + "\n" + src[j:]
    out["match_any"] = src[:i] + "#define MERGE 1\n" + WARP_LOOP + "\n" + src[j:]
    s = _replace(src, "// Elements [c0, c1) of the layer's row staged",
                 UNIFORM + "\n// Elements [c0, c1) of the layer's row staged")
    out["uniform_vote"] = _replace(s, NARROW,
                                   "add_uniform(tab, (int)level(p[k], s, qmn, qmx));")
    out["central_vote"] = _replace(src, NARROW_LOOP, CENTRAL)
    body = _replace(src[i:j], NARROW,
                    "if ((int)level(p[k], s, qmn, qmx) == -1 << 30) atomicAdd(tab, 1);")
    body = body.replace("if (b >= 0) atomicAdd(", "if (b == -7) atomicAdd(")
    out["no_atomics"] = src[:i] + body + src[j:]
    s = _replace(src, "constexpr int NT = 512;", "constexpr int NT = 1024;")
    out["nt1024"] = _replace(s, "__launch_bounds__(NT, 2)", "__launch_bounds__(NT, 1)")
    out["unroll8"] = _replace(src, "#pragma unroll 4", "#pragma unroll 8")
    out["unroll16"] = _replace(src, "#pragma unroll 4", "#pragma unroll 16")
    out["bin_each"] = _replace(src, "constexpr int LEVEL_WL = 12;", "constexpr int LEVEL_WL = 0;")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("edf_ladder_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import pushdown
    from repro_torch.kernels import _build
    from repro_torch.kernels import edf_ladder as el

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    src = (_build.CSRC / "edf_ladder.cu").read_text()
    procs = {}
    for name, text in variants(src).items():
        d = _build.BUILD_DIR.parent / "edf_variants" / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(_build.CSRC / "sm90.cuh", d / "sm90.cuh")
        (d / "edf_ladder.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "edf_ladder.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (d, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{report}")
        fn = ctypes.CDLL(str(d / "lib.so")).edf_ladder_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 3 + [ctypes.POINTER(ctypes.c_int), i, p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    ladder = pushdown.WL_LADDER
    T = len(ladder)
    wl = (ctypes.c_int * T)(*ladder)
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"card": card, "rows": []}
    for L in (cs.N_LAYERS, 1):
        w = torch.randn(L, cs.EDF_SAMPLE, generator=gen, device="cuda") * 0.02
        fls = cs.edf_inputs(torch, w).contiguous()
        r = torch.randint(50, 151, (L,), generator=gen, device="cuda",
                          dtype=torch.int32)
        want = el.plain(w, fls, r, wl_ladder=ladder, r_upr=150)
        for name, fn in fns.items():
            out = torch.empty((L, 1 + T, 150), device="cuda")

            def call(fn=fn, out=out):
                err = fn(w.data_ptr(), fls.data_ptr(), r.data_ptr(),
                         out.data_ptr(), L, cs.EDF_SAMPLE, T, wl, 150,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            row = {"variant": name, "shape": [L, cs.EDF_SAMPLE],
                   "device_ms": cs.graph_time_ms([call], 20),
                   "bit_equal": bool(torch.equal(out, want))}
            res["rows"].append(row)
            print(f"{name:16s} ({L}, {cs.EDF_SAMPLE}): device_ms="
                  f"{row['device_ms']:.4f} bit_equal={row['bit_equal']}",
                  flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "edf_variants.json").write_text(json.dumps(res, indent=1))
    bad = [r for r in res["rows"] if not r["bit_equal"]
           and r["variant"] != "no_atomics"]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())

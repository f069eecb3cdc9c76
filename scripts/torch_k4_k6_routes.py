#!/usr/bin/env python3
"""K4's and K6's warp routes against their first designs on one NVIDIA GPU,
with the measurements behind the warp routes' constants.

* K4's warp route built from ``pde_tpu_torch/csrc/cn1d_fused.cu`` (with the
  flags of ``pde_tpu_torch/ops/build.py``, into
  ``build/pde_tpu_torch/variants/``) at 1, 2, 4 and 8 options a block
  (``kTile``), timed in turns on the Black-Scholes book (B = 512, 200x100,
  all American).
* K4's factors seven ways, each timed at one step and at 100 steps on the
  book, and held against the first design (which equals the plain twin
  bit for bit) at the kernel gate 1e-5 + 1e-4 |plain| at n = 200 and 512,
  w = 0.5 and 1, European and all American: the source (each lane walks
  the serial pivot chain up to its chunk and stops where the chain
  reaches a float fixed point), builds that walk the chain to the end,
  that reconverge the warp after it (``__syncwarp``), that walk it with
  every lane of the warp together, that take the factor entering each
  chunk from a Moebius-map scan in float or in double, and one with no
  chain at all (the factor entering
  each chunk 0: wrong factors, built for timing only), so that each
  chain's share of the march reads as a difference.
* Both designs of K4 (B = 512, 100 steps, all American) and of K6 (B = 1
  and 512, 60 sweeps from a start) at n = 200, 256, 300, 400 and 512, in
  the order warp, first, first, warp, each with the largest difference
  between the two designs' results (K4: over the kernel gate; K6:
  absolute).  K6's warp route stops at n = 256; above it, a build of
  ``psor_batched.cu`` with a 16-row register chunk stands in for it.
* ``bs_pde.solve`` (American put, PSOR, 200x100) with K6 on its warp route
  and on its first design (the route plan forced to None), in the order
  warp, first, first, warp: the card's busy time of one call under
  ``torch.profiler`` and the median unprofiled wall of five;
  ``heston_adi.solve`` profiled before and after them, as a control of the
  profiler's readings within one process.

The times are the card's alone (``chip_smoke.kernel_ms``: CUDA events, a
spin kernel holding the stream while the host enqueues).  One JSON line per
measurement, then the card's ``nvidia-smi`` name and power limit.  Run from
the repository root:

    python3 scripts/torch_k4_k6_routes.py
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (its timing, profiling and input helpers)

TILE = "constexpr int kTile = 4;"
EXIT = "      if (cn == cp) break;\n"
CHAIN = ("    float cp = 0.f;\n"
         "    for (int i = 1; i < min(i0, n - 1); ++i) {\n"
         "      const float cn = ui * (1.f / (di - li * cp));\n"
         "      if (cn == cp) break;\n"
         "      cp = cn;\n"
         "    }\n")
WARP = "// The warp route: one warp per option, CH >= ceil(n / 32)"
# the factor entering each chunk from a warp scan of the pivot maps c ->
# u / (d - l c), [[0, u], [-l, d]] on (c, 1) (rows 0 and n-1: c = 0), in T
MOEBIUS = r"""template <typename T>
__device__ __forceinline__ void normalise_t(T& a, T& b, T& c, T& d) {
  const T s = T(1) / fmax(fmax(fabs(a), fabs(b)), fmax(fabs(c), fabs(d)));
  a *= s;
  b *= s;
  c *= s;
  d *= s;
}

template <typename T, int CH>
__device__ __forceinline__ float pivot_entering(const bool (&used)[CH],
                                                const bool (&inner)[CH], float li,
                                                float di, float ui, int lane) {
  T ga = 1, gb = 0, gc = 0, gd = 1;
#pragma unroll
  for (int j = 0; j < CH; ++j)
    if (used[j]) {
      const T l = inner[j] ? li : 0.f, d = inner[j] ? di : 1.f, u = inner[j] ? ui : 0.f;
      const T na = u * gc, nb = u * gd, nc = d * gc - l * ga, nd = d * gd - l * gb;
      ga = na;
      gb = nb;
      gc = nc;
      gd = nd;
      normalise_t(ga, gb, gc, gd);
    }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T ea = __shfl_up_sync(kFull, ga, off), eb = __shfl_up_sync(kFull, gb, off);
    const T ec = __shfl_up_sync(kFull, gc, off), ed = __shfl_up_sync(kFull, gd, off);
    if (lane >= off) {
      const T na = ga * ea + gb * ec, nb = ga * eb + gb * ed;
      const T nc = gc * ea + gd * ec, nd = gc * eb + gd * ed;
      ga = na;
      gb = nb;
      gc = nc;
      gd = nd;
      normalise_t(ga, gb, gc, gd);
    }
  }
  const T pb = __shfl_up_sync(kFull, gb, 1), pd = __shfl_up_sync(kFull, gd, 1);
  return lane >= 1 ? static_cast<float>(pb / pd) : 0.f;
}

"""
# the same chain walked by every lane of the warp together (it is the same
# in every lane) to its fixed point, each lane keeping the factor that
# enters its chunk: no lane leaves the loop before the others
UNIFORM = ("    float cw = 0.f, cp = 0.f;\n"
           "    bool set = i0 <= 1;\n"
           "    for (int i = 1; i < n - 1; ++i) {\n"
           "      const float cn = ui * (1.f / (di - li * cw));\n"
           "      if (cn == cw) break;\n"
           "      cw = cn;\n"
           "      if (i == i0 - 1) {\n"
           "        cp = cw;\n"
           "        set = true;\n"
           "      }\n"
           "    }\n"
           "    if (!set) cp = cw;\n")
K6_CH = "constexpr int kMaxCh = 8;"
SIZES = (200, 256, 300, 400, 512)


def variant_sources():
    """{name: (source file, text)}: K4 at 1, 2, 4 and 8 options a block; K4
    with its factor chain walked to the end, followed by a __syncwarp(),
    walked by the warp's lanes together, with none, and replaced by a
    Moebius scan in float and in double; K6 with a 16-row chunk."""
    from pde_tpu_torch.ops import build

    k4 = (build.CSRC / "cn1d_fused.cu").read_text()
    k6 = (build.CSRC / "psor_batched.cu").read_text()
    if (k4.count(TILE) != 1 or k4.count(CHAIN) != 1 or k4.count(WARP) != 1
            or k6.count(K6_CH) != 1):
        raise RuntimeError("the sources no longer have the lines this script rewrites")
    out = {f"tile{t}": ("cn1d_fused.cu", k4.replace(TILE, f"constexpr int kTile = {t};"))
           for t in (1, 2, 4, 8)}
    out["serial"] = ("cn1d_fused.cu", k4.replace(EXIT, ""))
    out["no_chain"] = ("cn1d_fused.cu", k4.replace(CHAIN, "    float cp = 0.f;\n"))
    out["syncwarp"] = ("cn1d_fused.cu", k4.replace(CHAIN, CHAIN + "    __syncwarp();\n"))
    out["uniform"] = ("cn1d_fused.cu", k4.replace(CHAIN, UNIFORM))
    for name, T in (("scan32", "float"), ("scan64", "double")):
        out[name] = ("cn1d_fused.cu", k4.replace(WARP, MOEBIUS + WARP).replace(
            CHAIN, f"    float cp = pivot_entering<{T}>(used, inner, li, di, ui, lane);\n"))
    out["k6_ch16"] = ("psor_batched.cu", k6.replace(K6_CH, "constexpr int kMaxCh = 16;"))
    return out


def build_variants(sources):
    """Compile each source (all ``nvcc`` processes at once) with its file's
    flags: {name: (library, ptxas lines)}."""
    from pde_tpu_torch.ops import build

    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (file, text) in sources.items():
        cu, so = out_dir / f"{name}-{file}", out_dir / f"{name}.so"
        cu.write_text(text)
        flags = build.NVCC_FLAGS + build.SOURCE_FLAGS.get(file, ())
        jobs[name] = (so, subprocess.Popen([build._nvcc(), *flags, "-o", str(so), str(cu)],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = (ctypes.CDLL(str(so)), [ln.strip() for ln in log.splitlines()
                                            if "registers" in ln or "spill" in ln])
    return libs


def k4_entry(lib):
    fn = lib.pde_cn1d_fused_warp
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def in_turns(torch, calls, order, reps=20):
    """{name: [card ms, ...]} over ``order``, each reading ``reps`` calls."""
    out = {}
    for name in order:
        out.setdefault(name, []).append(cs.kernel_ms(torch, calls[name], reps))
    return out


def phase_k4_variants(torch, dev, libs):
    from pde_tpu_torch.ops import cn1d_fused

    B, n, nT = cs.BS_B, cs.BS_GRID["n_space"], cs.BS_GRID["n_time"]

    def call(name, pay, sc, m, steps, w=0.5):
        fn = k4_entry(libs[name][0])
        V = torch.empty((m, B), device=dev)

        def run():
            err = fn(pay.data_ptr(), sc.data_ptr(), V.data_ptr(), B, m, steps, w,
                     torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise RuntimeError(f"variant {name}: CUDA error {err}")
            return V
        return run

    book = cs.bs_inputs(torch, dev, B, torch.ones(B, device=dev))
    tiles = ("tile1", "tile2", "tile4", "tile8")
    ms = in_turns(torch, {t: call(t, *book, n, nT) for t in tiles}, tiles + tiles[::-1])
    for t in tiles:
        cs.emit(phase="k4_options_a_block", options=int(t[4:]), B=B, grid=[n, nT],
                ms=ms[t], mean_ms=statistics.fmean(ms[t]), ptxas=libs[t][1])
    # the factors: the source's chain, which stops at its fixed point
    # ("tile4"), the chain walked to the end, with a __syncwarp() after it,
    # walked by the lanes together, none, and the Moebius scans
    kinds = ("tile4", "serial", "syncwarp", "uniform", "no_chain", "scan32", "scan64")
    order = kinds + kinds[::-1]
    one = in_turns(torch, {k: call(k, *book, n, 1) for k in kinds}, order)
    full = in_turns(torch, {k: call(k, *book, n, nT) for k in kinds}, order)
    worst = dict.fromkeys(kinds, 0.0)
    for m in (n, 512):
        for amer in (torch.zeros(B, device=dev), torch.ones(B, device=dev)):
            ins = cs.bs_inputs(torch, dev, B, amer, dict(n_space=m, n_time=nT))
            for w in (0.5, 1.0):
                F = cn1d_fused._launch_first(*ins, m, nT, w)
                for k in kinds:
                    W = call(k, *ins, m, nT, w)()
                    worst[k] = max(worst[k], float(
                        ((W - F).abs() / (cs.ATOL + cs.RTOL * F.abs())).max()))
    mean = lambda d, k: statistics.fmean(d[k])  # noqa: E731
    for k in kinds:
        march = mean(full, k)
        step = (march - mean(one, k)) / (nT - 1)
        cs.emit(phase="k4_factors", factors={"tile4": "chain_to_fixed_point"}.get(k, k),
                B=B, grid=[n, nT], one_step_ms=one[k], march_ms=full[k],
                set_up_share=(mean(one, k) - step) / march,
                chain_share=(mean(one, k) - mean(one, "no_chain")) / march,
                max_over_gate_vs_first=worst[k], ptxas=libs[k][1])


def phase_k4_routes(torch, dev, B=cs.BS_B, nT=cs.BS_GRID["n_time"]):
    from pde_tpu_torch.ops import cn1d_fused

    for n in SIZES:
        pay, sc = cs.bs_inputs(torch, dev, B, torch.ones(B, device=dev),
                               dict(n_space=n, n_time=nT))
        calls = {"warp": lambda: cn1d_fused._launch_warp(pay, sc, n, nT, 0.5),
                 "first": lambda: cn1d_fused._launch_first(pay, sc, n, nT, 0.5)}
        ms = in_turns(torch, calls, ("warp", "first", "first", "warp"))
        W, F = calls["warp"](), calls["first"]()
        over = float(((W - F).abs() / (cs.ATOL + cs.RTOL * F.abs())).max())
        cs.emit(phase="k4_routes", n=n, B=B, n_time=nT, ch=-(-n // 32), warp_ms=ms["warp"],
                first_ms=ms["first"], warp_over_first=statistics.fmean(ms["warp"])
                / statistics.fmean(ms["first"]), max_over_gate_vs_first=over)


def phase_k6_routes(torch, dev, libs, n_iter=cs.PSOR_ITERS[0]):
    from pde_tpu_torch.solvers import lcp

    source = lcp._warp_library
    ch16 = libs["k6_ch16"][0].pde_psor_warp
    ch16.argtypes, ch16.restype = source().argtypes, source().restype
    for B in (1, 512):
        for n in SIZES:
            *system, x0 = cs.seeded_lcp(torch, dev, B, n, seed=n + B)
            build = "source" if lcp._warp_plan(n) is not None else "k6_ch16"
            lcp._warp_library = source if build == "source" else (lambda: ch16)
            try:
                warp, x, _ = lcp._warp_launcher(*system, x0, 1.5, n_iter)
            finally:
                lcp._warp_library = source
            first, xf = lcp._first_launcher(*system, x0, 1.5, n_iter)
            if warp() != 0:
                raise RuntimeError(f"K6's warp route ({build}) refused n = {n}")
            ms = in_turns(torch, {"warp": warp, "first": first},
                          ("warp", "first", "first", "warp"))
            cs.emit(phase="k6_routes", n=n, B=B, n_iter=n_iter, ch=2 * -(-n // 64),
                    warp_build=build, warp_ms=ms["warp"], first_ms=ms["first"],
                    warp_over_first=statistics.fmean(ms["warp"])
                    / statistics.fmean(ms["first"]),
                    max_abs_first_vs_warp=float((x - xf).abs().max()))


def phase_bs_solve(torch, dev, walls=5):
    from pde_tpu_torch.solvers import bs_pde, heston_adi, lcp

    p = bs_pde.BSPDEParams(is_call=False, american=True, american_method="psor",
                           **cs.BS_GRID)
    k6 = lcp.projected_sor_batched
    plan = lcp._warp_plan

    def control(when):
        wall, dev_us = cs.profiled(torch, dev, lambda: heston_adi.solve(
            cs.heston_params(), 100.0, device=dev))
        cs.emit(phase="heston_adi_solve_profile", when=when, wall_s=wall,
                device_busy_ms=sum(dev_us.values()) * 1e-3, n_kernels=len(dev_us))

    control("before")
    prices = {}
    for route in ("warp", "first", "first", "warp"):
        lcp._warp_plan = plan if route == "warp" else (lambda n: None)
        try:
            before = (k6.launches, k6.launches_warp)
            res = bs_pde.solve(p, 100.0, device=dev)
            took = (k6.launches - before[0], k6.launches_warp - before[1])
            wall, dev_us = cs.profiled(torch, dev, lambda: bs_pde.solve(p, 100.0, device=dev))
            _, w = cs.timed_walls(torch, dev, lambda: bs_pde.solve(p, 100.0, device=dev),
                                  walls)
        finally:
            lcp._warp_plan = plan
        if took[0] == 0 or (took[1] > 0) != (route == "warp"):
            raise AssertionError(f"bs_pde.solve did not take K6's {route} design: {took}")
        prices.setdefault(route, set()).add(float(res.price))
        psor = {k: v for k, v in dev_us.items() if "psor" in k}
        cs.emit(phase="bs_pde_solve_psor_profile", route=route, k6_launches=took[0],
                price=float(res.price), wall_profiled_s=wall,
                device_busy_ms=sum(dev_us.values()) * 1e-3,
                k6_ms=sum(psor.values()) * 1e-3,
                other_kernels_ms=(sum(dev_us.values()) - sum(psor.values())) * 1e-3,
                n_kernels=len(dev_us), wall_unprofiled_median_s=statistics.median(w),
                top=sorted(((k, v * 1e-3) for k, v in dev_us.items()),
                           key=lambda kv: -kv[1])[:6])
    control("after")
    if prices["warp"] != prices["first"] or len(prices["warp"]) != 1:
        raise AssertionError(f"the two K6 designs priced differently: {prices}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_k4_k6_routes: this script needs an NVIDIA GPU")
    from pde_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
    build.load_libraries("cn1d_fused.cu", "psor_batched.cu", "thomas_batched.cu")
    libs = build_variants(variant_sources())
    cs.emit(phase="variants_ptxas", k6_ch16=libs["k6_ch16"][1])
    phase_k4_variants(torch, dev, libs)
    phase_k4_routes(torch, dev)
    phase_k6_routes(torch, dev, libs)
    phase_bs_solve(torch, dev)
    print(cs.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()

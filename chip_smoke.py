#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pde_tpu_torch``) on one NVIDIA GPU.

Drives the port's main paths once, at the sizes ``bench.py`` uses, and
checks every result:

1. device: the card's name and power limit;
2. build: every CUDA kernel of the paths, compiled from
   ``pde_tpu_torch/csrc`` (one ``nvcc`` per source, all started together),
   with each kernel's registers and spills;
3. kernel vs plain, each kernel against its plain PyTorch twin on the same
   inputs on the card, and both timed at the bench shape:
   - K1, the fused Douglas march (European, American projection, American
     Ikonen-Toivanen; B = 512, 130 and 1);
   - K3, the time-varying CN march, on bands from the port's own lattice
     builder on the bench's Dupire surface (B = 256, 37 and 1; European and
     mixed American; w = 0.5 and 1);
   - K4, the constant-coefficient CN march (B = 512, 130 and 1; European
     and mixed American; w = 0.5 and 1);
4. headline calibration: bench.py's 108-quote surface through
   ``_calibrate_pipeline`` and ``HestonCalibrator.calibrate`` (DE 100/15,
   LM 60, seed 42), float32/complex64;
5. fused-ADI book: 512 options at 100x50x100 through
   ``heston_adi.solve_fused_batch``, checked against the converged
   Carr-Madan price;
6. local-vol book: bench.py's row — a Dupire surface from Heston, 256
   options at 200x100 through ``local_vol_pde.solve_fused_batch``, checked
   against the ``route="scan"`` march on the same card;
7. Black-Scholes American book: 512 options at 200x100 through
   ``bs_pde.solve_fused_batch``, checked against the closed form and its
   own European book;
8. SABR smile: bench.py's 11-strike fit through
   ``SABRCalibrator.calibrate_single_maturity``, and one ``calibrate`` of a
   regular 5-maturity surface (the batched LM).

Each main path (4-8) runs with every kernel's launch count set to 0 just
before it and read just after; a path whose kernel never launched fails.
Each phase prints one JSON line; then the kernel table, the card's
``nvidia-smi`` name and power limit, and last ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero before the last line.  Run from the
repository root with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --profile`` instead builds the kernels and traces
one warm call of each book row and of the SABR fit under
``torch.profiler``: wall, the card's busy time and idle share, and the
kernels that took most of the device time.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

S0, R, Q = 100.0, 0.05, 0.02
TRUE = dict(kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, v0=0.04)
GRID = dict(n_spot=100, n_vol=50, n_time=100)
BOOK_B = 512
BUDGET = dict(global_maxiter=100, global_popsize=15, local_max_iter=60)
# kernel vs plain: both float32 with the same step order; only FMA
# contraction differs (K1; the 1D marches are built without it), and its
# error grows over the 100 steps
RTOL, ATOL = 1e-4, 1e-5
# the local-vol and Black-Scholes rows (bench.py:138-167, bench_full.py:847-863)
LV_R, LV_Q = 0.04, 0.01
LV_B, LV_GRID = 256, dict(n_space=200, n_time=100)
BS_R, BS_Q = 0.05, 0.01
BS_B, BS_GRID = 512, dict(n_space=200, n_time=100)
SABR_TRUTH = dict(alpha=0.25, beta=0.5, rho=-0.35, nu=0.45)
# the card's peaks (H100 SXM data sheet): float32 outside the tensor cores
# and HBM bandwidth; a kernel's bound is the larger of its operations over
# the one and its bytes over the other
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
KERNELS = {
    "K1": dict(name="fused_douglas_march_batched", route="cuda",
               source="pde_tpu_torch/csrc/adi_fused_batched.cu",
               replaces="pde_tpu/ops/adi_fused.py:250"),
    "K3": dict(name="fused_cn_march_1d_tv", route="cuda",
               source="pde_tpu_torch/csrc/cn1d_tv_fused.cu",
               replaces="pde_tpu/ops/cn1d_tv_fused.py:59"),
    "K4": dict(name="fused_cn_march_1d", route="cuda",
               source="pde_tpu_torch/csrc/cn1d_fused.cu",
               replaces="pde_tpu/ops/cn1d_fused.py:36"),
}


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def sync(torch, dev) -> None:
    """Wait for the card (a no-op for a CPU rehearsal of the phases)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(torch, fn, reps):
    """Mean milliseconds per call over ``reps`` calls after one warm-up,
    by CUDA events on the card."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes, n_flops):
    """The least time the card could take: (ms, what binds it)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(torch, dev, V, P, **what):
    """Kernel output ``V`` against its plain twin's ``P``: emit the errors,
    raise if any element is outside 1e-5 + 1e-4 |plain|; return max |diff|."""
    sync(torch, dev)
    err = (V - P).abs()
    limit = ATOL + RTOL * P.abs()
    max_abs = float(err.max())
    ok = bool((err <= limit).all()) and bool(torch.isfinite(V).all())
    emit(phase="kernel_vs_plain", **what, max_abs=max_abs,
         max_rel=float((err / P.abs().clamp_min(1e-30)).max()),
         max_over_bound=float((err / limit).max()), ok=ok)
    if not ok:
        raise AssertionError(f"kernel disagrees with plain on {what}")
    return max_abs


def book(torch, dev, B, american, grid):
    """Kernel inputs for a bench-like book, built by the port's own
    ``_march_inputs``: K in [85, 115], T in [0.25, 1.5], calls and puts
    alternating, ``american`` flags as given."""
    from pde_tpu_torch.solvers import heston_adi

    K = torch.linspace(85.0, 115.0, B)
    T = torch.linspace(0.25, 1.5, B)
    cf = (torch.arange(B) % 2).float()
    kappa, theta, sigma, rho, v0, r, q, T, K, cf, _, amer = \
        heston_adi._broadcast_batch(2.0, 0.04, 0.3, -0.7, 0.04, R, Q, T, K, cf,
                                    S0, american, dev)
    args, _ = heston_adi._march_inputs(
        kappa, theta, sigma, rho, r, q, T, K, cf, amer, grid["n_spot"],
        grid["n_vol"], grid["n_time"], 0.2, 5.0, 1.0)
    return args


def phase_kernel(torch, dev, grid=GRID, B=BOOK_B, plain_reps=3, kernel_reps=20):
    """The fused march against its plain twin on identical inputs."""
    from pde_tpu_torch.ops import adi_fused

    march = adi_fused.fused_douglas_march_batched
    plain = adi_fused._fused_douglas_march_batched_plain
    size = (grid["n_spot"], grid["n_vol"], grid["n_time"])
    cases = []
    for b in (B, 130, 1):
        idx = torch.arange(b)
        mixed = (idx % 3 == 0).float()
        cases += [(b, "european", torch.zeros(b), False),
                  (b, "american_projection", mixed, False),
                  (b, "american_it", mixed, True)]
    worst = 0.0
    for b, name, amer, use_it in cases:
        args = book(torch, dev, b, amer, grid)
        V = march(*args, *size, use_it=use_it)
        P = plain(*args, *size, use_it)
        worst = max(worst, compare(torch, dev, V, P, kernel="K1", B=b, case=name))

    args = book(torch, dev, B, torch.zeros(B), grid)
    before = march.launches
    ms = time_ms(torch, lambda: march(*args, *size), kernel_reps)
    if march.launches <= before:
        raise AssertionError("the kernel's launch count did not move")
    plain_ms = time_ms(torch, lambda: plain(*args, *size, False), plain_reps)
    emit(phase="kernel_timing", kernel="K1", B=B, grid=list(size), kernel_ms=ms,
         plain_ms=plain_ms, kernel_options_per_s=B / ms * 1e3,
         plain_options_per_s=B / plain_ms * 1e3)
    # per node and step (csrc/adi_fused_batched.cu): explicit rhs 20, S sweep
    # 5, rhs2 7, v sweep 5, floor 1 = 38 flops
    nodes = size[0] * size[1] * B
    n_bytes = nbytes(*args) + nodes * 4
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound=bound(n_bytes, 38.0 * nodes * size[2]))


def lv_surface(torch, dev, n_strikes=24, n_maturities=6):
    """bench.py's Dupire surface: Heston (2.0, 0.04, 0.3, -0.7, 0.04), strikes
    exp(linspace(ln 60, ln 170)) x maturities linspace(0.05, 1.0), S0=100,
    r=0.04, q=0.01, float32 on ``dev``; as a SurfaceInterpolator."""
    import numpy as np

    from pde_tpu_torch.models import heston, local_vol

    ks = np.exp(np.linspace(np.log(60.0), np.log(170.0), n_strikes))
    ts = np.linspace(0.05, 1.0, n_maturities)
    t0 = time.perf_counter()
    surf = local_vol.dupire_surface(heston.HestonParams(**TRUE), ks, ts, 100.0,
                                    LV_R, LV_Q, device=dev, dtype=torch.float32)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    ok = bool(torch.isfinite(surf).all()) and float(surf.min()) >= 0.01 \
        and float(surf.max()) <= 4.0
    emit(phase="dupire_surface", shape=list(surf.shape), min=float(surf.min()),
         max=float(surf.max()), wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("the Dupire surface is not finite and in [0.01, 4]")
    return local_vol.SurfaceInterpolator(ks, ts, surf, device=dev)


def lv_book(torch, dev, B):
    """bench.py's local-vol book: K in [70, 140], T in [0.25, 1.5], calls
    and puts alternating."""
    return (torch.linspace(70.0, 140.0, B, device=dev),
            torch.linspace(0.25, 1.5, B, device=dev),
            (torch.arange(B, device=dev) % 2).float())


def phase_k3(torch, dev, interp, grid=LV_GRID, B=LV_B, plain_reps=1, kernel_reps=20):
    """K3 against its plain twin on bands from the port's lattice builder."""
    from pde_tpu_torch.ops import cn1d_tv_fused
    from pde_tpu_torch.solvers import local_vol_pde

    march = cn1d_tv_fused.fused_cn_march_1d_tv
    plain = cn1d_tv_fused._fused_cn_march_1d_tv_plain
    n, nT = grid["n_space"], grid["n_time"]

    def inputs(b, amer):
        K, T, cf = lv_book(torch, dev, b)
        return local_vol_pde._march_inputs(interp, K, T, cf, amer, LV_R, LV_Q, n, nT,
                                           0.2, 5.0)[:3]

    worst = 0.0
    for b in (B, 37, 1):
        mixed = (torch.arange(b, device=dev) % 3 == 0).float()
        for name, amer in (("european", torch.zeros(b, device=dev)),
                           ("american_mixed", mixed)):
            args = inputs(b, amer)
            for w in (0.5, 1.0):
                V = march(*args, n, nT, w)
                P = plain(*args, n, nT, w)
                worst = max(worst, compare(torch, dev, V, P, kernel="K3", B=b,
                                           case=name, w=w))

    args = inputs(B, torch.zeros(B, device=dev))
    before = march.launches
    ms = time_ms(torch, lambda: march(*args, n, nT), kernel_reps)
    if march.launches <= before:
        raise AssertionError("K3's launch count did not move")
    plain_ms = time_ms(torch, lambda: plain(*args, n, nT, 0.5), plain_reps)
    emit(phase="kernel_timing", kernel="K3", B=B, grid=[n, nT], kernel_ms=ms,
         plain_ms=plain_ms, kernel_options_per_s=B / ms * 1e3,
         plain_options_per_s=B / plain_ms * 1e3)
    # per node and step (csrc/cn1d_tv_fused.cu): explicit stencil and rhs 7,
    # implicit rows 4, pivot 3, c and d 4, back substitution 2, floor 4 = 24
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound=bound(nbytes(*args) + n * B * 4, 24.0 * n * nT * B))


def bs_inputs(torch, dev, B, american, grid=BS_GRID):
    """K4's inputs for bench_full.py's book: sigma in [0.15, 0.45], T in
    [0.25, 1.5], K in [80, 120], calls and puts alternating."""
    from pde_tpu_torch.solvers import bs_pde

    full = lambda v: torch.full((B,), v, device=dev)  # noqa: E731
    return bs_pde._march_inputs(
        torch.linspace(0.15, 0.45, B, device=dev), full(BS_R), full(BS_Q),
        torch.linspace(0.25, 1.5, B, device=dev), torch.linspace(80.0, 120.0, B, device=dev),
        (torch.arange(B, device=dev) % 2).float(), american, grid["n_space"],
        grid["n_time"], 0.2, 5.0)[:2]


def phase_k4(torch, dev, grid=BS_GRID, B=BS_B, plain_reps=1, kernel_reps=20):
    """K4 against its plain twin on the bench book's inputs."""
    from pde_tpu_torch.ops import cn1d_fused

    march = cn1d_fused.fused_cn_march_1d
    plain = cn1d_fused._fused_cn_march_1d_plain
    n, nT = grid["n_space"], grid["n_time"]
    worst = 0.0
    for b in (B, 130, 1):
        mixed = (torch.arange(b, device=dev) % 3 == 0).float()
        for name, amer in (("european", torch.zeros(b, device=dev)),
                           ("american_mixed", mixed)):
            args = bs_inputs(torch, dev, b, amer, grid)
            for w in (0.5, 1.0):
                V = march(*args, n, nT, w)
                P = plain(*args, n, nT, w)
                worst = max(worst, compare(torch, dev, V, P, kernel="K4", B=b,
                                           case=name, w=w))

    args = bs_inputs(torch, dev, B, torch.ones(B, device=dev), grid)
    before = march.launches
    ms = time_ms(torch, lambda: march(*args, n, nT), kernel_reps)
    if march.launches <= before:
        raise AssertionError("K4's launch count did not move")
    plain_ms = time_ms(torch, lambda: plain(*args, n, nT, 0.5), plain_reps)
    emit(phase="kernel_timing", kernel="K4", B=B, grid=[n, nT], kernel_ms=ms,
         plain_ms=plain_ms, kernel_options_per_s=B / ms * 1e3,
         plain_options_per_s=B / plain_ms * 1e3)
    # per node and step (csrc/cn1d_fused.cu): explicit stencil and rhs 7,
    # factored forward sweep 3, back substitution 2, floor 4 = 16
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound=bound(nbytes(*args) + n * B * 4, 16.0 * n * nT * B))


def phase_calibration(torch, dev, dtype, budget=BUDGET, timed_runs=3):
    """bench.py's headline surface through the pipeline and the calibrator."""
    import numpy as np

    from pde_tpu_torch.calibrate.heston import (PARAM_ORDER, HestonCalibrator,
                                                _calibrate_pipeline)
    from pde_tpu_torch.models.heston import group_maturities

    data = HestonCalibrator.generate_synthetic_data(
        S0=S0, r=R, q=Q, **TRUE, strikes=np.linspace(85.0, 115.0, 12),
        maturities=np.linspace(0.25, 1.5, 9), device=dev, dtype=dtype)
    n = len(data["strike"])
    unique_T, t_idx = group_maturities(data["maturity"])
    cal = HestonCalibrator(seed=42, device=dev, dtype=dtype, **budget)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    bounds = [t([cal.bounds[k][i] for k in PARAM_ORDER]) for i in (0, 1)]
    args = (t(data["strike"]), torch.as_tensor(t_idx, dtype=torch.int64, device=dev),
            t(unique_T), torch.as_tensor(data["is_call"], device=dev),
            t(data["mid_price"]), torch.ones(n, dtype=dtype, device=dev),
            S0, R, Q, *bounds)

    def run():
        gen = torch.Generator(device=dev)
        gen.manual_seed(42)
        out = _calibrate_pipeline(*args, gen, torch.zeros(5, dtype=dtype, device=dev),
                                  False, **budget)
        sync(torch, dev)
        return out

    run()  # warm-up
    walls = []
    for _ in range(timed_runs):
        t0 = time.perf_counter()
        out = run()
        walls.append(time.perf_counter() - t0)
    lm_x = out[3].cpu().double().numpy()
    rel_rmse = float(np.sqrt(2.0 * float(out[4]) / n))
    ok = abs(lm_x[4] - TRUE["v0"]) < 0.02 and rel_rmse < 0.05  # bench.py:274
    emit(phase="calibration_pipeline", n_quotes=n, params=lm_x.tolist(),
         rel_rmse=rel_rmse, de_n_iter=int(out[2]), lm_n_iter=int(out[6]),
         wall_s=statistics.median(walls), wall_s_runs=walls, ok=ok)
    if not ok:
        raise AssertionError("the calibration pipeline missed the truth")

    t0 = time.perf_counter()
    res = cal.calibrate(data, S0=S0, r=R, q=Q)
    wall = time.perf_counter() - t0
    rel_rmse = float(np.sqrt(2.0 * res.convergence["local_cost"] / n))
    ok = abs(res.params.v0 - TRUE["v0"]) < 0.02 and rel_rmse < 0.05
    emit(phase="calibrator", params=[getattr(res.params, k) for k in PARAM_ORDER],
         rel_rmse=rel_rmse, rmse=res.rmse, success=res.success, wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("HestonCalibrator.calibrate missed the truth")


def timed_walls(torch, dev, fn, reps):
    """One warm call, then ``reps`` host-clock walls, each ending in a sync."""
    res = fn()
    sync(torch, dev)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn()
        sync(torch, dev)
        walls.append(time.perf_counter() - t0)
    return res, walls


def phase_book(torch, dev, grid=GRID, B=BOOK_B, reps=10):
    """bench.py's fused-ADI book, checked against the converged price."""
    from pde_tpu_torch.models.heston import HestonParams, price_accurate
    from pde_tpu_torch.solvers import heston_adi

    K = torch.linspace(85.0, 115.0, B, device=dev)
    T = torch.linspace(0.25, 1.5, B, device=dev)
    cf = (torch.arange(B, device=dev) % 2).float()

    def run():
        return heston_adi.solve_fused_batch(2.0, 0.04, 0.3, -0.7, 0.04, R, Q, T, K,
                                            cf, S0, device=dev, **grid)

    res, walls = timed_walls(torch, dev, run, reps)
    fields = ("price", "delta", "gamma", "vega", "theta")
    finite = all(bool(torch.isfinite(getattr(res, f)).all()) for f in fields)
    # the repo's PDE-vs-truth gate (tests/test_solvers.py:485-489): the
    # converged Carr-Madan price, not the reference grid's, which sits ~2%
    # below the truth at the money
    atm = (K >= 95.0) & (K <= 105.0)
    f64 = torch.float64
    truth = price_accurate(HestonParams(2.0, 0.04, 0.3, -0.7, 0.04),
                           K[atm].to(f64), T[atm].to(f64), S0, R, Q, cf[atm] > 0.5)
    rel = ((res.price[atm].to(f64) - truth).abs() / truth).max()
    per = statistics.median(walls)
    ok = finite and float(rel) < 0.01
    emit(phase="fused_adi_book", B=B, grid=list(grid.values()), finite=finite,
         n_atm=int(atm.sum()), atm_max_rel_err=float(rel), wall_s=per,
         wall_s_runs=walls, options_per_s=B / per, ok=ok)
    if not ok:
        raise AssertionError("the fused-ADI book failed its checks")


def phase_local_vol_book(torch, dev, interp, grid=LV_GRID, B=LV_B, reps=10):
    """bench.py's local-vol row, checked against the scan route on the card
    (the reference test's own gate, tests/test_local_vol.py:240)."""
    from pde_tpu_torch.solvers import local_vol_pde

    K, T, cf = lv_book(torch, dev, B)

    def run(route="fused"):
        return local_vol_pde.solve_fused_batch(interp, 100.0, K=K, T=T, is_call=cf,
                                               r=LV_R, q=LV_Q, route=route,
                                               device=dev, **grid)

    res, walls = timed_walls(torch, dev, run, reps)
    fields = ("price", "delta", "gamma", "prices")
    finite = all(bool(torch.isfinite(getattr(res, f)).all()) for f in fields)
    scan = run("scan")
    sync(torch, dev)
    err = (res.price - scan.price).abs()
    over = float((err / (2e-4 + 2e-4 * scan.price.abs())).max())
    per = statistics.median(walls)
    ok = finite and over <= 1.0
    emit(phase="local_vol_book", B=B, grid=list(grid.values()), finite=finite,
         max_abs_vs_scan=float(err.max()), max_over_bound_vs_scan=over, wall_s=per,
         wall_s_runs=walls, options_per_s=B / per, ok=ok)
    if not ok:
        raise AssertionError("the local-vol book failed its checks")


def phase_bs_book(torch, dev, grid=BS_GRID, B=BS_B, reps=10):
    """bench_full.py's Black-Scholes American book; its European twin
    against the closed form near the money, and American >= European."""
    from pde_tpu_torch.models import black_scholes
    from pde_tpu_torch.solvers import bs_pde

    sig = torch.linspace(0.15, 0.45, B, device=dev)
    T = torch.linspace(0.25, 1.5, B, device=dev)
    K = torch.linspace(80.0, 120.0, B, device=dev)
    cf = (torch.arange(B, device=dev) % 2).float()

    def run(american):
        return bs_pde.solve_fused_batch(sig, BS_R, BS_Q, T, K, cf, 100.0,
                                        american=american, device=dev, **grid)

    amer, walls = timed_walls(torch, dev, lambda: run(torch.ones(B, device=dev)), reps)
    euro = run(torch.zeros(B, device=dev))
    f64 = torch.float64
    closed = black_scholes.price(100.0, K.to(f64), BS_R, BS_Q, T.to(f64), sig.to(f64),
                                 cf > 0.5)
    atm = (K >= 95.0) & (K <= 105.0)
    rel = float(((euro.price.to(f64) - closed).abs() / closed)[atm].max())
    floor_gap = float((amer.price - euro.price).min())
    fields = ("price", "delta", "gamma", "theta")
    finite = all(bool(torch.isfinite(getattr(r, f)).all()) for r in (amer, euro)
                 for f in fields)
    per = statistics.median(walls)
    ok = finite and rel < 0.01 and floor_gap >= -1e-4
    emit(phase="bs_american_book", B=B, grid=list(grid.values()), finite=finite,
         n_atm=int(atm.sum()), european_atm_max_rel_err=rel,
         min_american_minus_european=floor_gap, wall_s=per, wall_s_runs=walls,
         options_per_s=B / per, ok=ok)
    if not ok:
        raise AssertionError("the Black-Scholes American book failed its checks")


def phase_sabr(torch, dev, reps=20):
    """bench.py's SABR smile fit, then one regular 5-maturity surface."""
    import numpy as np

    from pde_tpu_torch.calibrate.sabr import SABRCalibrator
    from pde_tpu_torch.models import sabr

    truth = sabr.SABRParams(**SABR_TRUTH)
    cal = SABRCalibrator(beta=truth.beta, device=dev, dtype=torch.float32)

    def smile(K, F, T):
        vols = sabr.implied_volatilities(torch.as_tensor(K, dtype=torch.float32,
                                                         device=dev), F, T, truth)
        return vols.cpu().double().numpy()

    F1 = 100.0 * float(np.exp(0.03))
    K = np.linspace(80.0, 120.0, 11)
    vols = smile(K, F1, 1.0)
    cal.calibrate_single_maturity(K, vols, F1, 1.0)  # warm-up
    t0 = time.perf_counter()
    for _ in range(reps):
        p, rmse = cal.calibrate_single_maturity(K, vols, F1, 1.0)
    per = (time.perf_counter() - t0) / reps
    miss = max(abs(getattr(p, k) - SABR_TRUTH[k]) for k in ("alpha", "rho", "nu"))
    ok = rmse < 1e-4 and miss < 1e-2
    emit(phase="sabr_smile", fit_s=per, rmse=rmse, params=[p.alpha, p.rho, p.nu],
         max_param_err=miss, ok=ok)
    if not ok:
        raise AssertionError("the SABR smile fit missed the truth")

    Ts = np.array([0.25, 0.5, 1.0, 1.5, 2.0])
    Fs = 100.0 * np.exp(0.03 * Ts)
    Ks = [np.linspace(0.8 * F, 1.2 * F, 11) for F in Fs]
    data = {"strike": np.concatenate(Ks), "T": np.repeat(Ts, 11),
            "implied_vol": np.concatenate([smile(k, float(F), float(T))
                                           for k, F, T in zip(Ks, Fs, Ts)])}
    t0 = time.perf_counter()
    res = cal.calibrate(data, F0=100.0, r=0.03)
    wall = time.perf_counter() - t0
    miss = max(abs(getattr(p, k) - SABR_TRUTH[k]) for p in res.params_by_maturity.values()
               for k in ("alpha", "rho", "nu"))
    ok = res.total_rmse < 1e-4 and miss < 1e-2 and len(res.params_by_maturity) == len(Ts)
    emit(phase="sabr_surface", n_maturities=res.n_maturities, total_rmse=res.total_rmse,
         max_param_err=miss, success=res.success, wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("the SABR surface calibration missed the truth")


def profile_rows(torch, dev, interp, top=4):
    """One warm call of each row under ``torch.profiler``: the call's wall,
    the card's busy time (device time of its kernels), the idle share and
    the kernels that took most of the device time."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pde_tpu_torch.calibrate.sabr import SABRCalibrator
    from pde_tpu_torch.models import sabr
    from pde_tpu_torch.solvers import bs_pde, heston_adi, local_vol_pde

    K, T, cf = lv_book(torch, dev, LV_B)
    Kb = torch.linspace(80.0, 120.0, BS_B, device=dev)
    Tb = torch.linspace(0.25, 1.5, BS_B, device=dev)
    cb = (torch.arange(BS_B, device=dev) % 2).float()
    sig = torch.linspace(0.15, 0.45, BS_B, device=dev)
    Ks = np.linspace(80.0, 120.0, 11)
    F1 = 100.0 * float(np.exp(0.03))
    vols = sabr.implied_volatilities(torch.as_tensor(Ks, device=dev), F1, 1.0,
                                     sabr.SABRParams(**SABR_TRUTH)).cpu().numpy()
    cal = SABRCalibrator(beta=0.5, device=dev, dtype=torch.float32)
    rows = {
        "fused_adi_book": lambda: heston_adi.solve_fused_batch(
            2.0, 0.04, 0.3, -0.7, 0.04, R, Q, Tb, Kb, cb, S0, device=dev, **GRID),
        "local_vol_book": lambda: local_vol_pde.solve_fused_batch(
            interp, 100.0, K=K, T=T, is_call=cf, r=LV_R, q=LV_Q, device=dev, **LV_GRID),
        "bs_american_book": lambda: bs_pde.solve_fused_batch(
            sig, BS_R, BS_Q, Tb, Kb, cb, 100.0, american=torch.ones(BS_B, device=dev),
            device=dev, **BS_GRID),
        "sabr_smile": lambda: cal.calibrate_single_maturity(Ks, vols, F1, 1.0),
    }
    for name, fn in rows.items():
        fn()
        sync(torch, dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync(torch, dev)
            wall = time.perf_counter() - t0
        # device-side events only: the CPU ops that launched them carry the
        # same time again
        dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
        busy = sum(dev_us.values()) * 1e-6
        emit(phase="profile", row=name, wall_s=wall, device_busy_s=busy,
             idle_share=1.0 - busy / wall, n_kernels=len(dev_us),
             top=sorted(((k[:60], v * 1e-3) for k, v in dev_us.items()),
                        key=lambda kv: -kv[1])[:top])


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    from pde_tpu_torch.ops import adi_fused, build, cn1d_fused, cn1d_tv_fused

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    emit(phase="device", kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    sources = [k["source"].rsplit("/", 1)[1] for k in KERNELS.values()]
    built = build.load_libraries(*sources)
    emit(phase="build", seconds=time.perf_counter() - t0,
         ptxas={src: [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]
                for src, (_, log) in built.items()})

    wrappers = {"K1": adi_fused.fused_douglas_march_batched,
                "K3": cn1d_tv_fused.fused_cn_march_1d_tv,
                "K4": cn1d_fused.fused_cn_march_1d}
    interp = lv_surface(torch, dev)
    if "--profile" in sys.argv[1:]:
        profile_rows(torch, dev, interp)
        return
    measured = {"K1": phase_kernel(torch, dev), "K3": phase_k3(torch, dev, interp),
                "K4": phase_k4(torch, dev)}

    # the main paths: every count is 0 just before a path and read just after
    def path(fn, *args):
        for w in wrappers.values():
            w.launches = 0
        fn(*args)
        return {k: w.launches for k, w in wrappers.items()}

    path(phase_calibration, torch, dev, torch.float32)
    launches = {"K1": path(phase_book, torch, dev)["K1"],
                "K3": path(phase_local_vol_book, torch, dev, interp)["K3"],
                "K4": path(phase_bs_book, torch, dev)["K4"]}
    path(phase_sabr, torch, dev)
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path never launched {k} ({KERNELS[k]['name']})")

    rows = []
    for k, info in KERNELS.items():
        m = measured[k]
        bound_ms, bound_by = m["bound"]
        rows.append({**info, "launches": launches[k], "max_abs_err": m["max_abs_err"],
                     "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)

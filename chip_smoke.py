#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pde_tpu_torch``) on one NVIDIA GPU.

Drives the port's main path once, at the sizes ``bench.py`` uses, and
checks every result:

1. device: the card's name and power limit;
2. build: the CUDA kernel of the path, compiled from ``pde_tpu_torch/csrc``;
3. kernel vs plain: the fused Douglas march against its plain PyTorch twin
   on the same inputs on the card (European, American projection, American
   Ikonen-Toivanen; B = 512, 130 and 1), and both timed at B = 512;
4. headline calibration: bench.py's 108-quote surface through
   ``_calibrate_pipeline`` and ``HestonCalibrator.calibrate`` (DE 100/15,
   LM 60, seed 42), float32/complex64;
5. fused-ADI book: 512 options at 100x50x100 through ``solve_fused_batch``,
   checked against the converged Carr-Madan price.

Each phase prints one JSON line; then the kernel table, the card's
``nvidia-smi`` name and power limit, and last ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero before the last line.  Run from the
repository root with no arguments:

    python3 chip_smoke.py
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
# contraction differs, and its error grows over the 100 steps
RTOL, ATOL = 1e-4, 1e-5
KERNEL_SOURCE = "pde_tpu_torch/csrc/adi_fused_batched.cu"
KERNEL_REPLACES = "pde_tpu/ops/adi_fused.py:250"


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
        sync(torch, dev)
        err = (V - P).abs()
        bound = ATOL + RTOL * P.abs()
        max_abs = float(err.max())
        max_rel = float((err / P.abs().clamp_min(1e-30)).max())
        ok = bool((err <= bound).all()) and bool(torch.isfinite(V).all())
        emit(phase="kernel_vs_plain", B=b, case=name, max_abs=max_abs,
             max_rel=max_rel, max_over_bound=float((err / bound).max()), ok=ok)
        if not ok:
            raise AssertionError(f"kernel disagrees with plain on {name}, B={b}")
        worst = max(worst, max_abs)

    args = book(torch, dev, B, torch.zeros(B), grid)
    before = march.launches
    ms = time_ms(torch, lambda: march(*args, *size), kernel_reps)
    if march.launches <= before:
        raise AssertionError("the kernel's launch count did not move")
    plain_ms = time_ms(torch, lambda: plain(*args, *size, False), plain_reps)
    emit(phase="kernel_timing", B=B, grid=list(size), kernel_ms=ms,
         plain_ms=plain_ms, kernel_options_per_s=B / ms * 1e3,
         plain_options_per_s=B / plain_ms * 1e3)
    return worst, ms, plain_ms


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

    res = run()
    sync(torch, dev)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = run()
        sync(torch, dev)
        walls.append(time.perf_counter() - t0)
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    from pde_tpu_torch.ops import adi_fused, build

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    emit(phase="device", kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _, log = build.load_library("adi_fused_batched.cu")
    emit(phase="build", source=KERNEL_SOURCE, seconds=time.perf_counter() - t0,
         ptxas=[ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln])

    max_abs, ms, plain_ms = phase_kernel(torch, dev)

    # the main path: every kernel launch from here on is the path's own
    adi_fused.fused_douglas_march_batched.launches = 0
    phase_calibration(torch, dev, torch.float32)
    phase_book(torch, dev)
    launches = adi_fused.fused_douglas_march_batched.launches
    if launches == 0:
        raise AssertionError("the main path never launched the fused ADI kernel")

    print(json.dumps({"kernels": [{
        "name": "fused_douglas_march_batched", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": max_abs, "ms": ms,
        "plain_ms": plain_ms}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)

#!/usr/bin/env python3
"""Time the rough-Heston surface calibration on the card two ways, in turns.

``pde_tpu_torch.calibrate.rough._fit`` prices the whole surface in one
fractional-Riccati march (``price_rough`` on (M,) maturities); the
reference's ``lax.map`` over maturities, written as a Python loop of one
smile each, marches once a maturity.  Both fit bench_full.py's surface
(3 maturities x 9 strikes, ``n_steps=96``, ``max_iter=40``, float32) from
the calibrator's four starts, after one warm call each; the script prints
one JSON line per timed call and one for the residual Jacobian alone (the
LM's dominant cost: ``vmap(jacfwd)`` over the four starts).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_rough_march.py
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pde_tpu_torch.calibrate import rough  # noqa: E402
from pde_tpu_torch.models.rough_heston import price_rough  # noqa: E402


def loop_fit(strikes, maturities, mids, S0, r, q, x0s, lower, upper, n_steps, max_iter):
    """``rough._fit`` with one march a maturity (the reference's lax.map)."""

    def residuals(x):
        p = rough._params(x)
        model = torch.stack([price_rough(p, strikes[i], maturities[i], S0, r, q,
                                         n_steps=n_steps)
                             for i in range(strikes.shape[0])])
        return ((model - mids) / torch.clamp_min(mids, 1e-8)).reshape(-1)

    return rough._best_of_starts(residuals, x0s, lower, upper, max_iter), residuals


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_rough_march: needs an NVIDIA GPU")
    dev, f32 = torch.device("cuda", 0), torch.float32
    data = rough.RoughHestonCalibrator.generate_synthetic_surface(n_steps=96, device=dev,
                                                                  dtype=f32)
    cal = rough.RoughHestonCalibrator(n_steps=96, max_iter=40, device=dev, dtype=f32)
    t = cal._tensor
    args = (t(data["strikes"]), t(data["maturities"]), t(data["mid_prices"]), data["S0"],
            data["r"], data["q"], cal._start(None, None), t(rough._LOWER), t(rough._UPPER))

    def one_march_residuals(x):
        model = price_rough(rough._params(x), args[0], args[1], *args[3:6], n_steps=96)
        return ((model - args[2]) / torch.clamp_min(args[2], 1e-8)).reshape(-1)

    routes = {
        "one_march": (lambda: rough._fit(*args, n_steps=96, max_iter=40),
                      one_march_residuals),
        "loop_over_maturities": (lambda: loop_fit(*args, n_steps=96, max_iter=40)[0],
                                 loop_fit(*args, n_steps=96, max_iter=0)[1]),
    }
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for name, (fit, res_fn) in routes.items():
        fit()
        jac = torch.func.vmap(torch.func.jacfwd(res_fn))
        jac(args[6])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        jac(args[6])
        torch.cuda.synchronize()
        print(json.dumps({"route": name, "jacobian_4_starts_s": time.perf_counter() - t0}),
              flush=True)
    for turn in range(2):
        for name, (fit, _) in routes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fit()
            torch.cuda.synchronize()
            print(json.dumps({"route": name, "turn": turn,
                              "calibration_s": time.perf_counter() - t0,
                              "n_iter": int(res.n_iter),
                              "rmse": float((2.0 * res.cost / 27.0) ** 0.5)}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""How far the port's float32 OU fits land from float64, on the CPU.

* ``models/ou.fit_mle`` and ``OUFitter.fit_batch`` (``calibrate/ou``'s
  analytical MLE) on the seed-0 numpy fan of ``chip_smoke.py``'s ``ou``
  phase: 1024 OU(100, 5, 2) paths of 252 steps from 100.  Float32 on the
  fan rounded to float32 against float64 on the fan itself; the largest
  relative error of theta, mu and sigma over the paths.
* ``OUFitter.fit`` on the log closes the signals service fits: the
  simulated provider's SPY, QQQ and IWM over one year, at the provider's
  default seed (42) and at the smoke's (3); mu's relative error.
* Twelve fans of ``ou.simulate`` (seeds 0-11, float32 draws from a CPU
  ``torch.Generator``) fitted by ``fit_mle`` in float32 and in float64 on
  the same float32 paths: the largest relative errors, the share of the
  smoke's per-path gates (``chip_smoke.OU_F32_GATES``, theta with its
  slope term 1e-3 |theta - mean x|), the paths whose theta is more than
  1e-5 off, and the clamped slopes.

Prints one JSON object.  Run from the repository root (or a checkout of
another commit, to compare):

    python3 scripts/torch_ou_float32.py
"""

import datetime
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pde_tpu_torch.calibrate import ou as cal  # noqa: E402
from pde_tpu_torch.data.providers import SimulatedDataProvider  # noqa: E402
from pde_tpu_torch.models import ou  # noqa: E402

DT = 1.0 / 252.0


def numpy_fan(n_paths=1024, steps=252, seed=0, theta=100.0, mu=5.0, sigma=2.0):
    rng = np.random.default_rng(seed)
    a = np.exp(-mu / steps)
    s = np.sqrt(sigma**2 * (1.0 - np.exp(-2.0 * mu / steps)) / (2.0 * mu))
    z = rng.standard_normal((n_paths, steps))
    x = np.empty((n_paths, steps + 1))
    x[:, 0] = theta
    for i in range(steps):
        x[:, i + 1] = theta + (x[:, i] - theta) * a + s * z[:, i]
    return x


def rel(got, want):
    got, want = (torch.as_tensor(v).double() for v in (got, want))
    return (got - want).abs() / want.abs()


def fan_errors(fit32, fit64):
    return {k: float(rel(getattr(fit32, k), getattr(fit64, k)).max())
            for k in ("theta", "mu", "sigma")}


def main():
    out = {}
    x = numpy_fan()
    x32, x64 = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(x)
    out["fit_mle_numpy_fan"] = fan_errors(ou.fit_mle(x32, DT).params,
                                          ou.fit_mle(x64, DT).params)
    fitter32 = cal.OUFitter(device="cpu", dtype=torch.float32)
    fitter64 = cal.OUFitter(device="cpu", dtype=torch.float64)
    out["fit_batch_numpy_fan"] = fan_errors(fitter32.fit_batch(x32), fitter64.fit_batch(x64))

    end = datetime.date(2026, 1, 2)
    service = {}
    for seed in (42, 3):
        prov = SimulatedDataProvider(seed=seed, device="cpu")
        for sym in ("SPY", "QQQ", "IWM"):
            closes = [b.close for b in prov.get_bars(sym, end - datetime.timedelta(days=365), end)]
            X = np.log(closes)
            mu32, mu64 = (float(f.fit(X).params.mu) for f in (fitter32, fitter64))
            service[f"{sym}_seed{seed}"] = {"mu_f32": mu32, "mu_f64": mu64,
                                            "rel": abs(mu32 - mu64) / abs(mu64)}
    out["fitter_service_series"] = service

    gates = {"theta": 1e-5, "mu": 1e-3, "sigma": 1e-4}
    worst = {k: 0.0 for k in gates}
    share = {k: 0.0 for k in gates}
    over, clamped = 0, 0
    p = ou.OUParams(100.0, 5.0, 2.0)
    for seed in range(12):
        paths = ou.simulate(p, 100.0, 1.0, 252, torch.Generator().manual_seed(seed),
                            shape=(1024,), device="cpu", dtype=torch.float32)
        f32, f64 = ou.fit_mle(paths, DT), ou.fit_mle(paths.double(), DT)
        clamped += int(f64.b_clamped.sum())
        for k in gates:
            worst[k] = max(worst[k], float(rel(getattr(f32.params, k), getattr(f64.params, k)).max()))
        th = f64.params.theta
        err = (f32.params.theta.double() - th).abs()
        scale = gates["theta"] * th.abs() + gates["mu"] * (th - paths.double()[:, :-1].mean(-1)).abs()
        share["theta"] = max(share["theta"], float((err / scale).max()))
        over += int((err / th.abs() > 1e-5).sum())
    share["mu"], share["sigma"] = worst["mu"] / gates["mu"], worst["sigma"] / gates["sigma"]
    out["torch_fans"] = {"fans": 12, "paths": 12 * 1024, "max_rel": worst,
                         "share_of_smoke_gate": share, "theta_paths_over_1e5": over,
                         "clamped_paths": clamped}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""The port's SABR model and smile calibrator held against ``pde_tpu``.

The Hagan formula runs in float64 in both packages: 1e-12, round-off only.
The fits run the same bounded LM from the same starts in float64, so the
iterates differ by round-off only; the fitted parameters are held to 1e-6,
far inside the distance at which another local optimum would show.
"""

import numpy as np
import pytest
import torch

from pde_tpu.calibrate.sabr import SABRCalibrator as JaxCalibrator
from pde_tpu.models import sabr as js
from pde_tpu_torch import interop
from pde_tpu_torch.calibrate.lm import levenberg_marquardt
from pde_tpu_torch.calibrate.sabr import SABRCalibrationError, SABRCalibrator
from pde_tpu_torch.models import sabr as ts

F64 = torch.float64
TRUTH = (0.25, 0.5, -0.35, 0.45)
F1 = 100.0 * float(np.exp(0.03))
PARAM_GATE = dict(rtol=0, atol=1e-6)


@pytest.mark.parametrize("params", [TRUTH, (0.3, 0.0, 0.2, 0.8), (0.04, 1.0, -0.6, 0.3),
                                    (0.25, 0.5, -0.35, 0.0)])
@pytest.mark.parametrize("T", [1.0, 0.0, 2.5])
def test_implied_volatility_f64(params, T):
    """Across a smile that includes the forward itself (the ATM branch),
    zero maturity and nu = 0 (the degenerate z)."""
    K = np.array([60.0, 80.0, 95.0, F1, F1 * (1 + 1e-8), 110.0, 150.0])
    want = np.asarray(js.implied_volatility(K, F1, T, js.SABRParams(*params)))
    got = ts.implied_volatility(torch.tensor(K), F1, T, ts.SABRParams(*params)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    # tensor parameters (as interop carries them) give the same smile, up to
    # the rounding of 1 - beta in a tensor rather than in Python
    tp = interop.sabr_params(js.SABRParams(*params))
    np.testing.assert_allclose(
        ts.implied_volatilities(torch.tensor(K), F1, T, tp).numpy(), got, rtol=1e-14)


def test_atm_volatility_and_smile_alias():
    p = js.SABRParams(*TRUTH)
    np.testing.assert_allclose(
        ts.atm_volatility(torch.tensor(F1, dtype=F64), 1.5, ts.SABRParams(*TRUTH)).numpy(),
        np.asarray(js.atm_volatility(F1, 1.5, p)), rtol=1e-12)
    K = torch.linspace(80.0, 120.0, 5, dtype=F64)
    np.testing.assert_array_equal(ts.volatility_smile(K, F1, 1.0, ts.SABRParams(*TRUTH)),
                                  ts.implied_volatility(K, F1, 1.0, ts.SABRParams(*TRUTH)))


def test_volatility_sensitivities_f64():
    K = np.array([80.0, 100.0, F1, 120.0])
    want = js.volatility_sensitivities(K, F1, 1.0, js.SABRParams(*TRUTH))
    got = ts.volatility_sensitivities(torch.tensor(K), F1, 1.0, ts.SABRParams(*TRUTH))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)


def test_params_validate():
    ts.SABRParams(*TRUTH).validate()
    for bad in ((0.0, 0.5, 0.0, 0.3), (0.2, 1.5, 0.0, 0.3), (0.2, 0.5, 1.0, 0.3),
                (0.2, 0.5, 0.0, -0.1)):
        with pytest.raises(ValueError):
            ts.SABRParams(*bad).validate()


def _torch_cal(**kw):
    return SABRCalibrator(beta=0.5, device="cpu", dtype=F64, **kw)


def _noisy_smile(T, seed, n=11):
    return JaxCalibrator.generate_synthetic_smile(F=F1, T=T, alpha=TRUTH[0], beta=0.5,
                                                  rho=TRUTH[2], nu=TRUTH[3], n_strikes=n,
                                                  noise_std=2e-3, seed=seed)


@pytest.mark.parametrize("guess", [None, {"alpha": 2.4, "rho": -0.1, "nu": 0.9}])
def test_calibrate_single_maturity_matches_reference(guess):
    K, vols = _noisy_smile(1.0, 3)
    w = np.linspace(0.5, 1.5, len(K))
    jp, jr = JaxCalibrator(beta=0.5).calibrate_single_maturity(K, vols, F1, 1.0, weights=w,
                                                               initial_guess=guess)
    tp, tr = _torch_cal().calibrate_single_maturity(K, vols, F1, 1.0, weights=w,
                                                    initial_guess=guess)
    for k in ("alpha", "rho", "nu"):
        np.testing.assert_allclose(getattr(tp, k), float(getattr(jp, k)), **PARAM_GATE,
                                   err_msg=k)
    np.testing.assert_allclose(tr, jr, rtol=1e-6)
    with pytest.raises(SABRCalibrationError):
        _torch_cal().calibrate_single_maturity(K[:2], vols[:2], F1, 1.0)


def _surface(counts, seed=0):
    Ts = [0.25, 0.5, 1.0, 1.5, 2.0][:len(counts)]
    rows = {"strike": [], "T": [], "implied_vol": []}
    for i, (T, n) in enumerate(zip(Ts, counts)):
        F = 100.0 * np.exp(0.03 * T)
        K, v = JaxCalibrator.generate_synthetic_smile(F=F, T=T, alpha=TRUTH[0], beta=0.5,
                                                      rho=TRUTH[2], nu=TRUTH[3],
                                                      n_strikes=n, noise_std=1e-3,
                                                      seed=seed + i)
        rows["strike"] += list(K)
        rows["T"] += [T] * n
        rows["implied_vol"] += list(v)
    return {k: np.asarray(v) for k, v in rows.items()}


@pytest.mark.parametrize("counts", [(9, 9, 9, 9, 9), (7, 11, 9)], ids=["regular", "irregular"])
def test_calibrate_matches_reference(counts):
    """The regular surface takes the batched LM (one call, per-smile data);
    the irregular one the per-maturity loop."""
    data = _surface(counts)
    want = JaxCalibrator(beta=0.5).calibrate(data, F0=100.0, r=0.03, underlying="X")
    cal = _torch_cal()
    got = cal.calibrate(data, F0=100.0, r=0.03, underlying="X")
    assert sorted(got.params_by_maturity) == sorted(want.params_by_maturity)
    for T, p in want.params_by_maturity.items():
        for k in ("alpha", "rho", "nu"):
            np.testing.assert_allclose(getattr(got.params_by_maturity[T], k),
                                       float(getattr(p, k)), **PARAM_GATE)
        np.testing.assert_allclose(got.rmse_by_maturity[T], want.rmse_by_maturity[T],
                                   rtol=1e-6)
    np.testing.assert_allclose(got.total_rmse, want.total_rmse, rtol=1e-6)
    assert (got.success, got.message, got.n_options) == (want.success, want.message,
                                                         want.n_options)
    assert got.converged_by_maturity == {T: bool(c) for T, c in
                                         want.converged_by_maturity.items()}
    assert cal._cached_params["X"] is got.params_by_maturity
    assert got.to_dict()["n_maturities"] == len(counts)


def test_calibrate_surface_batch_matches_reference():
    Ts = np.array([0.25, 1.0, 2.0])
    Fs = 100.0 * np.exp(0.03 * Ts)
    smiles = [JaxCalibrator.generate_synthetic_smile(F=F, T=T, alpha=TRUTH[0], beta=0.5,
                                                     rho=TRUTH[2], nu=TRUTH[3],
                                                     noise_std=1e-3, seed=7)
              for F, T in zip(Fs, Ts)]
    K = np.stack([s[0] for s in smiles])
    V = np.stack([s[1] for s in smiles])
    want = JaxCalibrator(beta=0.5).calibrate_surface_batch(K, V, Fs, Ts)
    got = _torch_cal().calibrate_surface_batch(K, V, Fs, Ts)
    for k in ("alpha", "rho", "nu"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), **PARAM_GATE, err_msg=k)
    np.testing.assert_allclose(got["rmse"], np.asarray(want["rmse"]), rtol=1e-6)
    np.testing.assert_array_equal(got["converged"], np.asarray(want["converged"]))


def test_batched_lm_data_matches_one_fit_per_problem(rng):
    """Per-start data in one LM call gives each problem the fit it gets
    alone: three exponential decays y = a exp(-b t) with their own t."""
    t = torch.as_tensor(rng.uniform(0.0, 3.0, (3, 12)))
    truth = torch.tensor([[2.0, 0.5], [1.0, 1.5], [3.0, 0.2]], dtype=F64)
    y = truth[:, :1] * torch.exp(-truth[:, 1:] * t)
    fn = lambda x, tt, yy: x[0] * torch.exp(-x[1] * tt) - yy  # noqa: E731
    lo, hi = torch.tensor([0.0, 0.0], dtype=F64), torch.tensor([5.0, 5.0], dtype=F64)
    x0 = torch.ones((3, 2), dtype=F64)
    batch = levenberg_marquardt(fn, x0, lo, hi, max_iter=30, data=(t, y))
    for s in range(3):
        one = levenberg_marquardt(lambda x: fn(x, t[s], y[s]), x0[s], lo, hi, max_iter=30)
        np.testing.assert_allclose(batch.x[s].numpy(), one.x.numpy(), rtol=1e-12)
    np.testing.assert_allclose(batch.x.numpy(), truth.numpy(), rtol=1e-8)


def test_interpolation_and_synthetic_smile_match_reference():
    jcal, tcal = JaxCalibrator(beta=0.5), _torch_cal()
    jp = {0.5: js.SABRParams(0.2, 0.5, -0.3, 0.4), 1.5: js.SABRParams(0.3, 0.5, -0.1, 0.6)}
    tp = {T: ts.SABRParams(*(float(x) for x in p)) for T, p in jp.items()}
    for T in (0.1, 0.5, 0.9, 1.5, 3.0):
        a, b = tcal.interpolate_parameters(T, tp), jcal.interpolate_parameters(T, jp)
        np.testing.assert_allclose([a.alpha, a.rho, a.nu],
                                   [float(b.alpha), float(b.rho), float(b.nu)], rtol=1e-14)
        np.testing.assert_allclose(tcal.get_implied_vol(95.0, T, tp, F1),
                                   jcal.get_implied_vol(95.0, T, jp, F1), rtol=1e-12)
    with pytest.raises(SABRCalibrationError):
        tcal.interpolate_parameters(1.0, {})
    np.testing.assert_allclose(tcal.sabr_implied_vol(F1, 90.0, 1.0, *TRUTH),
                               jcal.sabr_implied_vol(F1, 90.0, 1.0, *TRUTH), rtol=1e-12)
    for noise in (0.0, 1e-3):
        wk, wv = JaxCalibrator.generate_synthetic_smile(F=F1, noise_std=noise, seed=4)
        gk, gv = SABRCalibrator.generate_synthetic_smile(F=F1, noise_std=noise, seed=4,
                                                         device="cpu", dtype=F64)
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_allclose(gv, wv, rtol=1e-12)

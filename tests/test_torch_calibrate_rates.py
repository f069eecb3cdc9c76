"""The Hull-White and G2++ calibrators held against the JAX package.

Both packages fit the same quotes in float64 with the same LM (same
start, bounds and trip count); the fits are deterministic, so the port's
converged parameters are held at 1e-6 of the reference's and both fit
qualities at the JAX suite's gates.  The swaption fits run 15 LM
iterations, the G2 fits 12 at 32 Gauss-Hermite nodes (each LM iteration
prices the panel with its forward-mode Jacobian; both converge in under
ten); the parameters of a 3-4 swaption panel are
under-identified, which the 1e-6 parity still pins because both LMs walk
the same path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.calibrate.g2 import G2Calibrator as JG2
from pde_tpu.calibrate.rates import HullWhiteCalibrator as JHW
from pde_tpu.models import g2 as jg2
from pde_tpu.models import rates as jr
from pde_tpu_torch import interop
from pde_tpu_torch.calibrate.g2 import G2Calibrator
from pde_tpu_torch.calibrate.rates import HullWhiteCalibrator
from pde_tpu_torch.models import rates as tr

CPU64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def curves():
    t = np.array([0.5, 1.0, 2.0, 3.0, 5.0, 10.0, 30.0])
    z = np.array([0.030, 0.032, 0.035, 0.037, 0.040, 0.042, 0.043])
    jc = jr.curve_from_zero_rates(t, z)
    return jc, interop.discount_curve(jc)


def _same_fit(port, ref, rtol=1e-6):
    np.testing.assert_allclose([float(v) for v in port.params[:-1]],
                               [float(v) for v in ref.params[:-1]], rtol=rtol)
    assert port.converged == ref.converged
    assert isinstance(port.params[0], torch.Tensor) and port.params[0].device.type == "cpu"


def test_caplet_fit_matches_reference(curves):
    jc, tc = curves
    starts = np.array([0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 5.0, 7.0])
    ends = starts + 0.5
    truth = jr.HullWhiteParams(jnp.asarray(0.08), jnp.asarray(0.015), jc)
    strikes = np.asarray(jc.forward(starts, ends))
    quotes = np.asarray(jr.hw_caplet(truth, strikes, starts, ends))
    port = HullWhiteCalibrator(**CPU64).calibrate_caplets(tc, starts, ends, strikes, quotes)
    ref = JHW().calibrate_caplets(jc, starts, ends, strikes, quotes)
    _same_fit(port, ref)
    assert port.rmse < 1e-8 and port.max_rel_error < 1e-7
    assert abs(float(port.params.a) - 0.08) < 1e-4
    assert abs(float(port.params.sigma) - 0.015) < 1e-6
    # a warm start from the answer stays there
    warm = HullWhiteCalibrator(max_iter=5, **CPU64).calibrate_caplets(
        tc, starts, ends, strikes, quotes, x0=(0.08, 0.015))
    assert warm.rmse < 1e-8


def test_swaption_fit_matches_reference(curves):
    jc, tc = curves
    truth = jr.HullWhiteParams(jnp.asarray(0.12), jnp.asarray(0.010), jc)
    expiries = [1.0, 2.0, 3.0]
    pay_times = [np.arange(e + 0.5, e + 3.01, 0.5) for e in expiries]
    strikes = [float(jr.hw_swap_rate(jc, e, jnp.asarray(pt)))
               for e, pt in zip(expiries, pay_times)]
    price = jax.jit(jr.hw_swaption)  # one compile for the three (same-length) schedules
    quotes = np.array([float(price(truth, k, e, jnp.asarray(pt)))
                       for e, pt, k in zip(expiries, pay_times, strikes)])
    port = HullWhiteCalibrator(max_iter=15, **CPU64).calibrate_swaptions(
        tc, expiries, pay_times, strikes, quotes)
    ref = JHW(max_iter=15).calibrate_swaptions(jc, expiries, pay_times, strikes, quotes)
    _same_fit(port, ref)
    assert port.rmse < 1e-7
    assert abs(float(port.params.a) - 0.12) < 2e-3
    assert abs(float(port.params.sigma) - 0.010) < 1e-5


def test_strip_feeds_the_hw_fit_as_in_the_reference():
    """Flat cap vols -> forward caplet vols -> Black prices -> HW fit, in
    both packages; one-factor HW cannot match an arbitrary vol slope, so
    the fit stops at a few percent, at the reference's optimum."""
    t = np.array([0.5, 1.0, 2.0, 5.0, 10.0, 30.0])
    z = np.array([0.030, 0.032, 0.035, 0.040, 0.042, 0.043])
    jc = jr.curve_from_zero_rates(t, z)
    tc = interop.discount_curve(jc)
    mats, vols, k = [1.0, 2.0, 3.0], [0.25, 0.23, 0.215], 0.036
    starts, ends, fwd = tr.strip_caplet_vols(tc, k, mats, interop.tensor(vols))
    prices = tr.black_caplet_price(tc, k, starts, ends, fwd)
    port = HullWhiteCalibrator(**CPU64).calibrate_caplets(
        tc, starts, ends, torch.full(starts.shape, k, dtype=torch.float64), prices)
    js, je, jf = jr.strip_caplet_vols(jc, k, mats, jnp.asarray(vols))
    ref = JHW(max_iter=60).calibrate_caplets(jc, js, je, jnp.full(js.shape, k),
                                             jr.black_caplet_price(jc, k, js, je, jf))
    _same_fit(port, ref)
    assert port.rmse < 0.05
    assert np.all(tr.hw_caplet(port.params, k, starts, ends).numpy() > 0)


def test_float32_fit_takes_the_quotes_precision(curves):
    """Float32 quotes fit in float32 (the card's precision) to the float32
    gate of the JAX package's own f32 LM (tolerances floored at 4 eps)."""
    _, tc = curves
    starts = np.arange(0.5, 8.01, 0.5)
    ends = starts + 0.5
    truth = tr.HullWhiteParams(0.1, 0.012, tc)
    ks = tc.forward(interop.tensor(starts), interop.tensor(ends))
    quotes = tr.hw_caplet(truth, ks, interop.tensor(starts), interop.tensor(ends)).float()
    res = HullWhiteCalibrator(device="cpu").calibrate_caplets(tc, starts, ends, ks, quotes)
    assert res.params.a.dtype == torch.float32 and res.params.curve.dfs.dtype == torch.float32
    assert res.rmse <= 1e-4
    assert abs(float(res.params.sigma) / 0.012 - 1.0) < 0.01


def test_g2_fit_matches_reference(curves):
    jc, tc = curves
    truth = jg2.G2Params(*map(jnp.asarray, (0.5, 0.05, 0.011, 0.0085, -0.55)), jc)
    exps = [1.0, 2.0, 3.0, 5.0]
    pts = [np.arange(e + 0.5, e + 3.01, 0.5) for e in exps]
    ks = [float(jr.hw_swap_rate(jc, e, jnp.asarray(pt))) for e, pt in zip(exps, pts)]
    price = jax.jit(jg2.g2_swaption, static_argnames="n_gh")
    quotes = np.array([float(price(truth, k, e, jnp.asarray(pt), n_gh=32))
                       for e, pt, k in zip(exps, pts, ks)])
    port = G2Calibrator(max_iter=12, n_gh=32, **CPU64).calibrate_swaptions(
        tc, exps, pts, ks, quotes)
    ref = JG2(max_iter=12, n_gh=32).calibrate_swaptions(
        jc, exps, [jnp.asarray(p) for p in pts], ks, jnp.asarray(quotes))
    _same_fit(port, ref)
    assert port.rmse < 1e-8 and ref.rmse < 1e-8
    assert port.params.curve is not None and port.converged

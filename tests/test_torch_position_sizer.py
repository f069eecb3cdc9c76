"""The port's position sizer held against ``pde_tpu``.

The same seeded numpy returns go through both packages in float64 (the JAX
side under ``jax_enable_x64``).  Gates, each with its reason:
- EWMA: 1e-12 relative; the port's weighted sum and the reference's scan
  round in another order;
- GARCH's variance path 1e-12, its likelihood and gradient 1e-10: the
  port's log-depth scan against the reference's step loop;
- the fitted one-step vol 1e-6 relative, on GARCH(1,1) series whose
  maximum is identified.  On i.i.d. returns the likelihood is flat along
  a valley (alpha -> 0), and L-BFGS-B stops where its tolerance meets it:
  there the reference's own fit moves by ~4e-5 when the returns move by
  one part in 1e15, so those cases are held to the reference test's range;
- the numpy sizers and the confidence interval: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.risk import position_sizer as jps
from pde_tpu_torch.risk import position_sizer as tps

CPU = dict(device="cpu")
REL = dict(rtol=1e-12, atol=0.0)


def _garch_series(n, seed, omega=2e-6, a=0.08, b=0.9):
    """A GARCH(1,1) return series from seeded normals (numpy)."""
    z = np.random.default_rng(seed).standard_normal(n)
    var, out = omega / (1.0 - a - b), np.empty(n)
    for t in range(n):
        out[t] = np.sqrt(var) * z[t]
        var = omega + a * out[t] ** 2 + b * var
    return out


@pytest.fixture
def returns_20pct(rng):
    """Daily returns with ~20% annualized vol."""
    return rng.normal(0.0, 0.20 / np.sqrt(252), 500)


@pytest.fixture(scope="module")
def garch_fits():
    """One fit of the reference per series (its jitted likelihood compiles
    once for the length): {seed: (returns, vol)}."""
    series = {seed: _garch_series(252, seed) for seed in (1, 2, 3)}
    return {seed: (r, jps.VolatilityEstimator("garch").estimate(r))
            for seed, r in series.items()}


def _jax_garch_path(params_vec, returns):
    """The reference likelihood's variance path (position_sizer.py:62-78,
    the scan's carry at each step)."""
    omega = jnp.exp(params_vec[0])
    a = jax.nn.sigmoid(params_vec[1])
    b = jax.nn.sigmoid(params_vec[2]) * (1.0 - a) * 0.999

    def step(var, r):
        return omega + a * r * r + b * var, var

    return jax.lax.scan(step, jnp.var(returns), returns)[1]


# (log omega, logit alpha, logit beta'): the fit's start, a persistent
# model, and beta' squeezed to ~0 and to exactly 0 in float64
PARAM_POINTS = {"start": None, "persistent": (-3.0, -2.5, 3.0),
                "beta_small": (-1.0, -1.0, -40.0), "beta_zero": (-1.0, -1.0, -800.0)}


def _point(name, returns):
    p = PARAM_POINTS[name]
    return np.array([np.log(0.1 * np.var(returns)), 0.0, 2.0] if p is None else p)


@pytest.mark.parametrize("n", [5, 10, 11, 252, 500])
@pytest.mark.parametrize("lam", [0.94, 0.5])
def test_ewma_variance_matches_the_scan(rng, n, lam):
    r = rng.normal(0.0, 0.012, n)
    want = float(jps._ewma_variance(jnp.asarray(r), lam))
    got = float(tps._ewma_variance(torch.as_tensor(r), lam))
    np.testing.assert_allclose(got, want, **REL)


@pytest.mark.parametrize("name", sorted(PARAM_POINTS))
def test_garch_variance_path_matches_the_scan(name):
    r = _garch_series(252, 4) * 100.0
    x = _point(name, r)
    want = np.asarray(_jax_garch_path(jnp.asarray(x), jnp.asarray(r)))
    got = tps._garch_variance(torch.as_tensor(x), torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(got, want, **REL)


@pytest.mark.parametrize("name", sorted(PARAM_POINTS))
def test_garch_likelihood_and_gradient(name):
    """Value and gradient at 1e-10; near and at beta = 0 the gradient stays
    finite (no pow of b carries a b^-1)."""
    r = _garch_series(252, 5) * 100.0
    x = _point(name, r)
    jv, jg = jps._garch_value_and_grad(jnp.asarray(x), jnp.asarray(r))
    tv, tg = tps._garch_value_and_grad(torch.as_tensor(x), torch.as_tensor(r))
    assert bool(torch.isfinite(tg).all())
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-10, atol=0.0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(float(tv), float(tps._garch_neg_ll(torch.as_tensor(x),
                                                                  torch.as_tensor(r))), **REL)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_garch_fit_matches_the_reference(garch_fits, seed):
    r, want = garch_fits[seed]
    got = tps.VolatilityEstimator("garch", **CPU).estimate(r)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)


def test_garch_fallback_catches_numerics_only(monkeypatch, garch_fits):
    """An objective that raises ValueError falls back to EWMA in both
    packages; a RuntimeError (what a device fault raises) propagates in the
    port, where the reference's ``except Exception`` would swallow it."""
    r = garch_fits[1][0]

    def numerics(*args):
        raise ValueError("bad likelihood")

    def device_fault(*args):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(jps, "_garch_value_and_grad", numerics)
    monkeypatch.setattr(tps, "_garch_value_and_grad", numerics)
    want = jps.VolatilityEstimator("garch").estimate(r)
    assert want == jps.VolatilityEstimator("ewma").estimate(r)
    got = tps.VolatilityEstimator("garch", **CPU).estimate(r)
    np.testing.assert_allclose(got, want, **REL)
    np.testing.assert_allclose(got, tps.VolatilityEstimator("ewma", **CPU).estimate(r), **REL)

    monkeypatch.setattr(tps, "_garch_value_and_grad", device_fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tps.VolatilityEstimator("garch", **CPU).estimate(r)


# --- the reference's TestVolatilityEstimator, each against pde_tpu -------

@pytest.mark.parametrize("method", ["realized", "ewma", "hybrid"])
@pytest.mark.parametrize("lookback", [21, 252])
def test_estimate_matches_the_reference(returns_20pct, method, lookback):
    want = jps.VolatilityEstimator(method, lookback_days=lookback).estimate(returns_20pct)
    got = tps.VolatilityEstimator(method, lookback_days=lookback, **CPU).estimate(returns_20pct)
    np.testing.assert_allclose(got, want, **REL)


def test_realized_recovers_vol(returns_20pct):
    est = tps.VolatilityEstimator(tps.VolatilityMethod.REALIZED, lookback_days=252, **CPU)
    assert abs(est.estimate(returns_20pct) - 0.20) < 0.04


def test_garch_native_fit(returns_20pct):
    vol = tps.VolatilityEstimator(tps.VolatilityMethod.GARCH, **CPU).estimate(returns_20pct)
    assert 0.1 < vol < 0.4


def test_hybrid_between(returns_20pct):
    r = tps.VolatilityEstimator("realized", **CPU).estimate(returns_20pct)
    e = tps.VolatilityEstimator("ewma", **CPU).estimate(returns_20pct)
    h = tps.VolatilityEstimator("hybrid", **CPU).estimate(returns_20pct)
    assert min(r, e) - 1e-12 <= h <= max(r, e) + 1e-12


def test_insufficient_data_and_prices(rng):
    assert tps.VolatilityEstimator(**CPU).estimate(np.array([0.01, 0.02])) == 0.20
    prices = 100.0 * np.exp(np.cumsum(rng.normal(0.0, 0.01, 60)))
    for method in ("realized", "ewma"):
        want = jps.VolatilityEstimator(method).estimate([], prices=prices)
        got = tps.VolatilityEstimator(method, **CPU).estimate([], prices=prices)
        np.testing.assert_allclose(got, want, **REL)
    with pytest.raises(ValueError, match="implied"):
        tps.VolatilityEstimator("implied", **CPU).estimate(prices)


@pytest.mark.parametrize("method", ["realized", "ewma", "hybrid"])
def test_batch_matches_the_reference_and_scalar(rng, method):
    """estimate_batch: one call on the device, equal to the reference's
    batch and to the port's own scalar estimate row by row."""
    rets = rng.normal(0, 0.013, (4, 300))
    want = jps.VolatilityEstimator(method).estimate_batch(rets)
    est = tps.VolatilityEstimator(method, **CPU)
    got = est.estimate_batch(rets)
    assert got.shape == (4,) and np.all(got > 0)
    np.testing.assert_allclose(got, want, **REL)
    np.testing.assert_allclose(got, [est.estimate(r) for r in rets], **REL)


def test_garch_batch_matches_scalar(garch_fits):
    rets = np.stack([garch_fits[s][0] for s in (1, 2)])
    est = tps.VolatilityEstimator("garch", **CPU)
    got = est.estimate_batch(rets)
    np.testing.assert_allclose(got, [garch_fits[1][1], garch_fits[2][1]], rtol=1e-6, atol=0.0)
    np.testing.assert_allclose(got, [est.estimate(r) for r in rets], **REL)


@pytest.mark.parametrize("n", [8, 500])
def test_confidence_interval(returns_20pct, n):
    want = jps.VolatilityEstimator().estimate_with_confidence(returns_20pct[:n])
    got = tps.VolatilityEstimator(**CPU).estimate_with_confidence(returns_20pct[:n])
    np.testing.assert_allclose(got, want, **REL)
    assert got[1] < got[0] < got[2]


def test_float32_estimator_keeps_its_dtype(rng):
    """dtype names the working precision; the estimate stays within float32
    rounding of the float64 one."""
    rets = rng.normal(0, 0.013, (3, 260))
    f64 = tps.VolatilityEstimator("ewma", **CPU).estimate_batch(rets)
    f32 = tps.VolatilityEstimator("ewma", dtype=torch.float32, **CPU).estimate_batch(rets)
    assert f32.dtype == np.float32
    np.testing.assert_allclose(f32, f64, rtol=1e-5)


# --- the reference's TestVolScaledSizer, each against pde_tpu ------------

SIZER_CASES = {
    "uncapped": (dict(target_annual_vol=0.15, max_position_pct=1.0, vol_lookback_days=252),
                 0.0),
    "capped": (dict(max_position_pct=0.10), 0.0),
    "drawdown": (dict(max_position_pct=10.0), 0.25),
    "deep_drawdown": (dict(max_position_pct=10.0), 0.5),
    "defaults": ({}, 0.05),
}


@pytest.mark.parametrize("case", sorted(SIZER_CASES))
def test_position_size_matches_the_reference(returns_20pct, case):
    cfg, drawdown = SIZER_CASES[case]
    want = jps.VolatilityScaledPositionSizer(jps.PositionSizerConfig(**cfg)).compute_position_size(
        returns_20pct, 1_000_000, current_drawdown=drawdown)
    got = tps.VolatilityScaledPositionSizer(tps.PositionSizerConfig(**cfg)).compute_position_size(
        returns_20pct, 1_000_000, current_drawdown=drawdown)
    assert got.to_dict() == want.to_dict()


def test_scaling_formula(returns_20pct):
    """w = sigma_target^2/sigma_realized^2 (Moreira-Muir)."""
    sizer = tps.VolatilityScaledPositionSizer(
        tps.PositionSizerConfig(target_annual_vol=0.15, max_position_pct=1.0, vol_lookback_days=252))
    res = sizer.compute_position_size(returns_20pct, 1_000_000)
    expected_w = np.clip((0.15 / res.realized_vol) ** 2, 0.2, 2.0)
    assert abs(res.target_weight - expected_w) < 1e-10
    assert res.position_size == pytest.approx(1_000_000 * res.target_weight)


def test_low_vol_and_drawdown(rng, returns_20pct):
    sizer = tps.VolatilityScaledPositionSizer(tps.PositionSizerConfig(max_position_pct=10.0))
    calm = rng.normal(0, 0.05 / np.sqrt(252), 100)
    assert sizer.compute_position_size(calm, 1_000_000).target_weight == 2.0
    normal = sizer.compute_position_size(returns_20pct, 1e6, current_drawdown=0.05)
    stressed = sizer.compute_position_size(returns_20pct, 1e6, current_drawdown=0.25)
    assert stressed.target_weight < normal.target_weight


def test_portfolio_weights_and_required_capital(returns_20pct, rng):
    books = {"a": returns_20pct, "b": rng.normal(0, 0.005, 300), "c": rng.normal(0, 0.02, 3)}
    alloc = {"a": 0.5, "b": 0.3}
    for allocations in (None, alloc):
        want = jps.VolatilityScaledPositionSizer().compute_portfolio_weights(books, 1e6, allocations)
        got = tps.VolatilityScaledPositionSizer().compute_portfolio_weights(books, 1e6, allocations)
        assert {k: v.to_dict() for k, v in got.items()} == {k: v.to_dict()
                                                            for k, v in want.items()}
    for rets in books.values():
        assert (tps.VolatilityScaledPositionSizer().estimate_required_capital(2e5, rets)
                == jps.VolatilityScaledPositionSizer().estimate_required_capital(2e5, rets))


@pytest.mark.parametrize("p, b", [(0.6, 2.0), (0.4, 1.0), (0.9, 5.0)])
def test_kelly(p, b):
    want = jps.KellyPositionSizer(kelly_fraction=0.5).compute_position_size(p, b, 1e6)
    got = tps.KellyPositionSizer(kelly_fraction=0.5).compute_position_size(p, b, 1e6)
    assert got.rationale == want.rationale and got.target_weight == want.target_weight
    assert got.position_size == want.position_size and np.isnan(got.realized_vol)


def test_kelly_rejects_bad_inputs():
    kelly = tps.KellyPositionSizer(kelly_fraction=0.5)
    assert abs(kelly.compute_position_size(0.6, 2.0, 1e6).target_weight - 0.2) < 1e-12
    with pytest.raises(ValueError):
        kelly.compute_position_size(1.5, 2.0, 1e6)
    with pytest.raises(ValueError):
        kelly.compute_position_size(0.5, 0.0, 1e6)

"""``pde_tpu_torch.models.bates`` and ``calibrate.bates`` held against the
JAX package.

Same seeded inputs through ``pde_tpu`` (x64, as the suite runs it) and the
port in float64 on the CPU.  Gates: 1e-8 on price, 1e-6 on implied vol,
1e-12 on the hooks and the parameter plumbing.  The JAX suite's oracles
are kept: lam = 0 is Heston, and sigma -> 0 is Merton's series.  The
calibrators are compared on converged parameters and fit quality (their
DE draws differ: threefry against Philox).
"""

import numpy as np
import pytest
import torch

from pde_tpu.calibrate import bates as jcal
from pde_tpu.models import bates as jb
from pde_tpu.models import heston as jh
from pde_tpu_torch import interop
from pde_tpu_torch.calibrate import bates as tcal
from pde_tpu_torch.models import bates as tb
from pde_tpu_torch.models import heston as th

S0, R, Q = 100.0, 0.05, 0.02
F64 = torch.float64
PRICE_ATOL, IV_ATOL = 1e-8, 1e-6
BATES = (2.0, 0.04, 0.3, -0.7, 0.04, 0.5, -0.1, 0.15)
JP = jb.BatesParams(*BATES)


def _tp(p=JP):
    return interop.bates_params(p)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def chain():
    """A seeded chain: strikes in [70, 130] over 4 maturities, calls above
    the money and puts below."""
    rng = np.random.default_rng(11)
    K = np.sort(rng.uniform(70.0, 130.0, 24))
    T = rng.choice([0.1, 0.4, 1.0, 2.0], 24)
    return K, T, K >= S0


# ---------------------------------------------------------------- BatesParams

class TestParams:
    @pytest.mark.parametrize("bad,match", [
        (dict(lam=-0.1), "lam"), (dict(sigma_j=0.0), "sigma_j"),
        (dict(kappa=0.0), "kappa"), (dict(rho=1.0), "rho"), (dict(v0=-1e-3), "v0"),
    ])
    def test_validate_raises_as_reference(self, bad, match):
        jp = JP._replace(**bad)
        with pytest.raises(ValueError, match=match):
            jp.validate()
        with pytest.raises(ValueError, match=match):
            _tp(jp).validate()

    def test_validate_accepts_good_params(self):
        JP.validate()
        _tp().validate()

    def test_to_array_stacks_on_the_last_axis(self, rng):
        lam = rng.uniform(0.1, 2.0, (3, 1))
        mu = rng.uniform(-0.2, 0.0, (1, 4))
        jp = JP._replace(lam=lam, mu_j=mu)
        want = np.asarray(jp.to_array())
        got = _tp(jp).to_array()
        assert tuple(got.shape) == want.shape == (3, 4, 8)
        np.testing.assert_array_equal(got.numpy(), want)
        back = tb.BatesParams.from_array(got)
        ref = jb.BatesParams.from_array(want)
        for k in tb.BatesParams._fields:
            np.testing.assert_array_equal(_np(getattr(back, k)), np.asarray(getattr(ref, k)))

    def test_conveniences_match_reference(self):
        tp = _tp()
        np.testing.assert_allclose(_np(tp.mean_jump), float(JP.mean_jump), rtol=1e-14)
        np.testing.assert_allclose(_np(tp.feller_value()), float(JP.feller_value()), rtol=1e-14)
        assert bool(tp.feller_satisfied()) == bool(JP.feller_satisfied())
        assert tuple(float(x) for x in tp.heston()) == tuple(JP.heston())
        # plain numbers stay plain numbers (no device involved)
        assert tb.BatesParams(*BATES).mean_jump == pytest.approx(float(JP.mean_jump), rel=1e-14)


# -------------------------------------------------------------------- hooks

class TestHooks:
    def test_cf_reduced_extra(self, rng):
        u = rng.uniform(0.0, 40.0, 33) - 1j * rng.uniform(0.0, 2.0, 33)
        T = rng.uniform(0.05, 3.0, (5, 1))
        want = np.asarray(JP.cf_reduced_extra(u, T, np.float64, np.complex128))
        got = _tp().cf_reduced_extra(torch.as_tensor(u), interop.tensor(T), F64,
                                     torch.complex128)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)

    def test_cf_reduced_extra_is_one_at_minus_i(self):
        got = _tp().cf_reduced_extra(torch.tensor([-1j], dtype=torch.complex128),
                                     interop.tensor(1.3), F64, torch.complex128)
        np.testing.assert_allclose(got.numpy(), [1.0 + 0j], atol=1e-15)

    def test_qv_hooks(self, rng):
        s = rng.uniform(0.0, 50.0, 17)
        tp = _tp()
        np.testing.assert_allclose(_np(tp.qv_rate_extra()), float(JP.qv_rate_extra()),
                                   rtol=1e-14)
        np.testing.assert_allclose(tp.qv_laplace_extra(interop.tensor(s), 0.7).numpy(),
                                   np.asarray(JP.qv_laplace_extra(s, 0.7)), rtol=1e-13)
        np.testing.assert_allclose(tp.qv_log_laplace_extra(interop.tensor(s), 0.7).numpy(),
                                   np.asarray(JP.qv_log_laplace_extra(s, 0.7)), rtol=1e-13,
                                   atol=1e-16)


# -------------------------------------------------------------- the pricers

def _grouped(T):
    unique_T, t_idx = jh.group_maturities(T)
    return (unique_T, t_idx), interop.grouping(t_idx, unique_T)


@pytest.mark.parametrize("name", ["price_carr_madan_gl", "price_accurate"])
def test_pricers_match_reference(chain, name):
    K, T, calls = chain
    want = np.asarray(getattr(jb, name)(JP, K, T, S0, R, Q, calls))
    got = getattr(tb, name)(_tp(), interop.tensor(K), interop.tensor(T), S0, R, Q,
                            torch.as_tensor(calls))
    np.testing.assert_allclose(got.numpy(), want, atol=PRICE_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["price_carr_madan_gl_grouped", "price_accurate_grouped"])
def test_grouped_pricers_match_reference(chain, name):
    K, T, calls = chain
    (unique_T, t_idx), (tt_idx, tunique_T) = _grouped(T)
    want = np.asarray(getattr(jb, name)(JP, K, t_idx, unique_T, S0, R, Q, calls))
    got = getattr(tb, name)(_tp(), interop.tensor(K), tt_idx, tunique_T, S0, R, Q,
                            torch.as_tensor(calls))
    np.testing.assert_allclose(got.numpy(), want, atol=PRICE_ATOL, rtol=0)


def test_price_fft_matches_reference():
    k_j, c_j = jb.price_fft(JP, 1.0, S0, R, Q, n_fft=1024)
    k_t, c_t = tb.price_fft(_tp(), interop.tensor(1.0), interop.tensor(S0), R, Q, n_fft=1024)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), atol=1e-12)
    band = (np.exp(np.asarray(k_j)) > 1.0) & (np.exp(np.asarray(k_j)) < 1e4)
    np.testing.assert_allclose(c_t.numpy()[band], np.asarray(c_j)[band], atol=PRICE_ATOL)


def test_implied_vols_match_reference(chain):
    K, T, calls = chain
    want = np.asarray(jb.implied_volatility(JP, K, T, S0, R, Q, calls, accurate=True))
    got = tb.implied_volatility(_tp(), interop.tensor(K), interop.tensor(T), S0, R, Q,
                                torch.as_tensor(calls), accurate=True)
    np.testing.assert_allclose(got.numpy(), want, atol=IV_ATOL)
    (unique_T, t_idx), (tt_idx, tunique_T) = _grouped(T)
    want = np.asarray(jb.implied_volatility_grouped(JP, K, t_idx, unique_T, S0, R, Q, calls,
                                                    accurate=True))
    got = tb.implied_volatility_grouped(_tp(), interop.tensor(K), tt_idx, tunique_T, S0, R,
                                        Q, torch.as_tensor(calls), accurate=True)
    np.testing.assert_allclose(got.numpy(), want, atol=IV_ATOL)


def test_population_prices_in_one_call(chain):
    """(P, 1, 1) fields, jump factor included, price a population at once."""
    K, T, calls = chain
    (_, _), (tt_idx, tunique_T) = _grouped(T)
    pop = interop.tensor(np.array([BATES, (1.5, 0.05, 0.4, -0.5, 0.03, 1.0, -0.05, 0.2),
                                   (3.0, 0.03, 0.2, -0.8, 0.05, 0.2, -0.2, 0.1)]))
    batch = tcal._price_vec(pop, interop.tensor(K), tt_idx, tunique_T,
                            torch.as_tensor(calls), S0, R, Q)
    assert tuple(batch.shape) == (3, len(K))
    for i in range(3):
        want = np.asarray(jcal._price_vec(np.asarray(pop[i]), K, np.asarray(tt_idx),
                                          np.asarray(tunique_T), calls, S0, R, Q))
        np.testing.assert_allclose(batch[i].numpy(), want, atol=PRICE_ATOL, rtol=0)


# ------------------------------------------------------------------ oracles

def test_lam_zero_is_heston(chain):
    K, T, calls = chain
    heston = th.HestonParams(*(interop.tensor(v) for v in BATES[:5]))
    no_jumps = _tp(JP._replace(lam=0.0))
    np.testing.assert_allclose(
        tb.price_accurate(no_jumps, interop.tensor(K), interop.tensor(T), S0, R, Q).numpy(),
        th.price_accurate(heston, interop.tensor(K), interop.tensor(T), S0, R, Q).numpy(),
        rtol=1e-12, atol=1e-12)


def test_merton_oracle_at_vanishing_vol_of_vol():
    """sigma -> 0 with v0 = theta = vol^2: the Bates price is Merton's
    series (the JAX suite's gate, tests/test_bates.py:39-56)."""
    vol, lam, mu_j, sj = 0.2, 0.8, -0.1, 0.15
    p = tb.BatesParams(*(interop.tensor(v) for v in (1.0, vol**2, 1e-4, 0.0, vol**2, lam,
                                                      mu_j, sj)))
    K = np.linspace(80.0, 120.0, 9)
    for T in (0.25, 1.0):
        got = tb.price_accurate(p, interop.tensor(K), interop.tensor(T), S0, R, Q).numpy()
        ref = tb.merton_reference_price(K, T, S0, R, Q, vol, lam, mu_j, sj)
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("is_call", [True, False])
def test_merton_reference_price_is_the_reference_s(is_call):
    K = np.linspace(70.0, 130.0, 13)
    np.testing.assert_allclose(
        tb.merton_reference_price(K, 0.7, S0, R, Q, 0.25, 0.6, -0.08, 0.18, is_call=is_call),
        jb.merton_reference_price(K, 0.7, S0, R, Q, 0.25, 0.6, -0.08, 0.18, is_call=is_call),
        rtol=1e-15, atol=1e-15)


def test_put_call_parity(chain):
    K, T, _ = chain
    p = _tp()
    call = tb.price_accurate(p, interop.tensor(K), interop.tensor(T), S0, R, Q, True)
    put = tb.price_accurate(p, interop.tensor(K), interop.tensor(T), S0, R, Q, False)
    parity = S0 * np.exp(-Q * T) - K * np.exp(-R * T)
    np.testing.assert_allclose((call - put).numpy(), parity, atol=1e-9)


# --------------------------------------------------------------- calibrator

TRUE = dict(kappa=2.0, theta=0.04, sigma=0.35, rho=-0.65, v0=0.05, lam=0.5, mu_j=-0.1,
            sigma_j=0.15)
BUDGET = dict(global_maxiter=20, global_popsize=10, local_max_iter=30, seed=1)


@pytest.fixture(scope="module")
def surface():
    return jcal.BatesCalibrator.generate_synthetic_data(S0=S0, r=R, q=Q, n_strikes=9,
                                                        n_maturities=3, **TRUE)


@pytest.fixture(scope="module")
def fits(surface):
    args = (surface["strike"], surface["maturity"], surface["mid_price"], S0, R, Q)
    kw = dict(is_calls=surface["is_call"])
    return (jcal.BatesCalibrator(**BUDGET).calibrate(*args, **kw),
            tcal.BatesCalibrator(device="cpu", dtype=F64, **BUDGET).calibrate(*args, **kw))


def test_synthetic_data_matches_reference(surface):
    got = tcal.BatesCalibrator.generate_synthetic_data(S0=S0, r=R, q=Q, n_strikes=9,
                                                       n_maturities=3, device="cpu",
                                                       dtype=F64, **TRUE)
    for k in ("strike", "maturity", "is_call"):
        np.testing.assert_array_equal(got[k], np.asarray(surface[k]))
    np.testing.assert_allclose(got["mid_price"], np.asarray(surface["mid_price"]),
                               atol=PRICE_ATOL, rtol=0)


def test_calibrator_recovers_its_surface(fits):
    _, res = fits
    assert res.rmse < 5e-3 and res.fit_quality["r_squared"] > 0.999, res.to_dict()
    for k, v in TRUE.items():
        assert abs(getattr(res.params, k) - v) < 1e-4 * max(1.0, abs(v)), (k, res.params)


def test_calibrator_converges_where_the_reference_does(fits):
    """Converged parameters and fit quality, not draw by draw."""
    ref, res = fits
    np.testing.assert_allclose([getattr(res.params, k) for k in tcal.PARAM_ORDER],
                               [float(getattr(ref.params, k)) for k in jcal.PARAM_ORDER],
                               atol=1e-6)
    assert res.rmse < 1e-8 and ref.rmse < 1e-8
    assert set(res.fit_quality) == set(ref.fit_quality)
    assert set(res.convergence) == set(ref.convergence)
    assert set(res.to_dict()) == set(ref.to_dict())


def test_calibrator_with_x0_and_no_warm_start(surface):
    """x0 seeds the search (no Heston warm start); the pipeline keeps the
    informed seed as an LM start."""
    cal = tcal.BatesCalibrator(device="cpu", dtype=F64, global_maxiter=3,
                               global_popsize=4, local_max_iter=15, seed=3)
    res = cal.calibrate(surface["strike"], surface["maturity"], surface["mid_price"],
                        S0, R, Q, x0=tb.BatesParams(**{k: v * 1.02 for k, v in TRUE.items()}))
    assert res.rmse < 1e-6, res.to_dict()
    cold = tcal.BatesCalibrator(device="cpu", dtype=F64, global_maxiter=2,
                                global_popsize=4, local_max_iter=2,
                                warm_start_heston=False)
    out = cold.calibrate(surface["strike"], surface["maturity"], surface["mid_price"],
                         S0, R, Q)
    assert np.isfinite(out.rmse) and out.convergence["global_iterations"] <= 2

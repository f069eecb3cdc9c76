"""``pde_tpu_torch.models.svcj`` held against the JAX package.

Same inputs through ``pde_tpu`` (x64) and the port in float64 on the CPU:
the closed-form time integral, the co-jump CF factor, the variance-swap
hooks and the re-exported pricers at 1e-8 on price, 1e-6 on implied vol.
The JAX suite's reductions are kept: mu_v = 0 is Bates, lam = 0 is Heston.
"""

import numpy as np
import pytest
import torch

from pde_tpu.models import heston as jh
from pde_tpu.models import svcj as js
from pde_tpu_torch import interop
from pde_tpu_torch.models import bates as tb
from pde_tpu_torch.models import heston as th
from pde_tpu_torch.models import svcj as ts

S0, R, Q = 100.0, 0.05, 0.02
F64, C128 = torch.float64, torch.complex128
SVCJ = (2.0, 0.04, 0.3, -0.7, 0.04, 0.5, -0.1, 0.15, 0.05, -0.5)
JP = js.SVCJParams(*SVCJ)
K = np.linspace(75.0, 125.0, 11)
T = np.array([0.1, 0.25, 0.5, 1.0, 1.5, 2.0, 0.5, 1.0, 0.25, 0.1, 2.0])


def _tp(p=JP):
    return interop.svcj_params(p)


def test_int_recip_affine_matches_reference(rng):
    n = 21
    c, e, a = (rng.normal(size=n) + 1j * rng.normal(size=n) for _ in range(3))
    a = a + 3.0
    b = rng.normal(size=n) + 1j * rng.normal(size=n)
    b[::5] = 1e-14  # the removable b -> 0 branch
    gamma = 1.0 + rng.uniform(size=n) + 1j * rng.normal(size=n)
    want = np.asarray(js._int_recip_affine(c, e, a, b, gamma, 0.8))
    got = ts._int_recip_affine(*(torch.as_tensor(x) for x in (c, e, a, b, gamma)),
                               interop.tensor(0.8))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def test_cf_reduced_extra_matches_reference(rng):
    u = rng.uniform(0.0, 40.0, 29) - 1j * rng.uniform(0.0, 2.0, 29)
    Tm = rng.uniform(0.05, 3.0, (4, 1))
    want = np.asarray(JP.cf_reduced_extra(u, Tm, np.float64, np.complex128))
    got = _tp().cf_reduced_extra(torch.as_tensor(u), interop.tensor(Tm), F64, C128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-11, atol=1e-14)
    one = _tp().cf_reduced_extra(torch.tensor([-1j], dtype=C128), interop.tensor(0.9), F64,
                                 C128)
    np.testing.assert_allclose(one.numpy(), [1.0 + 0j], atol=1e-14)


@pytest.mark.parametrize("maturity", [0.25, 1.0, 3.0])
def test_variance_swap_hooks_match_reference(rng, maturity):
    s = rng.uniform(0.0, 30.0, 13)
    tp = _tp()
    np.testing.assert_allclose(tp.qv_mean_extra(interop.tensor(maturity)).numpy(),
                               float(JP.qv_mean_extra(maturity)), rtol=1e-13)
    np.testing.assert_allclose(
        tp.qv_log_laplace_extra(interop.tensor(s), interop.tensor(maturity)).numpy(),
        np.asarray(JP.qv_log_laplace_extra(s, maturity)), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(
        tp.qv_laplace_extra(interop.tensor(s), interop.tensor(maturity)).numpy(),
        np.asarray(JP.qv_laplace_extra(s, maturity)), rtol=1e-12)


@pytest.mark.parametrize("name", ["price_carr_madan_gl", "price_accurate"])
def test_pricers_match_reference(name):
    calls = K >= S0
    want = np.asarray(getattr(js, name)(JP, K, T, S0, R, Q, calls))
    got = getattr(ts, name)(_tp(), interop.tensor(K), interop.tensor(T), S0, R, Q,
                            torch.as_tensor(calls))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=0)


def test_grouped_pricer_and_implied_vol_match_reference():
    unique_T, t_idx = jh.group_maturities(T)
    tt_idx, tuT = interop.grouping(t_idx, unique_T)
    want = np.asarray(js.price_accurate_grouped(JP, K, t_idx, unique_T, S0, R, Q))
    got = ts.price_accurate_grouped(_tp(), interop.tensor(K), tt_idx, tuT, S0, R, Q)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=0)
    want = np.asarray(js.implied_volatility(JP, K, T, S0, R, Q, accurate=True))
    got = ts.implied_volatility(_tp(), interop.tensor(K), interop.tensor(T), S0, R, Q,
                                accurate=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_price_fft_matches_reference():
    k_j, c_j = js.price_fft(JP, 0.75, S0, R, Q, n_fft=1024)
    k_t, c_t = ts.price_fft(_tp(), interop.tensor(0.75), interop.tensor(S0), R, Q,
                            n_fft=1024)
    band = (np.exp(np.asarray(k_j)) > 1.0) & (np.exp(np.asarray(k_j)) < 1e4)
    np.testing.assert_allclose(c_t.numpy()[band], np.asarray(c_j)[band], atol=1e-8)


def test_mu_v_zero_is_bates():
    p = _tp(JP._replace(mu_v=0.0, rho_j=0.0))
    bates = tb.BatesParams(*(interop.tensor(v) for v in SVCJ[:8]))
    np.testing.assert_allclose(
        ts.price_accurate(p, interop.tensor(K), interop.tensor(T), S0, R, Q).numpy(),
        tb.price_accurate(bates, interop.tensor(K), interop.tensor(T), S0, R, Q).numpy(),
        rtol=1e-10, atol=1e-10)


def test_lam_zero_is_heston():
    p = _tp(JP._replace(lam=0.0))
    heston = th.HestonParams(*(interop.tensor(v) for v in SVCJ[:5]))
    np.testing.assert_allclose(
        ts.price_accurate(p, interop.tensor(K), interop.tensor(T), S0, R, Q).numpy(),
        th.price_accurate(heston, interop.tensor(K), interop.tensor(T), S0, R, Q).numpy(),
        rtol=1e-12, atol=1e-12)


def test_to_array_stacks_on_the_first_axis():
    """The reference stacks SVCJ on axis 0 (Bates on the last)."""
    want = np.asarray(JP.to_array())
    got = _tp().to_array()
    assert tuple(got.shape) == want.shape == (10,)
    np.testing.assert_array_equal(got.numpy(), want)
    rows = np.stack([np.linspace(1.0, 2.0, 3)] * 10) * np.arange(1, 11)[:, None]
    back = ts.SVCJParams.from_array(interop.tensor(rows))
    ref = js.SVCJParams.from_array(rows)
    for k in ts.SVCJParams._fields:
        np.testing.assert_array_equal(getattr(back, k).numpy(), np.asarray(getattr(ref, k)))


@pytest.mark.parametrize("bad,match", [
    (dict(lam=-0.1), "non-negative"), (dict(mu_v=-0.01), "non-negative"),
    (dict(rho_j=25.0), "finite jump compensator"), (dict(rho=1.0), "rho"),
])
def test_validate_raises_as_reference(bad, match):
    jp = JP._replace(**bad)
    with pytest.raises(ValueError, match=match):
        jp.validate()
    with pytest.raises(ValueError, match=match):
        _tp(jp).validate()


def test_conveniences_match_reference():
    tp = _tp()
    JP.validate()
    tp.validate()
    np.testing.assert_allclose(tp.mean_jump().numpy(), float(JP.mean_jump()), rtol=1e-14)
    assert bool(tp.feller_satisfied()) == bool(JP.feller_satisfied())
    np.testing.assert_allclose(tp.feller_value().numpy(), float(JP.feller_value()))
    assert tuple(float(x) for x in tp.heston()) == tuple(JP.heston())


@pytest.mark.parametrize("rule", ["_gauss_hermite", "_gauss_laguerre", "_gauss_legendre"])
def test_gauss_rules_are_the_reference_s(rule):
    for a, b in zip(getattr(ts, rule)(16), getattr(js, rule)(16)):
        np.testing.assert_array_equal(a, b)

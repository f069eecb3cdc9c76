"""``pde_tpu_torch.models.multi_asset`` (the closed-form and quadrature
half) held against the JAX package.

Same inputs through ``pde_tpu`` (x64) and the port in float64 on the CPU,
at 1e-8 on price.  The reference prices one quote a call and ``vmap``s over
a book; the port prices the whole book in one broadcast call, which is
held against the reference's ``vmap``.  ``implied_correlation`` brackets in
float32 in both, so it is held at two float32 ulps.  The JAX suite's
oracles are kept: the bivariate CDF against ``scipy.stats``, Margrabe as
Kirk at K = 0, and call-on-max + call-on-min = the two vanillas.
"""

import jax
import numpy as np
import pytest
import torch
from scipy.stats import multivariate_normal

from pde_tpu.models import multi_asset as jm
from pde_tpu_torch import interop
from pde_tpu_torch.models import black_scholes as tbs
from pde_tpu_torch.models import multi_asset as tm

MKT = dict(rate=0.03, div1=0.01, div2=0.02)
F32_ULP = float(np.finfo(np.float32).eps)


def _t(x):
    return interop.tensor(x)


@pytest.fixture(scope="module")
def quotes():
    """A 64-quote book over strike and correlation (bench_full.py:322-347,
    scaled down)."""
    ks = np.linspace(-15.0, 25.0, 64)
    rho = np.tile(np.linspace(-0.5, 0.9, 8), 8)
    return ks, rho


def test_bivariate_cdf_matches_reference_and_scipy(rng):
    h, k = rng.normal(size=25) * 1.5, rng.normal(size=25) * 1.5
    rho = rng.uniform(-0.95, 0.95, 25)
    got = tm.bivariate_norm_cdf(_t(h), _t(k), _t(rho)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.bivariate_norm_cdf(h, k, rho)), atol=1e-14)
    exact = [multivariate_normal(mean=[0.0, 0.0], cov=[[1.0, r], [r, 1.0]]).cdf([a, b])
             for a, b, r in zip(h, k, rho)]
    np.testing.assert_allclose(got, exact, atol=1e-7)
    # broadcasting: a scalar rho against vectors, and the clip at |rho| -> 1
    np.testing.assert_allclose(tm.bivariate_norm_cdf(_t(h), _t(k), 1.0).numpy(),
                               np.asarray(jm.bivariate_norm_cdf(h, k, 1.0)), atol=1e-12)


def test_log_basket_moments_and_geometric_basket_match_reference():
    spots, w = np.array([100.0, 90.0, 110.0]), np.array([0.5, 0.3, 0.2])
    vols = np.array([0.2, 0.3, 0.25])
    corr = np.array([[1.0, 0.5, 0.2], [0.5, 1.0, 0.3], [0.2, 0.3, 1.0]])
    for a, b in zip(tm._log_basket_moments(_t(spots), _t(w), _t(vols), _t(corr), 0.03,
                                           _t([0.01, 0.0, 0.02]), 1.5),
                    jm._log_basket_moments(spots, w, vols, corr, 0.03,
                                           np.array([0.01, 0.0, 0.02]), 1.5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14)
    K = np.linspace(80.0, 120.0, 9)
    for is_call in (True, False):
        np.testing.assert_allclose(
            tm.geometric_basket_price(_t(spots), _t(w), _t(K), 1.5, _t(vols), _t(corr), 0.03,
                                      0.01, is_call).numpy(),
            np.asarray(jm.geometric_basket_price(spots, w, K, 1.5, vols, corr, 0.03, 0.01,
                                                 is_call)), atol=1e-8, rtol=0)


def test_margrabe_and_kirk_match_reference(quotes):
    ks, rho = quotes
    np.testing.assert_allclose(
        tm.margrabe_price(100.0, 96.0, 0.9, 0.25, 0.35, _t(rho), **MKT).numpy(),
        np.asarray(jm.margrabe_price(100.0, 96.0, 0.9, 0.25, 0.35, rho, **MKT)), atol=1e-8)
    for is_call in (True, False):
        np.testing.assert_allclose(
            tm.kirk_spread_price(100.0, 96.0, _t(ks), 0.9, 0.25, 0.35, _t(rho), **MKT,
                                 is_call=is_call).numpy(),
            np.asarray(jm.kirk_spread_price(100.0, 96.0, ks, 0.9, 0.25, 0.35, rho, **MKT,
                                            is_call=is_call)), atol=1e-8)
    # Kirk is exact at K = 0, where it is Margrabe
    np.testing.assert_allclose(
        tm.kirk_spread_price(100.0, 96.0, 0.0, 0.9, 0.25, 0.35, _t(rho), **MKT).numpy(),
        tm.margrabe_price(100.0, 96.0, 0.9, 0.25, 0.35, _t(rho), **MKT).numpy(), atol=1e-10)


@pytest.mark.parametrize("is_call", [True, False])
def test_spread_quad_book_in_one_call_matches_reference_vmap(quotes, is_call):
    ks, rho = quotes
    ref = jax.vmap(lambda k, r: jm.spread_price_quad(100.0, 96.0, k, 0.9, 0.25, 0.35, r,
                                                     **MKT, is_call=is_call))(ks, rho)
    got = tm.spread_price_quad(100.0, 96.0, _t(ks), 0.9, 0.25, 0.35, _t(rho), **MKT,
                               is_call=is_call)
    assert tuple(got.shape) == (64,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-8, rtol=0)
    # the quadrature bounds Kirk's error (the reference's use of it)
    kirk = tm.kirk_spread_price(100.0, 96.0, _t(ks), 0.9, 0.25, 0.35, _t(rho), **MKT,
                                is_call=is_call)
    assert float((kirk - got).abs().max()) < 0.5


@pytest.mark.parametrize("kind", ["call_on_max", "call_on_min", "put_on_max", "put_on_min"])
def test_rainbow_book_in_one_call_matches_reference_vmap(quotes, kind):
    ks, rho = quotes
    strikes = np.abs(ks) + 80.0
    ref = jax.vmap(lambda k, r: jm.rainbow_two_asset_price(100.0, 96.0, k, 0.9, 0.25, 0.35, r,
                                                           **MKT, kind=kind))(strikes, rho)
    got = tm.rainbow_two_asset_price(100.0, 96.0, _t(strikes), 0.9, 0.25, 0.35, _t(rho),
                                     **MKT, kind=kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-8, rtol=0)


def test_rainbow_identity_and_kind_check(quotes):
    ks, rho = quotes
    K = _t(np.abs(ks) + 80.0)
    args = (100.0, 96.0, K, 0.9, 0.25, 0.35, _t(rho))
    cmax = tm.rainbow_two_asset_price(*args, **MKT, kind="call_on_max")
    cmin = tm.rainbow_two_asset_price(*args, **MKT, kind="call_on_min")
    c1 = tbs.price(_t(100.0), K, 0.03, 0.01, 0.9, 0.25)
    c2 = tbs.price(_t(96.0), K, 0.03, 0.02, 0.9, 0.35)
    np.testing.assert_allclose((cmax + cmin).numpy(), (c1 + c2).numpy(), atol=1e-12)
    with pytest.raises(ValueError, match="rainbow kind"):
        tm.rainbow_two_asset_price(*args, kind="straddle")


def test_implied_correlation_at_the_float32_bracket(quotes):
    ks, rho = quotes
    target = np.asarray(jm.kirk_spread_price(100.0, 96.0, ks, 0.9, 0.25, 0.35, rho, **MKT))
    ref = jax.vmap(lambda p, k: jm.implied_correlation(p, 100.0, 96.0, k, 0.9, 0.25, 0.35,
                                                       **MKT))(target, ks)
    got = tm.implied_correlation(_t(target), 100.0, 96.0, _t(ks), 0.9, 0.25, 0.35, **MKT)
    assert got.dtype == torch.float32 and np.asarray(ref).dtype == np.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2 * F32_ULP, rtol=0)
    # and it recovers the quoting correlation to the bracket's resolution
    np.testing.assert_allclose(got.numpy(), rho, atol=4 * F32_ULP)

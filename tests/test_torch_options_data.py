"""The port's options data stack held against ``pde_tpu/data/options.py``
under x64, on chains built in the test (no market data is fetched).

Gates: implied vols 1e-8 (both packages run the same masked Newton, to
1e-8 on the price); Greeks 1e-12; SVI parameters 1e-6 (both run their
package's bounded LM to its tolerance); the surface's splines and
analytics are scipy on the host and equal given the IVs.
"""

from datetime import date, timedelta

import jax.numpy as jnp
import numpy as np
import pytest

from pde_tpu.data import options as jo
from pde_tpu.models import black_scholes as jbs
from pde_tpu_torch.data import options as to

CPU = dict(device="cpu")
AS_OF = date(2026, 1, 5)


def _smile_vol(k, T):
    """A skewed smile in strike, flattening with maturity."""
    m = np.log(k / 100.0)
    return 0.2 - 0.1 * m / np.sqrt(T) + 0.3 * m**2


def _chain(expiries=(45, 120, 300), strikes=np.linspace(70.0, 130.0, 13), r=0.05, q=0.01):
    """Call and put quotes around Black-Scholes mids of a known smile."""
    quotes = []
    for days in expiries:
        exp = AS_OF + timedelta(days=days)
        T = days / 365.0
        vols = _smile_vol(strikes, T)
        for is_call, kind in ((True, "call"), (False, "put")):
            mids = np.asarray(jbs.price(100.0, jnp.asarray(strikes), r, q, T,
                                        jnp.asarray(vols), is_call))
            quotes += [jo.OptionQuote(strike=float(k), expiration=exp, option_type=kind,
                                      bid=float(m) * 0.999, ask=float(m) * 1.001, volume=10)
                       for k, m in zip(strikes, mids)]
    return quotes


def _as_port(quotes):
    return [to.OptionQuote(**q.__dict__) for q in quotes]


def test_iv_chain_matches_the_reference():
    strikes = np.linspace(60.0, 140.0, 33)
    times = np.linspace(0.1, 2.0, 33)
    vols = _smile_vol(strikes, times)
    calls = strikes >= 100.0
    prices = np.array(jbs.price(100.0, jnp.asarray(strikes), 0.05, 0.0, jnp.asarray(times),
                                  jnp.asarray(vols), jnp.asarray(calls)))
    got = to.ImpliedVolatilityCalculator(0.05, **CPU).calculate_chain(
        prices, 100.0, strikes, times, calls)
    want = jo.ImpliedVolatilityCalculator(0.05).calculate_chain(
        prices, 100.0, strikes, times, calls)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-8)
    np.testing.assert_allclose(got, vols, atol=1e-6)
    one = to.ImpliedVolatilityCalculator(0.05, **CPU).calculate(
        prices[3], 100.0, strikes[3], times[3], bool(calls[3]))
    assert abs(one - jo.ImpliedVolatilityCalculator(0.05).calculate(
        prices[3], 100.0, strikes[3], times[3], bool(calls[3]))) <= 1e-8


def test_greeks_match_the_reference():
    strikes = np.linspace(80.0, 120.0, 9)
    times, vols = np.full(9, 0.5), np.full(9, 0.25)
    calls = np.arange(9) % 2 == 0
    got = to.GreeksCalculator(0.03, 0.01, **CPU).calculate(100.0, strikes, times, vols, calls)
    want = jo.GreeksCalculator(0.03, 0.01).calculate(100.0, strikes, times, vols, calls)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-14)


def test_surface_build_and_analytics_match_the_reference():
    quotes = _chain()
    got = to.OptionsChainProcessor(0.05, 0.01, **CPU).build_surface(_as_port(quotes), 100.0,
                                                                      as_of=AS_OF)
    want = jo.OptionsChainProcessor(0.05, 0.01).build_surface(quotes, 100.0, as_of=AS_OF)
    assert len(got.points) == len(want.points) == len(quotes)
    np.testing.assert_allclose([p.implied_vol for p in got.points],
                               [p.implied_vol for p in want.points], rtol=0.0, atol=1e-8)
    for exp in sorted({q.expiration for q in quotes}):
        assert abs(got.get_atm_vol(exp) - want.get_atm_vol(exp)) <= 1e-8
        assert abs(got.get_skew(exp) - want.get_skew(exp)) <= 1e-8
        assert got.get_skew(exp) > 0  # put wing above call wing
    assert got.to_records()[0].keys() == want.to_records()[0].keys()
    assert list(got.get_term_structure()) == list(want.get_term_structure())


def test_surface_filters_quotes_as_the_reference():
    quotes = _chain(expiries=(60,))
    quotes[0].volume = 0
    quotes[1].bid, quotes[1].ask = 1.0, 3.0  # a 100% spread
    quotes[2].bid = quotes[2].ask = quotes[2].last = 0.0
    kw = dict(spot_price=100.0, as_of=AS_OF, min_volume=1, max_spread_pct=0.5)
    got = to.OptionsChainProcessor(**CPU).build_surface(_as_port(quotes), **kw)
    want = jo.OptionsChainProcessor().build_surface(quotes, **kw)
    assert [(p.strike, p.option_type) for p in got.points] == [
        (p.strike, p.option_type) for p in want.points]
    assert len(got.points) == len(quotes) - 3
    empty = to.OptionsChainProcessor(**CPU).build_surface([], 100.0, as_of=AS_OF)
    assert empty.points == [] and empty.get_vol(100.0, AS_OF) is None


SVI_TRUE = [dict(a=0.02, b=0.15, rho=-0.4, m=0.0, sigma=0.2),
            dict(a=0.05, b=0.3, rho=-0.7, m=0.05, sigma=0.1),
            dict(a=0.001, b=0.08, rho=0.2, m=-0.1, sigma=0.4)]


@pytest.mark.parametrize("case", range(len(SVI_TRUE)))
def test_svi_fit_matches_the_reference(case):
    t = SVI_TRUE[case]
    k = np.linspace(-0.4, 0.4, 15)
    w = t["a"] + t["b"] * (t["rho"] * (k - t["m"]) + np.sqrt((k - t["m"]) ** 2 + t["sigma"] ** 2))
    w = w + np.random.default_rng(case).normal(0.0, 2e-4, k.size)  # not an exact fit
    svi = to.SVIParameterization(**CPU)
    got = svi.fit(k, w, time_to_expiry=0.5)
    want = jo.SVIParameterization().fit(k, w, time_to_expiry=0.5)
    for name in ("a", "b", "rho", "m", "sigma"):
        assert abs(got[name] - want[name]) <= 1e-6, name
    fitted = np.array([svi.get_total_variance(ki) for ki in k])
    np.testing.assert_allclose(fitted, w, atol=1e-3)
    assert svi.get_implied_vol(0.0) == pytest.approx(np.sqrt(svi.get_total_variance(0.0) / 0.5))


def test_svi_smile_of_a_surface_matches_the_reference():
    quotes = _chain(expiries=(90,), strikes=np.linspace(75.0, 125.0, 11))
    exp = quotes[0].expiration
    tp, jp = to.OptionsChainProcessor(0.05, 0.01, **CPU), jo.OptionsChainProcessor(0.05, 0.01)
    got = tp.fit_svi_smile(tp.build_surface(_as_port(quotes), 100.0, as_of=AS_OF), exp)
    want = jp.fit_svi_smile(jp.build_surface(quotes, 100.0, as_of=AS_OF), exp)
    for name, v in want.params.items():
        assert abs(got.params[name] - v) <= 1e-6, name
    assert tp.fit_svi_smile(tp.build_surface(_as_port(quotes[:4]), 100.0, as_of=AS_OF),
                            exp) is None


def test_svi_requires_fit():
    with pytest.raises(ValueError):
        to.SVIParameterization(**CPU).get_total_variance(0.0)
    with pytest.raises(ValueError):
        to.SVIParameterization(**CPU).get_implied_vol(0.0)

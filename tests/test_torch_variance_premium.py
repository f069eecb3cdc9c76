"""The port's variance-risk-premium signal and simulated data provider
against ``pde_tpu``.

Mirrors ``tests/test_variance_premium.py`` and the provider cases of
``tests/test_data.py``.  Both packages evaluate the same OTM chains
(priced once by the reference's ``price_accurate`` under x64) and return
series; the port runs on the CPU in float64.  Gates: the same signal or
none, the same type; implied and expected variance, VRP and confidence
within 1e-10 relative (the strip is one weighted sum in another order; the
EWMA forecast one weighted sum, ``tests/test_torch_position_sizer.py``).
The simulated bars are the reference's numpy arithmetic and are equal;
the options chain's mids within 1e-12 (``black_scholes.price`` in float64).
"""

from dataclasses import asdict
from datetime import date

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_tpu.data import providers as ref_prov
from pde_tpu.models import heston
from pde_tpu.models.heston import HestonParams as RefParams
from pde_tpu.signals import variance_premium as ref_vrp
from pde_tpu_torch.data import providers as prov
from pde_tpu_torch.models.heston import HestonParams
from pde_tpu_torch.signals.variance_premium import (
    VariancePremiumConfig,
    VariancePremiumSignal,
    VariancePremiumStrategy,
    VarianceSignalType,
)

S0, R, Q, T = 100.0, 0.03, 0.0, 0.25
F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)
HIGH_VOL = (2.0, 0.09, 0.3, -0.6, 0.09)   # ~30-vol surface
LOW_VOL = (2.0, 0.022, 0.2, -0.6, 0.022)  # ~15-vol surface
FIELDS = ("implied_variance", "expected_variance", "vrp", "confidence", "implied_vol",
          "expected_vol")


def _chain(params, n=400, k_lo=0.4, k_hi=2.5):
    F = S0 * np.exp((R - Q) * T)
    K = np.linspace(k_lo * F, k_hi * F, n)
    prices = np.asarray(heston.price_accurate(
        RefParams(*params), jnp.asarray(K), T, S0, R, Q, is_call=jnp.asarray(K > F)))
    return K, prices, F


def _returns(ann_vol, n=500, seed=0):
    return ann_vol / np.sqrt(252.0) * np.random.default_rng(seed).standard_normal(n)


def _port_params(params):
    return HestonParams(*(torch.tensor(v, dtype=F64) for v in params))


def _both(chain, config=None, **forecast):
    """The reference's and the port's signal on one chain; ``forecast``
    names ``returns`` or ``params`` (the model's parameters)."""
    K, P, F = chain
    params = forecast.pop("params", None)
    ref = ref_vrp.VariancePremiumStrategy(config).evaluate_chain(
        "SPX", K, P, F, T, R, model_params=None if params is None else RefParams(*params),
        **forecast)
    port = VariancePremiumStrategy(config, **CPU).evaluate_chain(
        "SPX", K, P, F, T, R, model_params=None if params is None else _port_params(params),
        **forecast)
    if ref is None:
        assert port is None
    else:
        assert port.signal_type.value == ref.signal_type.value
        for k in FIELDS:
            np.testing.assert_allclose(getattr(port, k), getattr(ref, k), rtol=1e-10, err_msg=k)
    return port


@pytest.fixture(scope="module")
def high():
    return _chain(HIGH_VOL)


@pytest.fixture(scope="module")
def low():
    return _chain(LOW_VOL)


class TestVRPSignal:
    def test_rich_implied_sells_variance(self, high):
        sig = _both(high, returns=_returns(0.18))
        assert sig is not None and sig.signal_type == VarianceSignalType.SELL_VARIANCE
        assert sig.vrp > 0.015 and 0.0 < sig.confidence <= 1.0
        assert abs(sig.implied_vol - 0.30) < 0.03

    def test_cheap_implied_buys_variance(self, low):
        sig = _both(low, returns=_returns(0.25, seed=3))
        assert sig is not None and sig.signal_type == VarianceSignalType.BUY_VARIANCE
        assert sig.vrp < -0.005

    def test_neutral_zone_is_silent(self, high):
        assert _both(high, returns=_returns(0.295, seed=5)) is None

    def test_model_forecast_path(self, high):
        assert _both(high, params=HIGH_VOL) is None
        sig = _both(high, params=LOW_VOL)
        assert sig is not None and sig.signal_type == VarianceSignalType.SELL_VARIANCE

    @pytest.mark.parametrize("n, k_lo, k_hi", [(5, 0.4, 2.5), (50, 0.85, 1.15)])
    def test_thin_or_narrow_chains_filtered(self, n, k_lo, k_hi):
        assert _both(_chain(HIGH_VOL, n=n, k_lo=k_lo, k_hi=k_hi), returns=_returns(0.18)) is None

    def test_surface_and_serialization(self, high):
        K, P, F = high
        chains = [dict(strike=K, otm_price=P, forward=F, maturity=T, rate=R)]
        sigs = VariancePremiumStrategy(**CPU).evaluate_surface("SPX", chains,
                                                               returns=_returns(0.18))
        ref = ref_vrp.VariancePremiumStrategy().evaluate_surface("SPX", chains,
                                                                 returns=_returns(0.18))
        assert len(sigs) == len(ref) == 1
        d, e = sigs[0].to_dict(), ref[0].to_dict()
        assert d["signal_type"] == "sell_variance" and set(d) == set(e)
        assert d["rationale"] == e["rationale"]
        assert isinstance(sigs[0], VariancePremiumSignal)

    def test_wider_dislocation_raises_confidence(self, high):
        cfg = VariancePremiumConfig()
        weak = _both(high, cfg, returns=_returns(0.22, seed=7))
        strong = _both(high, cfg, returns=_returns(0.12, seed=7))
        assert weak is not None and strong is not None
        assert strong.confidence > weak.confidence

    def test_expected_variance_needs_a_forecast(self):
        with pytest.raises(ValueError, match="need returns or model_params"):
            VariancePremiumStrategy(**CPU).expected_variance()


class TestProviders:
    def test_simulated_provider(self):
        a = ref_prov.SimulatedDataProvider(seed=1)
        b = prov.SimulatedDataProvider(seed=1, **CPU)
        start, end = date(2025, 1, 1), date(2025, 3, 1)
        ref_bars, bars = a.get_bars("SPY", start, end), b.get_bars("SPY", start, end)
        assert len(bars) == 59 and list(map(asdict, bars)) == list(map(asdict, ref_bars))
        assert all(x.high >= max(x.open, x.close) for x in bars)
        q, rq = b.get_quote("SPY"), a.get_quote("SPY")
        assert q.bid < q.ask and (q.bid, q.ask, q.last) == (rq.bid, rq.ask, rq.last)
        chain, ref_chain = b.get_options_chain("SPY"), a.get_options_chain("SPY")
        assert len(chain) == 18 and {c["option_type"] for c in chain} == {"call", "put"}
        for got, want in zip(chain, ref_chain, strict=True):
            for k in want:
                if isinstance(want[k], float):
                    np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)
                else:
                    assert got[k] == want[k], k

    def test_deterministic(self):
        span = (date(2025, 1, 1), date(2025, 2, 1))
        a = prov.SimulatedDataProvider(seed=7).get_bars("X", *span)
        b = prov.SimulatedDataProvider(seed=7).get_bars("X", *span)
        assert [x.close for x in a] == [x.close for x in b]

    def test_rate_limiter(self):
        rl = prov.RateLimiter(rate=2, period=0.2)
        assert rl.acquire() and rl.acquire()
        assert not rl.acquire(timeout=0.01)  # bucket exhausted
        assert rl.acquire(timeout=1.0)  # refills

    def test_factory(self):
        assert isinstance(prov.create_provider("simulated"), prov.SimulatedDataProvider)
        assert prov.create_provider("yahoo").name == "yahoo"
        with pytest.raises(ValueError):
            prov.create_provider("nope")

    def test_chain_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prov.SimulatedDataProvider(seed=1).get_options_chain("SPY")

"""The port's vol-surface arbitrage signal held against ``pde_tpu``.

The same chains go through both packages in float64 (the JAX side under
``jax_enable_x64``), with duck-typed calibration results (a params tuple
and an rmse) in place of calibrations.  Gates: the model IVs at 1e-8
absolute (the converged Heston and rough pricers and the Hagan formula
against the reference's, then the same Newton inversion); the signal
lists exactly: the same rows in the same order, the same BUY/SELL and
rationale strings, confidence at 1e-12, for each of the rough, SABR and
Heston branches.
"""

import types

import numpy as np
import pytest
import torch

from pde_tpu.models.heston import HestonParams as JHeston
from pde_tpu.models.rough_heston import RoughHestonParams as JRough
from pde_tpu.models.sabr import SABRParams as JSABR
from pde_tpu.signals import vol_arbitrage as jva
from pde_tpu_torch.models import heston
from pde_tpu_torch.models.heston import HestonParams as THeston
from pde_tpu_torch.models.rough_heston import RoughHestonParams as TRough
from pde_tpu_torch.models.sabr import SABRParams as TSABR
from pde_tpu_torch.signals import vol_arbitrage as tva

CPU = dict(device="cpu", dtype=torch.float64)
S0, R, Q = 100.0, 0.05, 0.02
HESTON = (2.0, 0.04, 0.3, -0.7, 0.04)
ROUGH = (0.15, 2.0, 0.04, 0.3, -0.7, 0.04)
SABR = {0.1: (0.25, 0.5, -0.3, 0.5), 0.5: (0.22, 0.5, -0.35, 0.45)}


def _result(pkg, branch, rmse=None):
    """A duck-typed calibration result of ``branch`` for ``pkg`` (jax|torch)."""
    j = pkg == "jax"
    if branch == "heston":
        return types.SimpleNamespace(params=(JHeston if j else THeston)(*HESTON),
                                     rmse=0.01 if rmse is None else rmse)
    if branch == "rough":
        return types.SimpleNamespace(params=(JRough if j else TRough)(*ROUGH),
                                     rmse=0.005 if rmse is None else rmse)
    cls = JSABR if j else TSABR
    return types.SimpleNamespace(params_by_maturity={t: cls(*p) for t, p in SABR.items()},
                                 total_rmse=0.004 if rmse is None else rmse)


def _generators(branch, **kw):
    sabr = branch == "sabr"
    return (jva.VolSurfaceArbitrageSignal(use_sabr=sabr, **kw),
            tva.VolSurfaceArbitrageSignal(use_sabr=sabr, **kw, **CPU))


def _chain(market_iv, T=60 / 365, **extra):
    n = len(market_iv)
    return {"underlying": ["TEST"] * n, "strike": np.linspace(90, 110, n),
            "T": np.broadcast_to(T, n).astype(float), "implied_vol": np.asarray(market_iv),
            "option_type": ["call"] * n, **extra}


def _rich_chain(branch):
    """Three maturities, calls and puts, quotes and volumes; market vols set
    10-45% off the branch's own model smile, both ways, and a few rows
    outside the filters."""
    n = 12
    T = np.repeat([20 / 365, 60 / 365, 0.3], 4)
    strikes = np.linspace(85.0, 115.0, n)
    is_call = np.arange(n) % 2 == 0
    gen = tva.VolSurfaceArbitrageSignal(use_sabr=branch == "sabr", **CPU)
    model = gen._model_iv_vector(strikes, T, is_call, S0, R, Q,
                                 *(_result("torch", b) if b == branch else None
                                   for b in ("heston", "sabr", "rough")))
    factor = np.array([0.75, 1.3, 0.88, 1.12, 0.6, 1.45, 0.8, 1.2, 0.9, 1.35, 0.7, 1.02])
    bid = np.array([5.0, 5.0, 4.0, 5.0, 0.0, 5.0, 5.0, 5.0, 5.0, 3.0, 5.0, 5.0])
    ask = np.array([5.2, 5.1, 6.0, 5.3, 0.5, 5.2, 5.4, 5.1, 5.2, 3.2, 5.2, 5.2])
    volume = np.array([500, 500, 500, 50, 500, 500, 500, 500, 500, 500, 500, 500])
    return {"underlying": ["TEST"] * n, "strike": strikes, "T": T,
            "implied_vol": model * factor,
            "option_type": np.where(is_call, "call", "put").tolist(),
            "bid": bid, "ask": ask, "volume": volume}


def _same_signals(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.underlying, g.strike, g.option_type, g.signal_type.value, g.rationale,
                g.bid, g.ask) == (w.underlying, w.strike, w.option_type, w.signal_type.value,
                                  w.rationale, w.bid, w.ask)
        np.testing.assert_allclose(g.confidence, w.confidence, rtol=0, atol=1e-12)
        np.testing.assert_allclose(g.model_iv, w.model_iv, rtol=0, atol=1e-8)
        np.testing.assert_allclose(g.divergence_pct, w.divergence_pct, rtol=0, atol=1e-7)
        assert g.market_iv == w.market_iv


@pytest.mark.parametrize("branch", ["heston", "sabr", "rough"])
def test_signals_match_the_reference(branch):
    chain = _rich_chain(branch)
    jgen, tgen = _generators(branch)
    key = f"{branch}_result"
    want = jgen.generate_signals(chain, S0, R, Q, **{key: _result("jax", branch)})
    got = tgen.generate_signals(chain, S0, R, Q, **{key: _result("torch", branch)})
    assert 3 <= len(want) < len(chain["strike"])
    assert {s.signal_type for s in want} == {tva.SignalType.BUY, tva.SignalType.SELL}
    _same_signals(got, want)
    assert tgen.filter_signals(got, top_n=2)[0].confidence == max(s.confidence for s in got)


@pytest.mark.parametrize("branch", ["heston", "sabr", "rough"])
def test_model_ivs_match_the_reference(branch):
    chain = _rich_chain(branch)
    args = (chain["strike"], chain["T"], np.arange(12) % 2 == 0, S0, R, Q)
    jgen, tgen = _generators(branch)
    want = jgen._model_iv_vector(*args, *(_result("jax", b) if b == branch else None
                                          for b in ("heston", "sabr", "rough")))
    got = tgen._model_iv_vector(*args, *(_result("torch", b) if b == branch else None
                                         for b in ("heston", "sabr", "rough")))
    assert got.dtype == np.float64 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_float32_model_ivs_stay_near_float64():
    """The card's default precision: float32 IVs within 1e-4 of float64.
    Float32 prices carry ~1e-5 of rounding, and the deep in-the-money
    20-day call (K 85) has a Black-Scholes vega of ~0.14."""
    chain = _rich_chain("heston")
    args = (chain["strike"], chain["T"], np.ones(12, bool), S0, R, Q, _result("torch", "heston"),
            None)
    f64 = tva.VolSurfaceArbitrageSignal(**CPU)._model_iv_vector(*args)
    f32 = tva.VolSurfaceArbitrageSignal(device="cpu", dtype=torch.float32)._model_iv_vector(*args)
    np.testing.assert_allclose(f32, f64, rtol=0, atol=1e-4)


# --- the reference's TestVolArbitrage on the port, each against pde_tpu ---

CHAINS = {
    "cheap": lambda: _chain([0.13] * 5),
    "rich": lambda: _chain([0.26] * 5),
    "extreme": lambda: _chain([0.05] * 5),
    "short_dated": lambda: _chain([0.13] * 5, T=2 / 365),
    "volume_spread": lambda: _chain([0.13] * 4, volume=np.array([500, 10, 500, 500]),
                                    bid=np.array([5.0, 5.0, 5.0, 4.0]),
                                    ask=np.array([5.1, 5.1, 5.1, 6.0])),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_reference_chains(name):
    chain = CHAINS[name]()
    jgen, tgen = _generators("heston")
    want = jgen.generate_signals(chain, S0, R, Q, heston_result=_result("jax", "heston"))
    got = tgen.generate_signals(chain, S0, R, Q, heston_result=_result("torch", "heston"))
    _same_signals(got, want)
    types_ = {s.signal_type for s in got}
    if name == "cheap":
        assert got and types_ == {tva.SignalType.BUY}
        assert all(s.divergence_pct > 0.10 for s in got)
    elif name == "rich":
        assert got and types_ == {tva.SignalType.SELL}
    elif name in ("extreme", "short_dated"):
        assert got == []
    else:
        k = np.linspace(90, 110, 4)
        assert k[1] not in {s.strike for s in got} and k[3] not in {s.strike for s in got}


def test_no_signal_within_threshold():
    """Market priced exactly at the model smile -> zero divergence."""
    tgen = tva.VolSurfaceArbitrageSignal(use_sabr=False, **CPU)
    smile = heston.implied_volatility(THeston(*HESTON), torch.linspace(90, 110, 5,
                                                                       dtype=torch.float64),
                                      torch.full((5,), 60 / 365, dtype=torch.float64),
                                      S0, R, Q, accurate=True).numpy()
    assert tgen.generate_signals(_chain(smile), S0, R, Q,
                                 heston_result=_result("torch", "heston")) == []


def test_requires_a_model():
    with pytest.raises(ValueError):
        tva.VolSurfaceArbitrageSignal(**CPU).generate_signals(_chain([0.2]), S0, R, Q)


def test_filter_signals_orders_by_confidence():
    def mk(c):
        return tva.VolArbitrageSignal(
            underlying="X", strike=100.0, expiration=None, option_type="call",
            signal_type=tva.SignalType.BUY, confidence=c, model_iv=0.2, market_iv=0.15,
            divergence_pct=0.3, rationale="")
    out = tva.VolSurfaceArbitrageSignal(**CPU).filter_signals([mk(0.6), mk(0.9), mk(0.7)], top_n=2)
    assert [s.confidence for s in out] == [0.9, 0.7]
    assert set(mk(0.5).to_dict()) == set(jva.VolArbitrageSignal(
        underlying="X", strike=100.0, expiration=None, option_type="call",
        signal_type=jva.SignalType.BUY, confidence=0.5, model_iv=0.2, market_iv=0.15,
        divergence_pct=0.3, rationale="").to_dict())
    assert tva.VolArbitrageConfig() == tva.VolArbitrageConfig(**vars(jva.VolArbitrageConfig()))


# --- the reference's TestVolArbitrageRough on the port --------------------

def test_rough_model_wins_when_supplied():
    signals = tva.VolSurfaceArbitrageSignal(use_sabr=False, **CPU).generate_signals(
        _chain([0.13] * 5), S0, R, Q, rough_result=_result("torch", "rough"))
    assert signals and all(s.signal_type == tva.SignalType.BUY for s in signals)


@pytest.mark.parametrize("use_rough", [True, False])
def test_rough_iv_against_heston_iv_short_maturity(use_rough):
    """At T = 0.05 the rough (H = 0.15) IVs differ from classic Heston's;
    with ``use_rough=False`` the rough result is ignored."""
    gen = tva.VolSurfaceArbitrageSignal(use_sabr=False, use_rough=use_rough, **CPU)
    args = (np.linspace(90, 110, 5), np.full(5, 0.05), np.ones(5, bool), S0, R, Q,
            _result("torch", "heston"), None)
    iv_heston = gen._model_iv_vector(*args)
    iv_rough = gen._model_iv_vector(*args, _result("torch", "rough"))
    assert np.all(np.isfinite(iv_rough))
    if use_rough:
        assert np.max(np.abs(iv_rough - iv_heston)) > 0.003
    else:
        np.testing.assert_allclose(iv_rough, iv_heston, rtol=0, atol=0)

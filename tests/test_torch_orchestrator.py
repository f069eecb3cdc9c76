"""``pde_tpu_torch.calibrate.orchestrator`` held against the JAX package.

Both orchestrators run in float64 on the same numpy quotes, stage by stage:

- the rates, G2++ and credit desks of the JAX suite
  (``tests/test_calibrate.py::TestOrchestratorRatesCredit``): the same
  statuses, persistence keys and warm caches, the Hull-White and G2
  parameters at 1e-6 and the hazards at 1e-10.  The G2 desk prices at 32
  Gauss-Hermite nodes (quotes and fit alike) to keep the CPU run short;
- the daily Heston + SABR + OU run: SUCCESS in both, the Heston fits
  converged to the same parameters (1e-6; the DE draws differ, Philox
  against threefry), the BS-inverted SABR table, each maturity's SABR fit
  (a deterministic LM) at 1e-6, the OU fit at 1e-8, and the warm caches;
- the quote helpers (``_filter_options``, ``_quote_arrays``,
  ``_to_sabr_input``) on dict and DataFrame chains with puts, and the
  Heston warm start and quality gate over a sequence of runs;
- the rough and Bates refinements, each seeded from one fixed classic fit
  (a recording stand-in for the Heston stage, so both packages start from
  the same point): the rough fit (deterministic LM) at 1e-6, the Bates fit
  converged to the same parameters, and a failing refinement degrading
  the run to PARTIAL in both.

The reference's checks of the daily run (the option-count gate, the
liquidity filter, the concurrent ``run_all``, a failed gate degrading to
PARTIAL) are kept.
"""

import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from pde_tpu.calibrate import orchestrator as jorch
from pde_tpu.calibrate.bates import BatesCalibrator as JBates
from pde_tpu.calibrate.g2 import G2Calibrator as JG2
from pde_tpu.calibrate.heston import HestonCalibrator as JHeston
from pde_tpu.calibrate.ou import OUFitter as JOU
from pde_tpu.calibrate.rates import HullWhiteCalibrator as JHW
from pde_tpu.calibrate.rough import RoughHestonCalibrator as JRough
from pde_tpu.models import black_scholes as jbs
from pde_tpu.models import g2 as jg2
from pde_tpu.models import heston as jheston
from pde_tpu.models import rates as jr
from pde_tpu_torch import interop
from pde_tpu_torch.calibrate.bates import BatesCalibrator
from pde_tpu_torch.calibrate.g2 import G2Calibrator
from pde_tpu_torch.calibrate.heston import HestonCalibrator
from pde_tpu_torch.calibrate.orchestrator import (CalibrationConfig, CalibrationOrchestrator,
                                                  CalibrationStatus)
from pde_tpu_torch.calibrate.rates import HullWhiteCalibrator
from pde_tpu_torch.calibrate.rough import RoughHestonCalibrator
from pde_tpu_torch.models import heston as theston

CPU64 = dict(device="cpu", dtype=torch.float64)
N_GH = 32
STAGES = dict(calibrate_heston=False, calibrate_sabr=False, calibrate_rates=True,
              calibrate_g2=True, calibrate_credit=True)


class _RecordingDB:
    """Minimal parameter-store fake: records store calls, serves none."""

    def __init__(self):
        self.stored = []

    def store_model_parameters(self, **kw):
        self.stored.append(kw)

    def get_latest_model_parameters(self, **kw):
        return None


@pytest.fixture(scope="module")
def desks():
    """The JAX suite's desks, as numpy quotes both packages take."""
    curve = jr.curve_from_zero_rates(jnp.asarray([0.5, 1.0, 2.0, 5.0, 10.0, 30.0]),
                                     jnp.asarray([0.030, 0.032, 0.035, 0.040, 0.042, 0.043]))
    hw_true = jr.HullWhiteParams(jnp.asarray(0.12), jnp.asarray(0.011), curve)
    starts = np.arange(0.5, 5.01, 0.5)
    ends = starts + 0.5
    ks = np.asarray(curve.forward(starts, ends))
    caplets = dict(starts=starts, ends=ends, strikes=ks,
                   quotes=np.asarray(jr.hw_caplet(hw_true, ks, starts, ends)))
    g2_true = jg2.G2Params(*map(jnp.asarray, (0.5, 0.05, 0.011, 0.0085, -0.55)), curve)
    exps = [1.0, 2.0, 3.0, 5.0]
    pts = [np.arange(e + 0.5, e + 3.01, 0.5) for e in exps]
    g2_ks = [float(jr.hw_swap_rate(curve, e, jnp.asarray(pt))) for e, pt in zip(exps, pts)]
    price = jax.jit(jg2.g2_swaption, static_argnames="n_gh")
    swaptions = dict(expiries=exps, pay_times=pts, strikes=g2_ks, quotes=np.array(
        [float(price(g2_true, k, e, jnp.asarray(pt), n_gh=N_GH))
         for e, pt, k in zip(exps, pts, g2_ks)]))
    credit = dict(pillars=[1.0, 3.0, 5.0, 10.0], spreads=[0.008, 0.011, 0.013, 0.015],
                  recovery=0.4)

    def markets(port):
        c = interop.discount_curve(curve) if port else curve
        return (dict(curve=c, caplets=caplets, swaptions=swaptions),
                dict(curve=c, **credit))

    return hw_true, markets


def _orch(db=None, **config):
    return CalibrationOrchestrator(
        config=CalibrationConfig(**{**STAGES, **config}), db=db,
        rates_calibrator=HullWhiteCalibrator(max_iter=40, **CPU64),
        g2_calibrator=G2Calibrator(max_iter=25, n_gh=N_GH, **CPU64), **CPU64)


def test_stages_match_the_reference_and_persist(desks):
    hw_true, markets = desks
    db = _RecordingDB()
    res = _orch(db).run_daily_calibration("USD", {"strike": []}, S0=100.0,
                                          rates_market=markets(True)[0],
                                          credit_market=markets(True)[1])
    ref = jorch.CalibrationOrchestrator(
        config=jorch.CalibrationConfig(**STAGES),
        rates_calibrator=JHW(max_iter=40), g2_calibrator=JG2(max_iter=25, n_gh=N_GH),
    ).run_daily_calibration("USD", {"strike": []}, S0=100.0, rates_market=markets(False)[0],
                            credit_market=markets(False)[1])
    assert res.status == ref.status == CalibrationStatus.SUCCESS, res.errors
    assert res.errors == []
    for port, jax_fit in ((res.rates_result, ref.rates_result), (res.g2_result, ref.g2_result)):
        np.testing.assert_allclose([float(v) for v in port.params[:-1]],
                                   [float(v) for v in jax_fit.params[:-1]], rtol=1e-6)
    np.testing.assert_allclose([float(res.rates_result.params.a),
                                float(res.rates_result.params.sigma)],
                               [float(hw_true.a), float(hw_true.sigma)], rtol=1e-3)
    assert res.g2_result.max_rel_error < 1e-4
    np.testing.assert_allclose(res.credit_result["hazards"], ref.credit_result["hazards"],
                               rtol=1e-10)
    assert res.credit_result["max_roundtrip_error"] < 1e-8
    assert np.all(res.credit_result["hazards"] > 0)
    assert res.credit_result["hazard_curve"].times.device.type == "cpu"
    assert sorted(s["model_type"] for s in db.stored) == ["cds_hazard", "g2pp", "hull_white"]
    stored = {s["model_type"]: s for s in db.stored}
    assert stored["cds_hazard"]["parameters"]["pillars"] == [1.0, 3.0, 5.0, 10.0]
    assert set(stored["g2pp"]["parameters"]) == {"a", "b", "sigma", "eta", "rho"}
    assert stored["hull_white"]["converged"] == res.rates_result.converged


def test_warm_start_feeds_the_second_run(desks):
    _, markets = desks
    orch = _orch(calibrate_g2=False)
    r1 = orch.run_daily_calibration("EUR", {"strike": []}, S0=100.0,
                                    rates_market=markets(True)[0])
    warm = orch._hw_warm["EUR"]
    r2 = orch.run_daily_calibration("EUR", {"strike": []}, S0=100.0,
                                    rates_market=markets(True)[0])
    assert r1.status == r2.status == CalibrationStatus.SUCCESS
    np.testing.assert_allclose(float(r2.rates_result.params.a), warm[0], rtol=1e-4)


def test_a_failed_gate_degrades_to_partial(desks):
    _, markets = desks
    orch = _orch(calibrate_g2=False, max_credit_roundtrip_error=0.0)
    res = orch.run_daily_calibration("JPY", {"strike": []}, S0=100.0,
                                     rates_market=markets(True)[0],
                                     credit_market=markets(True)[1])
    assert res.credit_result is not None
    assert any("credit quality gate" in e for e in res.errors)
    assert res.status == CalibrationStatus.PARTIAL


def test_a_failing_stage_is_recorded_not_raised(desks):
    _, markets = desks
    rates_market = dict(markets(True)[0])
    del rates_market["swaptions"]
    res = _orch(calibrate_credit=False).run_daily_calibration(
        "CHF", {"strike": []}, S0=100.0, rates_market=rates_market)
    assert res.status == CalibrationStatus.PARTIAL
    assert res.rates_result is not None and res.g2_result is None
    assert any(e.startswith("g2: ") for e in res.errors)


def test_float32_credit_stage_takes_the_float32_tolerance(desks):
    """The credit gate follows the curve's precision: 5e-4 in float32, and
    the float32 bootstrap meets it."""
    _, markets = desks
    orch = CalibrationOrchestrator(CalibrationConfig(calibrate_heston=False,
                                                     calibrate_sabr=False,
                                                     calibrate_credit=True),
                                   device="cpu", dtype=torch.float32)
    res = orch.run_daily_calibration("GBP", {"strike": []}, S0=100.0,
                                     credit_market=markets(True)[1])
    assert res.status == CalibrationStatus.SUCCESS, res.errors
    assert res.credit_result["hazard_curve"].survival.dtype == torch.float32
    assert 1e-8 < res.credit_result["max_roundtrip_error"] <= 5e-4


def test_run_all_concurrent_matches_sequential(desks):
    """Threads launching onto one device give the sequential results: the
    LM's forward-mode AD level and TF32 flag are per process, and the LM
    holds them one march at a time (a short switch interval makes the
    threads interleave often)."""
    _, markets = desks
    tasks = {name: dict(market_options={"strike": []}, S0=100.0,
                        rates_market=markets(True)[0], credit_market=markets(True)[1])
             for name in ("AAA", "BBB", "CCC", "DDD")}
    seq = _orch(calibrate_g2=False).run_all(tasks)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        conc = _orch(calibrate_g2=False).run_all(tasks, concurrent=True, max_workers=4)
    finally:
        sys.setswitchinterval(interval)
    assert set(seq) == set(conc) == set(tasks)
    for name in tasks:
        assert conc[name].status == seq[name].status == CalibrationStatus.SUCCESS
        assert float(conc[name].rates_result.params.a) == float(seq[name].rates_result.params.a)
        np.testing.assert_array_equal(conc[name].credit_result["hazards"],
                                      seq[name].credit_result["hazards"])


HESTON = (2.0, 0.04, 0.3, -0.7, 0.04)
OPTION_STAGES = dict(risk_free_rate=0.05, dividend_yield=0.0)


class _FixedHeston:
    """A Heston stage that returns one fixed classic fit, with the given
    rmse and r-squared on successive calls, and records what each call was
    handed (the warm start and the cache flag)."""

    def __init__(self, params, quality=((1e-9, 1.0),)):
        self.params, self.quality, self.calls = params, list(quality), []

    def calibrate(self, market_options, S0, r, q, **kw):
        self.calls.append(kw)
        rmse, r2 = self.quality[min(len(self.calls), len(self.quality)) - 1]
        return SimpleNamespace(params=self.params, rmse=rmse,
                               fit_quality={"rmse": rmse, "r_squared": r2})


def _heston_params(port):
    return theston.HestonParams(*HESTON) if port else jheston.HestonParams(*HESTON)


def _both(config, **calibrators):
    """The port's orchestrator (float64, CPU) and the reference's, on one
    configuration; ``calibrators`` maps a keyword to ``fn(port) -> calibrator``."""
    port = CalibrationOrchestrator(config=CalibrationConfig(**config),
                                   **{k: f(True) for k, f in calibrators.items()}, **CPU64)
    ref = jorch.CalibrationOrchestrator(config=jorch.CalibrationConfig(**config),
                                        **{k: f(False) for k, f in calibrators.items()})
    return port, ref


def _floats(record, names):
    return [float(getattr(record, k)) for k in names]


@pytest.fixture(scope="module")
def chain():
    """A 7 x 3 chain (q = 0.02) priced by the reference's Black-Scholes on a
    skewed smile, every other quote a put, and two quotes BS inversion
    must drop: a call worth nearly the spot and a put worth more than its
    discounted strike."""
    K, T = (a.ravel() for a in np.meshgrid(np.linspace(80.0, 120.0, 7), [0.1, 0.5, 1.0]))
    x = np.log(K / 100.0)
    vol = 0.2 - 0.1 * x + 0.3 * x * x
    is_call = np.arange(K.size) % 2 == 0
    mid = np.array(jbs.price(100.0, jnp.asarray(K), 0.05, 0.02, jnp.asarray(T),
                              jnp.asarray(vol), jnp.asarray(is_call)))
    mid[2], mid[5] = 99.0, 150.0  # the call at 93.3, the put at 113.3
    return dict(strike=K, maturity=T, mid_price=mid, is_call=is_call, vol=vol)


def _chain_as(kind, chain):
    quotes = {k: v for k, v in chain.items() if k != "vol"}
    return {
        "dict": lambda: quotes,
        "dict_calls_only": lambda: {k: v for k, v in quotes.items() if k != "is_call"},
        "dict_implied_vol": lambda: dict(quotes, implied_vol=chain["vol"]),
        "frame": lambda: pd.DataFrame(quotes),
        "frame_implied_vol": lambda: pd.DataFrame(dict(quotes, implied_vol=chain["vol"])),
    }[kind]()


@pytest.mark.parametrize("kind", ["dict", "dict_calls_only", "dict_implied_vol", "frame",
                                  "frame_implied_vol"])
def test_quote_tables_match_the_reference(chain, kind):
    """``_quote_arrays`` exactly and ``_to_sabr_input`` (BS inversion with
    each quote's own option type, then the iv filter) to 1e-10."""
    port, ref = _both(dict(calibrate_heston=False, **OPTION_STAGES))
    data = _chain_as(kind, chain)
    for got, want in zip(port._quote_arrays(data), ref._quote_arrays(data)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got = port._to_sabr_input(data, 100.0, 0.05, 0.02)
    want = ref._to_sabr_input(data, 100.0, 0.05, 0.02)
    if kind.startswith("frame_"):
        pd.testing.assert_frame_equal(got, want)
        return
    assert set(got) == set(want) == {"strike", "T", "implied_vol"}
    np.testing.assert_array_equal(got["strike"], want["strike"])
    np.testing.assert_array_equal(got["T"], want["T"])
    np.testing.assert_allclose(got["implied_vol"], want["implied_vol"], rtol=1e-10)
    if kind in ("dict", "frame"):
        # the two bad quotes are dropped, every other quote (puts included)
        # inverts to the smile that priced it
        keep = np.ones(chain["strike"].size, dtype=bool)
        keep[[2, 5]] = False
        np.testing.assert_array_equal(got["strike"], chain["strike"][keep])
        np.testing.assert_allclose(got["implied_vol"], chain["vol"][keep], rtol=1e-8)


def test_too_few_ivs_skip_sabr_as_in_the_reference(chain):
    data = {k: v[[0, 1, 2, 5]] for k, v in chain.items() if k != "vol"}  # two are bad
    port, ref = _both(dict(calibrate_heston=False, **OPTION_STAGES))
    assert port._to_sabr_input(data, 100.0, 0.05, 0.02) is None
    assert ref._to_sabr_input(data, 100.0, 0.05, 0.02) is None


@pytest.mark.parametrize("kind", ["dict", "frame_volume", "frame", "under_cap"])
def test_filter_matches_the_reference(kind):
    rng = np.random.default_rng(7)
    n = 40
    data = dict(strike=rng.permutation(np.arange(60.0, 140.0, 2.0))[:n],
                maturity=rng.choice([0.25, 0.5, 1.0], n), mid_price=rng.uniform(1, 20, n),
                volume=rng.permutation(n) * 10, underlying="SPY")
    if kind.startswith("frame"):
        data = pd.DataFrame(data)
        if kind == "frame":
            data = data.drop(columns="volume")
    cap = 100 if kind == "under_cap" else 12
    port, ref = _both(dict(max_options_per_underlying=cap))
    got, want = port._filter_options(data), ref._filter_options(data)
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want)
        assert len(got) == 12
        return
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert len(got["strike"]) == min(cap, n)


@pytest.mark.parametrize("warm", [True, False])
def test_heston_warm_start_and_gate_follow_the_reference(chain, warm):
    """Four runs of one underlying: a fit that passes the gate seeds the
    next run's warm start; one over ``max_rmse`` or under ``min_r_squared``
    is reported and leaves the cache as it was; with ``use_warm_start``
    off no run gets a start.  Statuses, errors and the starts each run
    was handed are the reference's."""
    quality = [(1e-9, 1.0), (9.0, 1.0), (1e-3, 0.2), (1e-9, 1.0)]
    config = dict(calibrate_sabr=False, use_warm_start=warm, **OPTION_STAGES)
    out = []
    port, ref = _both(config, heston_calibrator=lambda port: _FixedHeston(
        _heston_params(port), quality))
    for orch in (port, ref):
        runs = [orch.run_daily_calibration("TEST", chain, S0=100.0) for _ in quality]
        out.append(([r.status.value for r in runs], [r.errors for r in runs],
                    orch.heston.calls, orch._heston_warm))
    assert out[0] == out[1]
    statuses, errors, calls, cache = out[0]
    assert statuses == ["SUCCESS", "PARTIAL", "PARTIAL", "SUCCESS"]
    assert errors[1] == ["heston quality gate failed: rmse=9.0000"]
    starts = [c["warm_start"] for c in calls]
    assert starts == ([None] + [dict(zip(("kappa", "theta", "sigma", "rho", "v0"), HESTON))] * 3
                      if warm else [None] * 4)
    assert all(c["use_cached_on_failure"] for c in calls)


def test_full_daily_run_with_heston_sabr_and_ou():
    """The reference's daily run (Heston + SABR + OU on its 9 x 2 surface),
    through both packages on the same quotes and spread series, at the DE
    budget of the reference's isolation cases (15 x 6), which converges
    there."""
    data = JHeston.generate_synthetic_data(S0=100.0, r=0.05, q=0.0, n_strikes=9,
                                           n_maturities=2)
    spread = np.asarray(JOU.generate_synthetic_data(n_points=600, seed=1))
    budget = dict(global_maxiter=15, global_popsize=6)
    orch, ref_orch = _both(dict(calibrate_ou=True, **OPTION_STAGES),
                           heston_calibrator=lambda port: (
                               HestonCalibrator(**budget, **CPU64) if port else JHeston(**budget)))
    res = orch.run_daily_calibration("TEST", data, S0=100.0, spread_series=spread)
    ref = ref_orch.run_daily_calibration("TEST", data, S0=100.0, spread_series=spread)
    assert res.status == ref.status == CalibrationStatus.SUCCESS, (res.errors, ref.errors)
    assert res.errors == ref.errors == []
    names = ("kappa", "theta", "sigma", "rho", "v0")
    assert res.heston_result.rmse < 1e-8 and ref.heston_result.rmse < 1e-8
    np.testing.assert_allclose(_floats(res.heston_result.params, names),
                               _floats(ref.heston_result.params, names), rtol=1e-6)
    got = orch._to_sabr_input(data, 100.0, 0.05, 0.0)
    want = ref_orch._to_sabr_input(data, 100.0, 0.05, 0.0)
    np.testing.assert_array_equal(got["strike"], want["strike"])
    np.testing.assert_allclose(got["implied_vol"], want["implied_vol"], rtol=1e-10)
    by_t, ref_by_t = res.sabr_result.params_by_maturity, ref.sabr_result.params_by_maturity
    assert sorted(map(float, by_t)) == sorted(map(float, ref_by_t))
    for T in ref_by_t:
        np.testing.assert_allclose(_floats(by_t[float(T)], ("alpha", "rho", "nu")),
                                   _floats(ref_by_t[T], ("alpha", "rho", "nu")), rtol=1e-6)
    assert res.sabr_result.success == ref.sabr_result.success
    np.testing.assert_allclose(_floats(res.ou_result.params, ("theta", "mu", "sigma")),
                               _floats(ref.ou_result.params, ("theta", "mu", "sigma")),
                               rtol=1e-8)
    assert set(orch._heston_warm) == set(ref_orch._heston_warm) == {"TEST"}
    np.testing.assert_allclose([orch._heston_warm["TEST"][k] for k in names],
                               [ref_orch._heston_warm["TEST"][k] for k in names], rtol=1e-6)
    assert set(orch._sabr_warm) == set(ref_orch._sabr_warm)
    assert orch.get_cached_parameters("TEST") is None  # no store


def test_rough_opt_in_runs_and_reports():
    """The reference's rough refinement case: quotes by the converged
    classic pricer, the rough fit seeded at the classic fit (H = 0.25).
    Its LM is deterministic, so both packages land on one point (at 8
    fractional steps and 8 iterations, to keep the CPU short)."""
    data = JHeston.generate_synthetic_data(S0=100.0, r=0.05, q=0.0, n_strikes=7,
                                           n_maturities=2)
    data["mid_price"] = np.asarray(jheston.price_accurate(
        jheston.HestonParams(*HESTON), jnp.asarray(data["strike"]),
        jnp.asarray(data["maturity"]), 100.0, 0.05, 0.0, is_call=jnp.asarray(data["is_call"])))
    port, ref_orch = _both(
        dict(calibrate_sabr=False, calibrate_rough=True, **OPTION_STAGES),
        heston_calibrator=lambda port: _FixedHeston(_heston_params(port)),
        rough_calibrator=lambda port: (RoughHestonCalibrator(n_steps=8, max_iter=8, **CPU64)
                                       if port else JRough(n_steps=8, max_iter=8)))
    res = port.run_daily_calibration("TEST", data, S0=100.0)
    ref = ref_orch.run_daily_calibration("TEST", data, S0=100.0)
    assert res.status == ref.status == CalibrationStatus.SUCCESS, (res.errors, ref.errors)
    names = res.rough_result.params._fields
    assert names == ref.rough_result.params._fields
    np.testing.assert_allclose(_floats(res.rough_result.params, names),
                               _floats(ref.rough_result.params, names), rtol=1e-6)
    np.testing.assert_allclose(res.rough_result.rmse, ref.rough_result.rmse, rtol=1e-6)
    assert 0.02 <= float(res.rough_result.params.hurst) <= 0.5


@pytest.mark.parametrize("stage", ["rough", "bates"])
def test_rough_failure_is_isolated(chain, stage):
    """A refinement stage that raises degrades the run to PARTIAL and
    leaves the classic result in place, in both packages (the reference's
    rough and Bates isolation cases)."""

    class Boom:
        def calibrate_quotes(self, *a, **k):
            raise RuntimeError("boom")

        calibrate = calibrate_quotes

    port, ref_orch = _both(
        {"calibrate_sabr": False, f"calibrate_{stage}": True, **OPTION_STAGES},
        heston_calibrator=lambda port: _FixedHeston(_heston_params(port)),
        **{f"{stage}_calibrator": lambda port: Boom()})
    for res in (port.run_daily_calibration("TEST", chain, S0=100.0),
                ref_orch.run_daily_calibration("TEST", chain, S0=100.0)):
        assert res.heston_result is not None
        assert getattr(res, f"{stage}_result") is None
        assert len(res.errors) == 1 and res.errors[0].startswith(f"{stage}: ")
        assert "boom" in res.errors[0]
        assert res.status == CalibrationStatus.PARTIAL


def test_bates_stage_matches_the_reference():
    """The Bates refinement seeded from the classic fit with the
    reference's small jumps (lam 0.2, mu_j -0.05, sigma_j 0.15), on a
    surface those parameters price, half of it puts: both packages
    converge to it within a few iterations (their DE draws differ, so the
    converged parameters are compared)."""
    jumps = dict(lam=0.2, mu_j=-0.05, sigma_j=0.15)
    d = JBates.generate_synthetic_data(S0=100.0, r=0.05, q=0.0, n_strikes=5, n_maturities=2,
                                       **dict(zip(("kappa", "theta", "sigma", "rho", "v0"),
                                                  HESTON)), **jumps)
    K, T, C = (np.asarray(d[k], dtype=float) for k in ("strike", "maturity", "mid_price"))
    is_call = np.arange(K.size) % 2 == 0
    data = dict(strike=K, maturity=T, is_call=is_call,
                mid_price=np.where(is_call, C, C - 100.0 + K * np.exp(-0.05 * T)))
    budget = dict(global_maxiter=2, global_popsize=4, local_max_iter=5, warm_start_heston=False)
    port, ref_orch = _both(
        dict(calibrate_sabr=False, calibrate_bates=True, **OPTION_STAGES),
        heston_calibrator=lambda port: _FixedHeston(_heston_params(port)),
        bates_calibrator=lambda port: (BatesCalibrator(**budget, **CPU64) if port
                                       else JBates(**budget)))
    res = port.run_daily_calibration("TEST", data, S0=100.0)
    ref = ref_orch.run_daily_calibration("TEST", data, S0=100.0)
    assert res.status == ref.status == CalibrationStatus.SUCCESS, (res.errors, ref.errors)
    assert res.bates_result.rmse < 1e-8 and ref.bates_result.rmse < 1e-8
    names = ("kappa", "theta", "sigma", "rho", "v0", "lam", "mu_j", "sigma_j")
    np.testing.assert_allclose(_floats(res.bates_result.params, names),
                               _floats(ref.bates_result.params, names), atol=1e-6)
    np.testing.assert_allclose(_floats(res.bates_result.params, names),
                               HESTON + tuple(jumps.values()), atol=1e-6)


def test_too_few_options_fail_and_the_filter_keeps_the_money():
    orch = CalibrationOrchestrator(CalibrationConfig(max_options_per_underlying=3), **CPU64)
    res = orch.run_daily_calibration("X", {"strike": [100.0], "maturity": [1.0],
                                           "mid_price": [5.0]}, S0=100.0)
    assert res.status == CalibrationStatus.FAILED
    assert res.errors == ["only 1 options; need >= 5"]
    out = orch._filter_options({"strike": np.array([50.0, 80.0, 100.0, 105.0, 200.0]),
                                "maturity": np.ones(5), "mid_price": np.ones(5),
                                "underlying": "SPY"})
    assert sorted(out["strike"].tolist()) == [80.0, 100.0, 105.0]
    assert out["underlying"] == "SPY"

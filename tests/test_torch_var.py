"""The port's VaR calculator, stress tester and backtester held against
``pde_tpu``.

The same seeded numpy returns go through both packages in float64 (the JAX
side under ``jax_enable_x64``).  The Monte-Carlo method runs on JAX's own
draws: ``_mc_normals`` is answered with ``jax.random.normal(PRNGKey(seed),
(n, d))`` through ``tests/jax_key_draws.py`` (threefry and torch's Philox
streams differ), the draws ``jax.random.multivariate_normal`` makes by its
Cholesky method.  Gates: VaR, CVaR and component VaR at 1e-10 relative
(the P&L products and the Cholesky factor round in another order; the
sorted quantiles pick the same scenarios); the numpy parts equal.
"""

import jax
import numpy as np
import pytest
import torch

from jax_key_draws import JaxKey
from pde_tpu.risk import var_calculator as jvc
from pde_tpu_torch.risk import var_calculator as tvc

GATE = dict(rtol=1e-10, atol=1e-9)
IDS = ["SPY", "QQQ"]


@pytest.fixture
def market(rng):
    cov = np.array([[1e-4, 4e-5], [4e-5, 2.25e-4]])
    rets = rng.multivariate_normal([0, 0], cov, 1000)
    return {"SPY": 600_000.0, "QQQ": 400_000.0}, rets


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's Monte-Carlo normals are JAX's draws from PRNGKey(seed)."""
    monkeypatch.setattr(tvc, "_mc_normals", lambda seed, shape, dtype, device: JaxKey(
        jax.random.PRNGKey(seed)).normal(shape, dtype, device))


def _same(got, want):
    for k in ("var_95", "var_99", "cvar_95", "cvar_99"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), err_msg=k, **GATE)
    assert got.method == want.method and got.time_horizon == want.time_horizon
    assert got.portfolio_value == want.portfolio_value
    assert set(got.component_var) == set(want.component_var)
    for k, v in want.component_var.items():
        np.testing.assert_allclose(got.component_var[k], v, err_msg=k, **GATE)


CASES = {
    "base": {},
    "horizon5": dict(time_horizon=5),
    "seed7_2000": dict(seed=7, n_simulations=2000),
    "stressed_corr": dict(correlation_matrix=np.array([[1.0, 0.99], [0.99, 1.0]])),
    "short_book": dict(values={"SPY": 600_000.0, "QQQ": -250_000.0}),
}


@pytest.mark.parametrize("method", [m.value for m in jvc.VaRMethod])
@pytest.mark.parametrize("case", sorted(CASES))
def test_calculate_matches_the_reference(market, jax_draws, method, case):
    pv, rets = market
    kw = dict(CASES[case])
    pv = kw.pop("values", pv)
    corr = kw.pop("correlation_matrix", None)
    want = jvc.VaRCalculator(method=method, **kw).calculate(pv, rets, IDS, corr)
    got = tvc.VaRCalculator(method=method, device="cpu", **kw).calculate(pv, rets, IDS, corr)
    _same(got, want)


@pytest.mark.parametrize("method", ["historical", "monte_carlo", "parametric"])
def test_one_asset_series_and_default_ids(rng, jax_draws, method):
    """1-D returns and asset ids taken from the positions."""
    rets = rng.normal(0.0, 0.01, 500)
    pv = {"SPY": 1e6}
    _same(tvc.VaRCalculator(method=method, device="cpu").calculate(pv, rets),
          jvc.VaRCalculator(method=method).calculate(pv, rets))


def test_scenarios_match_jax_multivariate_normal(rng):
    """mean + z L^T is jax.random.multivariate_normal's Cholesky draw."""
    a = rng.normal(size=(4, 4))
    cov, mean = a @ a.T * 1e-4 + np.eye(4) * 1e-8, rng.normal(0.0, 1e-3, 4)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.multivariate_normal(key, mean, cov, (256,)))
    z = JaxKey(key).normal((256, 4), torch.float64, "cpu")
    got = tvc._mc_scenarios(torch.as_tensor(mean), torch.as_tensor(cov), z).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def test_monte_carlo_draws_from_its_seed(market):
    """The port's own generator: a seed gives the same VaR every call and
    another seed another one (Philox, so not the reference's numbers)."""
    pv, rets = market
    calc = tvc.VaRCalculator(method="monte_carlo", device="cpu")
    a, b = calc.calculate(pv, rets, IDS), calc.calculate(pv, rets, IDS)
    c = tvc.VaRCalculator(method="monte_carlo", seed=43, device="cpu").calculate(pv, rets, IDS)
    assert a.var_95 == b.var_95 and a.var_95 != c.var_95


def test_float32_calculator_stays_near_float64(market):
    pv, rets = market
    f64 = tvc.VaRCalculator(device="cpu").calculate(pv, rets, IDS)
    f32 = tvc.VaRCalculator(device="cpu", dtype=torch.float32).calculate(pv, rets, IDS)
    np.testing.assert_allclose(f32.var_95, f64.var_95, rtol=1e-5)


# --- the reference's TestVaR on the port ----------------------------------

def test_methods_agree_roughly(market):
    pv, rets = market
    results = {m: tvc.VaRCalculator(method=m, device="cpu").calculate(pv, rets, IDS)
               for m in tvc.VaRMethod}
    vars95 = [r.var_95 for r in results.values()]
    assert max(vars95) / min(vars95) < 1.5
    for r in results.values():
        assert r.var_99 > r.var_95 > 0
        assert r.cvar_95 >= r.var_95 * 0.95


def test_component_var_and_pct(market):
    pv, rets = market
    res = tvc.VaRCalculator(method=tvc.VaRMethod.PARAMETRIC, device="cpu").calculate(pv, rets, IDS)
    assert set(res.component_var) == set(IDS)
    assert abs(sum(res.component_var.values()) - res.var_95) < res.var_95 * 0.05
    hist = tvc.VaRCalculator(device="cpu").calculate(pv, rets, IDS)
    assert hist.var_95_pct == pytest.approx(hist.var_95 / 1_000_000)
    assert set(hist.to_dict()) == set(jvc.VaRCalculator().calculate(pv, rets, IDS).to_dict())


def test_correlation_matrix_override_raises_var(market):
    pv, rets = market
    calc = tvc.VaRCalculator(method=tvc.VaRMethod.PARAMETRIC, device="cpu")
    base = calc.calculate(pv, rets, IDS)
    stressed = calc.calculate(pv, rets, IDS, correlation_matrix=np.array([[1.0, 0.99],
                                                                         [0.99, 1.0]]))
    assert stressed.var_95 > base.var_95 * 1.05


PORTFOLIOS = {
    "spy_tlt": {"SPY": 500_000.0, "TLT": 500_000.0},
    "mixed": {"SPY": 300_000.0, "QQQ": -200_000.0, "GLD": 100_000.0, "XYZ": 50_000.0},
}


@pytest.mark.parametrize("name", sorted(PORTFOLIOS))
def test_stress_scenarios_match_the_reference(name):
    portfolio = PORTFOLIOS[name]
    jst, tst = jvc.StressTester(), tvc.StressTester()
    assert tst.scenarios == jst.scenarios and len(tst.scenarios) == 7
    for scen in jst.scenarios:
        got, want = tst.apply_scenario(portfolio, scen), jst.apply_scenario(portfolio, scen)
        assert {k: v for k, v in got.to_dict().items() if k != "timestamp"} == {
            k: v for k, v in want.to_dict().items() if k != "timestamp"}
    assert tst.get_worst_case(portfolio).scenario_name == jst.get_worst_case(portfolio).scenario_name
    assert tst.summary_report(portfolio) == jst.summary_report(portfolio)
    got = tst.apply_custom_scenario(portfolio, {"SPY": -0.1}, "c", default_shock=-0.02)
    want = jst.apply_custom_scenario(portfolio, {"SPY": -0.1}, "c", default_shock=-0.02)
    assert got.scenario_pnl == want.scenario_pnl


def test_stress_scenarios():
    st = tvc.StressTester()
    portfolio = {"SPY": 500_000.0, "TLT": 500_000.0}
    res = st.apply_scenario(portfolio, "2008_financial_crisis")
    assert res.scenario_pnl == pytest.approx(500_000 * -0.38 + 500_000 * 0.25)
    assert st.get_worst_case(portfolio).scenario_pnl <= res.scenario_pnl
    with pytest.raises(KeyError):
        st.apply_scenario(portfolio, "nope")
    st.add_scenario("custom_crash", {"XYZ": -0.5})
    assert st.apply_scenario({"XYZ": 100_000.0}, "custom_crash").scenario_pnl == -50_000.0
    assert "custom_crash" in st.summary_report({"XYZ": 100_000.0})


@pytest.mark.parametrize("var_level", [1645.0, 200.0, 1e9, 0.0])
def test_kupiec_backtest_matches_the_reference(rng, var_level):
    """A calibrated, an understated, a never-breached and an always-breached
    forecast (the x = 0 and x = n branches)."""
    pnl = rng.normal(0, 1000, 1000)
    if var_level == 0.0:
        pnl = -np.abs(pnl) - 1.0
    var = np.full(1000, var_level)
    got = tvc.VaRBacktester.kupiec_test(pnl, var, 0.95)
    assert got == jvc.VaRBacktester.kupiec_test(pnl, var, 0.95)
    if var_level == 1645.0:
        assert not got["reject_model"]
    if var_level == 200.0:
        assert got["reject_model"]

"""The port's statistical tests and stress testing held against ``pde_tpu``.

The scipy tests, the overfitting detectors, the crisis paths and the tail
analysis are host copies: equal to the reference on the same inputs.  The
bootstrap and the Monte-Carlo stress run on JAX's own draws replayed
through ``JaxKey`` and agree to 1e-12 relative; on the port's generator
they are held to the reference test's statistical bounds.  The module is
imported as a module, never ``TestResult`` by name (pytest would collect
that enum).
"""

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from jax_key_draws import JaxKey
from pde_tpu.validation import statistical_tests as jst
from pde_tpu.validation import stress_testing as jsx
from pde_tpu_torch.models import heston_mc
from pde_tpu_torch.validation import statistical_tests as tst
from pde_tpu_torch.validation import stress_testing as tsx

CPU = dict(device="cpu")


def _close(a, b, rel=1e-12):
    return abs(a - b) <= rel * max(abs(a), abs(b))


def _same_result(got, want):
    assert got.to_dict() == want.to_dict()


@pytest.fixture
def profitable():
    return np.random.default_rng(3).normal(0.001, 0.01, 1000)


@pytest.fixture
def noise():
    return np.random.default_rng(8).normal(0.0, 0.01, 1000)


def test_significance_tests_are_the_reference_s(profitable, noise):
    t, j = tst.StrategyStatisticalTests(), jst.StrategyStatisticalTests()
    for r in (profitable, noise):
        _same_result(t.test_returns_significance(r), j.test_returns_significance(r))
        _same_result(t.test_sharpe_significance(r, 0.5), j.test_sharpe_significance(r, 0.5))
        _same_result(t.test_returns_normality(r), j.test_returns_normality(r))
        _same_result(t.test_regime_stability(r), j.test_regime_stability(r))
    _same_result(t.test_strategy_comparison(profitable, noise[:900]),
                 j.test_strategy_comparison(profitable, noise[:900]))
    _same_result(t.test_information_coefficient(profitable, noise),
                 j.test_information_coefficient(profitable, noise))
    assert t.test_returns_significance(profitable).result == tst.TestResult.SIGNIFICANT
    assert t.test_returns_significance(noise).result == tst.TestResult.NOT_SIGNIFICANT


def test_overfitting_detectors_are_the_reference_s(rng):
    t, j = tst.OverfittingDetector(), jst.OverfittingDetector()
    for trials in (2, 1000):
        assert t.deflated_sharpe_ratio(0.1, trials, 1000, -0.3, 4.0) == \
            j.deflated_sharpe_ratio(0.1, trials, 1000, -0.3, 4.0)
    is_m, oos_m = rng.normal(0, 1, (20, 10)), rng.normal(0, 1, (20, 10))
    assert t.probability_of_backtest_overfitting(is_m, oos_m) == \
        j.probability_of_backtest_overfitting(is_m, oos_m)
    assert t.is_oos_degradation(-0.1, -2.0) == j.is_oos_degradation(-0.1, -2.0)
    assert t.is_oos_degradation(-0.1, -2.0)["suspicious"]


@pytest.mark.parametrize("seed", [42, 7])
def test_bootstrap_on_jax_draws_matches_the_reference(profitable, seed):
    want = jst.BootstrapAnalysis(n_bootstrap=300, random_state=seed)
    got = tst.BootstrapAnalysis(n_bootstrap=300, random_state=seed, **CPU)
    key = JaxKey(jax.random.PRNGKey(seed))
    for name in ("sharpe_confidence_interval", "max_drawdown_confidence_interval"):
        g = getattr(got, name)(profitable, 0.9, generator=key)
        w = getattr(want, name)(profitable, 0.9)
        assert g[0] == w[0]
        assert _close(g[1], w[1]) and _close(g[2], w[2]), (name, g, w)
    samples = got._resample(profitable, key).numpy()
    np.testing.assert_array_equal(samples, np.asarray(want._resample(profitable)))


def test_bootstrap_on_a_generator(profitable):
    boot = tst.BootstrapAnalysis(n_bootstrap=500, **CPU)
    point, lo, hi = boot.sharpe_confidence_interval(profitable)
    assert lo < point < hi
    assert boot.sharpe_confidence_interval(profitable) == (point, lo, hi)  # seeded alike
    point, lo, hi = boot.max_drawdown_confidence_interval(profitable)
    assert 0 <= lo <= hi


def test_crisis_paths_are_the_reference_s_bits():
    for t, j in zip(tsx.BUILTIN_SCENARIOS, jsx.BUILTIN_SCENARIOS):
        assert t.name == j.name
        np.testing.assert_array_equal(t.return_path, j.return_path)
        realized = float(np.prod(1.0 + t.return_path) - 1.0)
        assert realized == pytest.approx(t.equity_shock, abs=1e-10), t.name


def test_historical_and_reverse_stress_are_the_reference_s():
    t, j = tsx.StressTestEngine(**CPU), jsx.StressTestEngine()
    got, want = t.run_all_historical_scenarios(0.7), j.run_all_historical_scenarios(0.7)
    assert {k: v.__dict__ for k, v in got.items()} == {k: v.__dict__ for k, v in want.items()}
    assert t.run_historical_scenario("2020_covid_crash", 1.2, 0.01).__dict__ == \
        j.run_historical_scenario("2020_covid_crash", 1.2, 0.01).__dict__
    for days in (21, 2):
        assert t.reverse_stress_test(0.01, 0.25, days) == j.reverse_stress_test(0.01, 0.25, days)


@pytest.mark.parametrize("dof", [4.0, 6.5])
def test_monte_carlo_stress_on_jax_draws_matches_the_reference(dof):
    kw = dict(daily_vol=0.02, n_days=63, n_paths=400, t_dof=dof)
    want = jsx.StressTestEngine(random_state=5).run_monte_carlo_stress(**kw)
    got = tsx.StressTestEngine(random_state=5, **CPU).run_monte_carlo_stress(
        **kw, generator=JaxKey(jax.random.PRNGKey(5)))
    assert got["n_paths"] == want["n_paths"]
    for k in ("prob_breach_risk_limit", "expected_max_drawdown", "p99_max_drawdown",
              "p1_final_equity"):
        assert _close(got[k], want[k]), k


def test_monte_carlo_stress_on_a_generator():
    out = tsx.StressTestEngine(**CPU).run_monte_carlo_stress(daily_vol=0.02, n_paths=500)
    assert 0.0 <= out["prob_breach_risk_limit"] <= 1.0
    assert out["p99_max_drawdown"] > out["expected_max_drawdown"]


def test_student_t_draws_have_the_t_moments():
    """The generator route's t(nu) = z / sqrt(2 Gamma(nu / 2) / nu): mean 0,
    variance nu / (nu - 2), and the tail weight of a t(4)."""
    gen = torch.Generator().manual_seed(0)
    t = heston_mc._GeneratorDraws(gen).student_t(6.0, (400_000,), torch.float64, "cpu").numpy()
    assert abs(t.mean()) < 4 * np.sqrt(1.5 / t.size)
    assert abs(t.var() - 1.5) < 0.03
    t4 = heston_mc._GeneratorDraws(gen).student_t(4.0, (400_000,), torch.float64, "cpu").numpy()
    want = 2 * (1 - stats.t.cdf(3.0, 4.0))
    assert abs(np.mean(np.abs(t4) > 3.0) - want) < 4 * np.sqrt(want / t4.size)


def test_replays_hand_back_the_same_integer_draws():
    rep = heston_mc._Replay(heston_mc._GeneratorDraws(torch.Generator().manual_seed(1)))
    a = rep.randint(0, 50, (3, 7), "cpu")
    assert torch.equal(a, rep.randint(0, 50, (3, 7), "cpu"))
    assert a.dtype == torch.int64 and int(a.min()) >= 0 and int(a.max()) < 50
    p = heston_mc._Replay(heston_mc._GeneratorDraws(torch.Generator().manual_seed(2)))
    perm = p.permutation(9, "cpu", count=4)
    assert torch.equal(perm, p.permutation(9, "cpu", count=4))
    assert torch.equal(perm.sort(dim=1).values, torch.arange(9).expand(4, 9))
    with pytest.raises(ValueError):
        p.permutation(9, "cpu")


def test_tail_analysis_is_the_reference_s(rng):
    fat = rng.standard_t(3, 5000) * 0.01
    t, j = tsx.TailRiskAnalyzer(), jsx.TailRiskAnalyzer()
    assert t.analyze(fat) == j.analyze(fat)
    assert t.hill_tail_index(fat) == j.hill_tail_index(fat)

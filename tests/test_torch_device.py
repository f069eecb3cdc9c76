"""The port's entry points run on the card unless the caller names the CPU.

``device=None`` means ``precision.default_device()``: ``cuda:0``, or a
``RuntimeError`` when no card is there.  With CUDA reported absent, every
entry point called without ``device`` must raise before it computes
anything, rather than quietly run on the CPU.
"""

import numpy as np
import pytest
import torch

from pde_tpu_torch.backtest import analysis, data_handler, optimizer
from pde_tpu_torch.calibrate.bates import BatesCalibrator
from pde_tpu_torch.calibrate.g2 import G2Calibrator
from pde_tpu_torch.calibrate.heston import HestonCalibrator, parameter_sensitivities
from pde_tpu_torch.calibrate.orchestrator import CalibrationOrchestrator
from pde_tpu_torch.calibrate.rates import HullWhiteCalibrator
from pde_tpu_torch.calibrate.rough import RoughHestonCalibrator
from pde_tpu_torch.calibrate.sabr import SABRCalibrator
from pde_tpu_torch.core import grids, precision, qmc
from pde_tpu_torch.data import options
from pde_tpu_torch.models import (bates, black_scholes, credit, digital, forward_start, g2,
                                  heston, heston_mc, local_vol, multi_asset, rates,
                                  rough_heston, rough_heston_mc, sabr, slv, svcj, term_heston,
                                  varswap, vix)
from pde_tpu_torch.risk.position_sizer import VolatilityEstimator
from pde_tpu_torch.risk.var_calculator import VaRCalculator
from pde_tpu_torch.serving import BatchPricer, PricingRequest
from pde_tpu_torch.signals.vol_arbitrage import VolSurfaceArbitrageSignal
from pde_tpu_torch.solvers import (barrier_pde, bates_pide, bermudan_g2, bermudan_hw, bs_pde,
                                   heston_adi, local_vol_pde, lsm, lsm_dual, pide)
from pde_tpu_torch.utils import linalg
from pde_tpu_torch.validation import statistical_tests, stress_testing


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _flat(s, t):
    return torch.full_like(s, 0.2)


_HP = heston_adi.HestonPDEParams(n_spot=8, n_vol=5, n_time=2)
_HESTON = heston.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04)
_BATES = bates.BatesParams(2.0, 0.04, 0.3, -0.7, 0.04, 0.5, -0.1, 0.15)
_SVCJ = svcj.SVCJParams(2.0, 0.04, 0.3, -0.7, 0.04, 0.5, -0.1, 0.15, 0.05, -0.5)
_ROUGH = rough_heston.RoughHestonParams(0.1, 2.0, 0.04, 0.3, -0.7, 0.04)
_BOOK = (np.full((2, 4), 100.0), np.full((2, 4), 1.0), np.full((2, 4), 10.0),
         np.full(2, 100.0), 0.05, 0.02)


def _plain_curve(device):
    return rates.curve_from_zero_rates([1.0, 2.0, 5.0], [0.03, 0.035, 0.04], device=device)


def _hw(device):
    return rates.HullWhiteParams(0.1, 0.012, _plain_curve(device))


def _card_or(device):
    """A generator of the path's device (the card for None)."""
    return torch.Generator(device=device or "cuda")


_LEVERAGE = slv.LeverageSurface(torch.linspace(4.4, 4.8, 3), torch.tensor([0.0, 0.5]),
                                torch.ones(2, 3))


# each takes the device (None: the card) and computes on it
RATES_ENTRY_POINTS = {
    "rates.flat_curve": lambda d: rates.flat_curve(0.03, device=d).dfs,
    "rates.curve_from_zero_rates": lambda d: _plain_curve(d).dfs,
    "rates.vasicek_bond": lambda d: rates.vasicek_bond(
        rates.VasicekParams(0.5, 0.04, 0.015, 0.03), _plain_curve(d).times),
    "rates.vasicek_bond_option": lambda d: rates.vasicek_bond_option(
        rates.VasicekParams(0.5, 0.04, 0.015, 0.03), 0.9, 1.0, _plain_curve(d).times + 1.0),
    "rates.cir_bond": lambda d: rates.cir_bond(rates.CIRParams(0.5, 0.04, 0.1, 0.03),
                                               _plain_curve(d).times),
    "rates.hw_swaption": lambda d: rates.hw_swaption(
        rates.HullWhiteParams(0.1, 0.012, _plain_curve(d)), 0.035, 1.0, [1.5, 2.0, 2.5]),
    "rates.hw_cap": lambda d: rates.hw_cap(
        rates.HullWhiteParams(0.1, 0.012, _plain_curve(d)), 0.035, [1.0, 1.5, 2.0]),
    "rates.hw_simulate": lambda d: rates.hw_simulate(
        rates.HullWhiteParams(0.1, 0.012, _plain_curve(d)), 1.0,
        torch.Generator(device=d or "cuda"), n_steps=2, n_paths=4)[1],
    "rates.bachelier_implied_vol": lambda d: rates.bachelier_implied_vol(
        rates.bachelier_price(0.03, _plain_curve(d).dfs * 0.03, 0.0075, 1.0), 0.03, 0.03, 1.0),
    "rates.strip_caplet_vols": lambda d: rates.strip_caplet_vols(
        _plain_curve(d), 0.035, [1.0, 2.0], [0.2, 0.22])[2],
    "g2.g2_swaption": lambda d: g2.g2_swaption(
        g2.G2Params(0.5, 0.05, 0.01, 0.008, -0.6, _plain_curve(d)), 0.035, 1.0, [1.5, 2.0],
        n_gh=8),
    "credit.flat_hazard": lambda d: credit.flat_hazard(0.02, device=d).survival,
    "credit.bootstrap_hazard": lambda d: credit.bootstrap_hazard(
        _plain_curve(d), [1.0, 3.0], [0.01, 0.012], n_buckets=8, n_newton=2)[1],
    "HullWhiteCalibrator": lambda d: torch.empty(0, device=HullWhiteCalibrator(
        device=d).device),
    "G2Calibrator": lambda d: torch.empty(0, device=G2Calibrator(device=d).device),
    "bermudan_hw.bermudan_swaption_pde": lambda d: bermudan_hw.bermudan_swaption_pde(
        _hw(d), [0.03, 0.04], [1.0, 1.5, 2.0], n_x=9, n_sub=2)[0],
    "bermudan_hw.bermudan_swaption_mc": lambda d: bermudan_hw.bermudan_swaption_mc(
        _hw(d), 0.035, [1.0, 1.5, 2.0], _card_or(d), n_paths=8, n_outer=2, n_inner=2)[0],
    "bermudan_g2.bermudan_swaption_g2_mc": lambda d: bermudan_g2.bermudan_swaption_g2_mc(
        g2.G2Params(0.5, 0.05, 0.01, 0.008, -0.6, _plain_curve(d)), 0.035, [1.0, 1.5, 2.0],
        _card_or(d), n_paths=8, n_outer=2, n_inner=2)[0],
    "credit.cva_netting_hw_mc": lambda d: credit.cva_netting_hw_mc(
        _hw(d), credit.flat_hazard(0.02, device=d), [credit.SwapTrade(0.035, 1.0, 1.0)],
        [0.5, 1.0, 1.5], _card_or(d), n_paths=8)[1],
    # lift_nodes takes ``device=`` as the builders above do
    "rough_heston_mc.lift_nodes": lambda d: rough_heston_mc.lift_nodes(0.1, 4, device=d)[0],
    "CalibrationOrchestrator": lambda d: torch.empty(0, device=CalibrationOrchestrator(
        device=d).device),
}


# the jump-diffusion and barrier PDE solvers: each takes the device
PIDE_ENTRY_POINTS = {
    "pide.solve_pide": lambda d: pide.solve_pide(
        pide.MertonJumps(0.5, -0.1, 0.15), 0.2, 0.05, 0.02, 0.5, [90.0, 110.0], 100.0,
        n_space=16, n_time=10, device=d).price,
    "bates_pide.solve_bates_pide": lambda d: bates_pide.solve_bates_pide(
        bates_pide.BatesPIDEParams(n_spot=16, n_vol=8, n_time=10), 100.0, device=d).price,
    "barrier_pde.solve_barrier": lambda d: barrier_pde.solve_barrier(
        _HP, 100.0, 120.0, "up-and-in", device=d).price,
}


_MC = dict(n_steps=2, n_paths=8)
# the Monte Carlo entry points: each takes the generator (a CPU one) and
# the device (None: the card; "cuda" with the CPU generator raises
# ValueError before it computes)
MC_ENTRY_POINTS = {
    "heston_mc.simulate_qe": lambda g, d: heston_mc.simulate_qe(
        _HESTON, 100.0, 1.0, g, device=d, **_MC),
    "heston_mc.simulate_qe(sobol)": lambda g, d: heston_mc.simulate_qe(
        _HESTON, 100.0, 1.0, g, antithetic=False, sampler="sobol", device=d, **_MC),
    "heston_mc.simulate_qe_paths": lambda g, d: heston_mc.simulate_qe_paths(
        _HESTON, 100.0, 1.0, g, device=d, **_MC),
    "heston_mc.price_european_mc": lambda g, d: heston_mc.price_european_mc(
        _HESTON, [90.0, 110.0], 1.0, 100.0, g, device=d, **_MC),
    "heston_mc.price_asian_mc": lambda g, d: heston_mc.price_asian_mc(
        _HESTON, 100.0, 1.0, 100.0, g, device=d, **_MC),
    "heston_mc.price_barrier_mc": lambda g, d: heston_mc.price_barrier_mc(
        _HESTON, 100.0, 120.0, 1.0, 100.0, g, continuity_correction=True, device=d, **_MC),
    "heston_mc.price_digital_mc": lambda g, d: heston_mc.price_digital_mc(
        _HESTON, 100.0, 1.0, 100.0, g, device=d, **_MC),
    "heston_mc.price_touch_mc": lambda g, d: heston_mc.price_touch_mc(
        _HESTON, 120.0, 1.0, 100.0, g, device=d, **_MC),
    "heston_mc.price_lookback_mc": lambda g, d: heston_mc.price_lookback_mc(
        _HESTON, 1.0, 100.0, g, device=d, **_MC),
    "heston_mc.price_path_payoff_mc": lambda g, d: heston_mc.price_path_payoff_mc(
        _HESTON, lambda p: p.spot, 100.0, 1.0, g, device=d, **_MC),
    "heston_mc.price_forward_start_mc": lambda g, d: heston_mc.price_forward_start_mc(
        _HESTON, 1.0, 0.5, 1.0, 100.0, g, device=d, **_MC),
    "heston_mc.price_cliquet_mc": lambda g, d: heston_mc.price_cliquet_mc(
        _HESTON, 1.0, 100.0, g, n_periods=2, device=d, **_MC),
    "heston_mc.greeks_european_mc": lambda g, d: heston_mc.greeks_european_mc(
        _HESTON, 100.0, 1.0, 100.0, g, device=d, **_MC),
    "lsm.price_american_lsm": lambda g, d: lsm.price_american_lsm(
        _HESTON, 100.0, 1.0, 100.0, g, device=d, **_MC),
    "lsm.price_american_lsm_batch": lambda g, d: lsm.price_american_lsm_batch(
        _HESTON, [90.0, 110.0], False, 1.0, 100.0, g, device=d, **_MC),
    "lsm_dual.dual_upper_bound": lambda g, d: lsm_dual.dual_upper_bound(
        _HESTON, 100.0, 1.0, 100.0, g, n_steps=2, n_reg_paths=8, n_outer=2, n_inner=2,
        device=d),
    "bates.simulate_qe": lambda g, d: bates.simulate_qe(_BATES, 100.0, 1.0, g, device=d, **_MC),
    "bates.price_american_mc": lambda g, d: bates.price_american_mc(
        _BATES, 100.0, 1.0, 100.0, g, device=d, **_MC),
    "svcj.simulate_qe_qv": lambda g, d: svcj.simulate_qe_qv(_SVCJ, 100.0, 1.0, g, device=d,
                                                            **_MC),
    "svcj.price_european_mc": lambda g, d: svcj.price_european_mc(
        _SVCJ, 100.0, 1.0, 100.0, g, device=d, **_MC),
    "multi_asset.sample_terminal_gbm": lambda g, d: multi_asset.sample_terminal_gbm(
        g, [100.0, 95.0], [0.2, 0.3], [[1.0, 0.5], [0.5, 1.0]], 1.0, n_paths=8, device=d)[0],
    "multi_asset.price_basket_mc": lambda g, d: multi_asset.price_basket_mc(
        g, [100.0, 95.0], [0.5, 0.5], [100.0], 1.0, [0.2, 0.3], [[1.0, 0.5], [0.5, 1.0]],
        n_paths=8, device=d),
    "multi_asset.price_spread_mc": lambda g, d: multi_asset.price_spread_mc(
        g, 100.0, 96.0, 5.0, 0.9, 0.25, 0.35, 0.5, n_paths=8, device=d),
    "multi_asset.price_rainbow_mc": lambda g, d: multi_asset.price_rainbow_mc(
        g, 100.0, 96.0, 100.0, 0.9, 0.25, 0.35, 0.5, n_paths=8, device=d),
    "local_vol.simulate_local_vol": lambda g, d: local_vol.simulate_local_vol(
        _flat, 100.0, 1.0, g, device=d, **_MC),
    "local_vol.lv_simulate_fn": lambda g, d: heston_mc.price_european_mc(
        None, 100.0, 1.0, 100.0, g, simulate_fn=local_vol.lv_simulate_fn(_flat), device=d,
        **_MC),
    "rough_heston_mc.simulate_lifted": lambda g, d: rough_heston_mc.simulate_lifted(
        _ROUGH, 100.0, 1.0, g, n_factors=4, device=d, **_MC),
    "rough_heston_mc.simulate_lifted_paths": lambda g, d: rough_heston_mc.simulate_lifted_paths(
        _ROUGH, 100.0, 1.0, g, n_factors=4, device=d, **_MC),
    "rough_heston_mc.price_european_rough_mc": lambda g, d: (
        rough_heston_mc.price_european_rough_mc(_ROUGH, 100.0, 1.0, 100.0, g, n_factors=4,
                                                device=d, **_MC)),
    "rough_heston_mc.price_american_rough_lsm": lambda g, d: (
        rough_heston_mc.price_american_rough_lsm(_ROUGH, 100.0, 1.0, 100.0, g, n_factors=4,
                                                 device=d, **_MC)),
    "slv.calibrate_leverage": lambda g, d: slv.calibrate_leverage(
        _HESTON, _flat, 100.0, 1.0, g, n_bins=3, device=d, **_MC)[0].values,
    "slv.simulate_slv": lambda g, d: slv.simulate_slv(_HESTON, _LEVERAGE, 100.0, 1.0, g,
                                                      n_paths=8, device=d),
    "slv.slv_simulate_fn": lambda g, d: heston_mc.price_european_mc(
        _HESTON, 100.0, 1.0, 100.0, g, simulate_fn=slv.slv_simulate_fn(_LEVERAGE), device=d,
        **_MC),
    "qmc.scramble_direction_numbers": lambda g, d: qmc.scramble_direction_numbers(
        qmc.sobol_direction_numbers(4), g, device=d),
    "qmc.sobol_normal": lambda g, d: qmc.sobol_normal(qmc.sobol_direction_numbers(4), 8, g,
                                                      device=d),
}


_RETURNS = np.random.default_rng(0).normal(0.0, 0.01, (3, 40))
_CHAIN = {"strike": [95.0, 105.0], "T": [0.2, 0.2], "implied_vol": [0.15, 0.25]}

# the signal, sizing, VaR and serving layer: each jnp path of the reference
# computes on the card (a GARCH fit's device error is not one of the
# numerics its EWMA fallback takes)
SIGNAL_RISK_ENTRY_POINTS = {
    "VolatilityEstimator.estimate(ewma)": lambda: VolatilityEstimator("ewma").estimate(
        _RETURNS[0]),
    "VolatilityEstimator.estimate(garch)": lambda: VolatilityEstimator("garch").estimate(
        _RETURNS[0]),
    "VolatilityEstimator.estimate_batch": lambda: VolatilityEstimator("hybrid").estimate_batch(
        _RETURNS),
    "VaRCalculator(historical)": lambda: VaRCalculator().calculate(
        {"A": 1e6, "B": 5e5}, _RETURNS[:2].T),
    "VaRCalculator(monte_carlo)": lambda: VaRCalculator("monte_carlo").calculate(
        {"A": 1e6, "B": 5e5}, _RETURNS[:2].T),
    "VolSurfaceArbitrageSignal.generate_signals": lambda: (
        VolSurfaceArbitrageSignal().generate_signals(
            _CHAIN, 100.0, 0.05, 0.02, heston_result=type("R", (), dict(
                params=_HESTON, rmse=0.01))())),
    "BatchPricer.price": lambda: BatchPricer(buckets=(8,)).price(
        [PricingRequest(100.0, 1.0, 100.0, (2.0, 0.04, 0.3, -0.7, 0.04))]),
}


_PRICES = 100.0 * np.exp(np.cumsum(np.random.default_rng(1).normal(0.0, 0.01, 80)))
_MA = {"ma_crossover": {"fn": optimizer.STRATEGY_FAMILIES["ma_crossover"]["fn"],
                        "grid": {"short": [5], "long": [20]}}}

# the backtest, validation, linear algebra and options-data layer: each
# takes the device (None: the card) and computes on it
BACKTEST_ENTRY_POINTS = {
    "StrategyOptimizer.optimize_series": lambda d: optimizer.StrategyOptimizer(
        _MA, device=d).optimize_series(_PRICES)["ma_crossover"].fitness,
    "RollingOptimizationBacktester.run": lambda d: optimizer.RollingOptimizationBacktester(
        optimizer.StrategyOptimizer(_MA, device=d), 40, 20).run(_PRICES).oos_returns,
    "WalkForwardAnalysis.run": lambda d: analysis.WalkForwardAnalysis(
        optimizer.STRATEGY_FAMILIES["ma_crossover"]["fn"], {"short": [5], "long": [20]}, 40, 20,
        device=d).run(_PRICES).oos_returns,
    "MonteCarloSimulator.run": lambda d: analysis.MonteCarloSimulator(
        10, device=d).run(_RETURNS[0]).final_equity_mean,
    "BootstrapAnalysis": lambda d: statistical_tests.BootstrapAnalysis(
        10, device=d).sharpe_confidence_interval(_RETURNS[0]),
    "run_monte_carlo_stress": lambda d: stress_testing.StressTestEngine(
        device=d).run_monte_carlo_stress(0.01, 5, 10)["expected_max_drawdown"],
    "SyntheticDataHandler": lambda d: data_handler.SyntheticDataHandler(
        ["A"], 10, device=d).prices["A"],
    "calculate_chain": lambda d: options.ImpliedVolatilityCalculator(device=d).calculate_chain(
        [10.45], 100.0, [100.0], [1.0], [True]),
    "SVIParameterization.fit": lambda d: options.SVIParameterization(device=d).fit(
        np.linspace(-0.2, 0.2, 7), 0.02 + 0.1 * np.linspace(-0.2, 0.2, 7) ** 2, 0.5)["a"],
    "ewma_covariance": lambda d: linalg.ewma_covariance(_RETURNS.T, device=d),
}


ENTRY_POINTS = {
    **SIGNAL_RISK_ENTRY_POINTS,
    **{name: (lambda fn=fn: fn(None)) for name, fn in BACKTEST_ENTRY_POINTS.items()},
    "HestonCalibrator": lambda: HestonCalibrator(),
    "generate_synthetic_data": lambda: HestonCalibrator.generate_synthetic_data(
        n_strikes=3, n_maturities=2),
    "heston_adi.solve_fused_batch": lambda: heston_adi.solve_fused_batch(
        2.0, 0.04, 0.3, -0.7, 0.04, 0.05, 0.02, 1.0, 100.0, 1.0, 100.0,
        n_spot=8, n_vol=5, n_time=2),
    "heston_adi.solve": lambda: heston_adi.solve(_HP, 100.0),
    "heston_adi.solve_fused": lambda: heston_adi.solve_fused(_HP, 100.0),
    "heston_adi.solve_batch": lambda: heston_adi.solve_batch(
        2.0, 0.04, 0.3, -0.7, 0.04, 0.05, 0.02, 1.0, [90.0, 110.0], True, 100.0,
        n_spot=8, n_vol=5, n_time=2),
    "heston_adi.greeks_ad": lambda: heston_adi.greeks_ad(
        2.0, 0.04, 0.3, -0.7, 0.04, 0.05, 0.02, 1.0, 100.0, True, 100.0,
        n_spot=8, n_vol=5, n_time=2),
    "bs_pde.solve": lambda: bs_pde.solve(bs_pde.BSPDEParams(n_space=12, n_time=10), 100.0),
    "grids.uniform_grid": lambda: grids.uniform_grid(0.0, 1.0, 5),
    "local_vol_pde.solve": lambda: local_vol_pde.solve(
        _flat, 100.0, K=100.0, T=1.0, n_space=12, n_time=2),
    "local_vol_pde.solve_fused": lambda: local_vol_pde.solve_fused(
        _flat, 100.0, K=100.0, T=1.0, n_space=12, n_time=2),
    "local_vol_pde.solve_fused_batch": lambda: local_vol_pde.solve_fused_batch(
        _flat, 100.0, K=[90.0, 110.0], T=1.0, n_space=12, n_time=2),
    "bs_pde.solve_fused_batch": lambda: bs_pde.solve_fused_batch(
        0.2, 0.05, 0.01, 1.0, 100.0, 1.0, 100.0),
    "SABRCalibrator": lambda: SABRCalibrator(),
    "generate_synthetic_smile": lambda: SABRCalibrator.generate_synthetic_smile(),
    "dupire_surface": lambda: local_vol.dupire_surface(
        heston.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04), np.array([90.0, 110.0]),
        np.array([0.5, 1.0]), 100.0),
    # model functions called with plain numbers take the card as well
    "black_scholes.price": lambda: black_scholes.price(100.0, 100.0, 0.05, 0.0, 1.0, 0.2),
    "black_scholes.implied_vol": lambda: black_scholes.implied_vol(
        10.45, 100.0, 100.0, 0.05, 0.0, 1.0),
    "sabr.implied_volatility": lambda: sabr.implied_volatility(
        100.0, 100.0, 1.0, sabr.SABRParams(0.25, 0.5, -0.35, 0.45)),
    "heston.price_accurate": lambda: heston.price_accurate(
        heston.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04), 100.0, 1.0, 100.0),
    "grids.log_grid": lambda: grids.log_grid(50.0, 200.0, 5),
    "black_scholes.delta": lambda: black_scholes.delta(100.0, 100.0, 0.05, 0.0, 1.0, 0.2),
    "black_scholes.barrier_price": lambda: black_scholes.barrier_price(
        100.0, 100.0, 120.0, 0.05, 0.0, 1.0, 0.2),
    "heston.implied_volatility_surface": lambda: heston.implied_volatility_surface(
        _HESTON, np.array([90.0, 110.0]), np.array([0.5, 1.0]), 100.0),
    "heston.greeks_ad": lambda: heston.greeks_ad(_HESTON, 100.0, 1.0, 100.0),
    "heston.price_fft": lambda: heston.price_fft(_HESTON, 1.0, 100.0, n_fft=64),
    "HestonCalibrator.calibrate_batch": lambda: HestonCalibrator(
        global_maxiter=1, global_popsize=2, local_max_iter=1).calibrate_batch(*_BOOK),
    "parameter_sensitivities": lambda: parameter_sensitivities(
        _HESTON, [90.0, 110.0], [1.0, 1.0], [True, True], [15.0, 5.0], 100.0, 0.05),
    # the Fourier-priced models: plain numbers take the card
    "bates.price_accurate": lambda: bates.price_accurate(_BATES, 100.0, 1.0, 100.0),
    "bates.to_array": lambda: _BATES.to_array(),
    "svcj.price_carr_madan_gl": lambda: svcj.price_carr_madan_gl(_SVCJ, 100.0, 1.0, 100.0),
    "svcj.mean_jump": lambda: _SVCJ.mean_jump(),
    "term_heston.make_term_params": lambda: term_heston.make_term_params(
        [0.0, 1.0], [2.0], [0.04], [0.3], [-0.7], 0.04),
    "forward_start.price_forward_start": lambda: forward_start.price_forward_start(
        _HESTON, 1.0, 0.5, 1.0),
    "forward_start.price_cliquet_strip": lambda: forward_start.price_cliquet_strip(
        _HESTON, 1.0, n_periods=2),
    "digital.price": lambda: digital.price(_HESTON, 100.0, 1.0, 100.0),
    "digital.price_grouped": lambda: digital.price_grouped(
        _HESTON, [100.0], [0], [1.0], 100.0),
    "varswap.fair_variance_strike": lambda: varswap.fair_variance_strike(_HESTON, 1.0),
    "varswap.fair_volatility_strike": lambda: varswap.fair_volatility_strike(_BATES, 0.5),
    "varswap.strip_variance": lambda: varswap.strip_variance(
        [80.0, 100.0, 120.0], [1.0, 2.0, 1.0], 100.0, 0.5, 0.03),
    "varswap.strip_jump_bias": lambda: varswap.strip_jump_bias(_HESTON),
    "vix.vix_futures": lambda: vix.vix_futures(_HESTON, 0.5),
    "vix.vix_option": lambda: vix.vix_option(_HESTON, 20.0, 0.5),
    "vix.vix_futures_term": lambda: vix.vix_futures_term(_HESTON, [0.1, 0.5]),
    "rough_heston.cf_reduced_rough": lambda: rough_heston.cf_reduced_rough(
        _ROUGH, [0.5], 1.0, n_steps=4),
    "rough_heston.price_rough": lambda: rough_heston.price_rough(
        _ROUGH, [100.0], 1.0, 100.0, n_steps=4),
    "multi_asset.spread_price_quad": lambda: multi_asset.spread_price_quad(
        100.0, 96.0, 5.0, 0.9, 0.25, 0.35, 0.5),
    "multi_asset.rainbow_two_asset_price": lambda: multi_asset.rainbow_two_asset_price(
        100.0, 96.0, 100.0, 0.9, 0.25, 0.35, 0.5),
    "multi_asset.bivariate_norm_cdf": lambda: multi_asset.bivariate_norm_cdf(0.1, 0.2, 0.3),
    "multi_asset.implied_correlation": lambda: multi_asset.implied_correlation(
        5.0, 100.0, 96.0, 5.0, 0.9, 0.25, 0.35),
    "BatesCalibrator": lambda: BatesCalibrator(),
    "BatesCalibrator.generate_synthetic_data": lambda: (
        BatesCalibrator.generate_synthetic_data(n_strikes=3, n_maturities=2)),
    "RoughHestonCalibrator": lambda: RoughHestonCalibrator(),
    "RoughHestonCalibrator.generate_synthetic_surface": lambda: (
        RoughHestonCalibrator.generate_synthetic_surface(n_steps=4)),
    # the rates and credit desk: curves and models built from plain numbers
    # take the card, and every pricer follows its curve
    **{name: (lambda fn=fn: fn(None)) for name, fn in RATES_ENTRY_POINTS.items()},
    **{name: (lambda fn=fn: fn(None)) for name, fn in PIDE_ENTRY_POINTS.items()},
    "rates.bachelier_price": lambda: rates.bachelier_price(0.03, 0.03, 0.0075, 1.0),
    # the Monte Carlo engine: plain numbers take the card
    **{name: (lambda fn=fn: fn(torch.Generator(), None)) for name, fn in MC_ENTRY_POINTS.items()},
    "qmc.gray_codes": lambda: qmc.gray_codes(8),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_needs_the_card(no_card, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_uniform_grid_takes_the_device_it_is_given():
    """uniform_grid has no tensor inputs: device=None means the card, and
    the CPU only when asked for."""
    grid = grids.uniform_grid(0.0, 1.0, 5, dtype=torch.float64, device="cpu")
    assert grid.device.type == "cpu" and grid.dtype == torch.float64
    assert float(grid[-1]) == 1.0


def test_default_device_is_the_first_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert precision.default_device() == torch.device("cuda", 0)
    assert precision.resolve_device(None) == torch.device("cuda", 0)
    assert precision.resolve_device("cpu") == torch.device("cpu")


def test_model_functions_follow_their_inputs(no_card):
    """Plain model functions on tensors keep their inputs' device."""
    p = heston.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04)
    price = heston.price_accurate_gl(p, torch.tensor([100.0]), torch.tensor([1.0]), 100.0)
    assert price.device.type == "cpu"


def test_fourier_models_follow_their_inputs(no_card):
    """The Fourier-priced models on CPU tensors stay on the CPU, as their
    plain-number calls above go to the card."""
    cpu = torch.tensor(1.0, dtype=torch.float64)
    p = bates.BatesParams(*(cpu * v for v in (2.0, 0.04, 0.3, -0.7, 0.04, 0.5, -0.1, 0.15)))
    assert varswap.fair_volatility_strike(p, cpu * 0.5).device.type == "cpu"
    assert vix.vix_futures(p, cpu * 0.5).device.type == "cpu"
    assert digital.price(p, cpu * 100.0, cpu, 100.0).device.type == "cpu"
    r = rough_heston.RoughHestonParams(*(cpu * v for v in (0.1, 2.0, 0.04, 0.3, -0.7, 0.04)))
    assert rough_heston.price_rough(r, cpu * 100.0, cpu, 100.0, n_steps=4).device.type == "cpu"
    assert multi_asset.spread_price_quad(100.0, 96.0, cpu * 5.0, 0.9, 0.25, 0.35,
                                         0.5).device.type == "cpu"
    assert term_heston.make_term_params([0.0, 1.0], cpu[None] * 2.0, [0.04], [0.3], [-0.7],
                                        0.04).kappa.device.type == "cpu"


@pytest.mark.parametrize("name", sorted(RATES_ENTRY_POINTS))
def test_rates_entry_points_run_on_the_cpu_when_asked(no_card, name):
    """The same calls with ``device="cpu"`` compute there."""
    out = RATES_ENTRY_POINTS[name]("cpu")
    assert out.device.type == "cpu"
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("name", sorted(PIDE_ENTRY_POINTS))
def test_pide_entry_points_run_on_the_cpu_when_asked(no_card, name):
    out = PIDE_ENTRY_POINTS[name]("cpu")
    assert out.device.type == "cpu"
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("name", sorted(MC_ENTRY_POINTS))
def test_mc_generator_on_another_device_raises(no_card, name):
    """A CPU generator for a path on the card: ``ValueError`` before any
    tensor is made there."""
    with pytest.raises(ValueError, match="generator is on cpu"):
        MC_ENTRY_POINTS[name](torch.Generator(), "cuda")


@pytest.mark.parametrize("name", sorted(MC_ENTRY_POINTS))
def test_mc_entry_points_run_on_the_cpu_when_asked(no_card, name):
    out = MC_ENTRY_POINTS[name](torch.Generator().manual_seed(0), "cpu")
    first = out if isinstance(out, torch.Tensor) else (
        next(iter(out.values())) if isinstance(out, dict) else out[0])
    assert first.device.type == "cpu"


@pytest.mark.parametrize("name", sorted(BACKTEST_ENTRY_POINTS))
def test_backtest_entry_points_run_on_the_cpu_when_asked(no_card, name):
    out = BACKTEST_ENTRY_POINTS[name]("cpu")
    assert np.all(np.isfinite(np.asarray(out, dtype=float)))

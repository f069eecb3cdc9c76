"""The port's trading system against ``pde_tpu.trading_system``.

Mirrors ``tests/test_system.py``'s ``TestConfig``, ``TestTradingSystem``,
``TestLiveLoop`` and ``TestExitSemantics``: each case runs the reference
(x64) and the port (``device="cpu"``, float64) on the same inputs and
holds the port's order statuses, sides, quantities, fills, positions and
cash equal to the reference's, as well as the reference test's own checks.
Gates: equal, but
- the backtest on the reference's own synthetic bars (its ``jax.random``
  draws): every figure of the results equal (the event engine is a plain
  copy and runs on the host);
- the Monte-Carlo wrapper on JAX's own permutations (``JaxKey``): figures
  within 1e-12 relative (``tests/test_torch_backtest.py``);
- the DataFrame calibration: DE draws differ by design, so both fits meet
  the reference test's bounds and count the same options.
"""

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from jax_key_draws import JaxKey
from pde_tpu import trading_system as ref_ts
from pde_tpu.core import config as ref_config
from pde_tpu_torch import trading_system as port_ts
from pde_tpu_torch.core import config as port_config

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)
PACKAGES = ("ref", "port")


def _config(pkg):
    return (ref_config if pkg == "ref" else port_config).Config()


def _system(pkg, cfg=None):
    cfg = cfg or _config(pkg)
    cfg.database.url = "sqlite://"
    if pkg == "ref":
        return ref_ts.TradingSystem(cfg)
    return port_ts.TradingSystem(cfg, **CPU)


def _both(fn):
    """``fn(pkg)`` for the reference and the port."""
    return [fn(pkg) for pkg in PACKAGES]


def _order_fields(out):
    """A pipeline result without its random order id."""
    return {k: v for k, v in out.items() if k != "order_id"}


class TestConfig:
    def test_defaults(self):
        for cfg in _both(_config):
            assert cfg.trading.initial_capital == 100_000.0
            assert cfg.model.sabr_beta == 0.5
            assert cfg.compute.de_popsize == 15
        ref, port = _both(lambda p: _config(p).to_dict())
        assert port == ref

    @pytest.mark.parametrize("suffix", ["json", "yaml"])
    def test_file_round_trip(self, tmp_path, suffix):
        def save_load(pkg):
            cfg = _config(pkg)
            cfg.env = "production"
            cfg.trading.initial_capital = 5e6
            cfg.model.heston_kappa_bounds = (0.5, 5.0)
            path = str(tmp_path / f"{pkg}.{suffix}")
            cfg.save(path)
            loaded = type(cfg).from_file(path)
            assert loaded.env == "production"
            assert loaded.trading.initial_capital == 5e6
            return open(path).read(), loaded.to_dict()

        ref, port = _both(save_load)
        assert port == ref

    def test_env_overrides_and_precedence(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PDE_INITIAL_CAPITAL", "250000")
        monkeypatch.setenv("PDE_ENV", "staging")
        monkeypatch.setenv("PDE_DEBUG", "true")
        ref, port = _both(lambda p: (ref_config if p == "ref" else port_config).load_config())
        assert port.trading.initial_capital == 250_000.0 and port.env == "staging" and port.debug
        assert port.to_dict() == ref.to_dict()

        def file_then_env(pkg):
            path = str(tmp_path / f"{pkg}.json")
            c = _config(pkg)
            c.trading.initial_capital = 111.0
            c.save(path)
            monkeypatch.setenv("PDE_INITIAL_CAPITAL", "222")
            return (ref_config if pkg == "ref" else port_config).load_config(path).to_dict()

        ref, port = _both(file_then_env)
        assert port == ref and port["trading"]["initial_capital"] == 222.0

    def test_sqlite_path(self):
        for c in _both(_config):
            c.database.url = "sqlite:///x.db"
            assert c.database.sqlite_path == "x.db"
            c.database.url = "sqlite://"
            assert c.database.sqlite_path == ":memory:"


@pytest.fixture
def systems():
    out = _both(_system)
    for s in out:
        status = s.initialize()
        assert all(status.values()), f"degraded init: {status}"
    yield out
    for s in out:
        s.shutdown()


def _signal(pkg, *args):
    if pkg == "ref":
        from pde_tpu.signals.aggregator import AggregatedSignal, AggregatedSignalType
    else:
        from pde_tpu_torch.signals.aggregator import AggregatedSignal, AggregatedSignalType
    asset, kind, conf, support = args
    return AggregatedSignal(asset, getattr(AggregatedSignalType, kind), conf, support, [], "t")


class TestTradingSystem:
    def test_initialize_all_components(self, systems):
        ref, port = systems
        assert sorted(port._components) == sorted(ref._components)
        for name in ("db", "heston_calibrator", "orchestrator", "risk_manager",
                     "broker", "order_manager", "kill_switch"):
            assert port.component(name) is not None
        assert port.component("heston_calibrator").device == torch.device("cpu")

    def test_signal_to_fill_pipeline(self, systems):
        rets = np.random.default_rng(0).normal(0.0005, 0.01, 100)
        outs = [s.process_signal(_signal(pkg, "SPY", "BUY", 0.9, ["vol_arbitrage"]),
                                 current_price=450.0, return_series=rets)
                for pkg, s in zip(PACKAGES, systems)]
        ref, port = (_order_fields(o) for o in outs)
        assert port == ref and port["status"] == "filled"
        positions = [s.component("broker").get_positions() for s in systems]
        assert positions[1] == positions[0] and positions[1]["SPY"] > 0
        cash = [s.component("broker").get_account().cash for s in systems]
        assert cash[1] == cash[0]

    def test_low_confidence_and_halt(self, systems):
        for pkg, s in zip(PACKAGES, systems):
            out = s.process_signal(_signal(pkg, "SPY", "BUY", 0.3, []), 450.0)
            assert out == {"status": "skipped", "reason": "confidence below threshold"}
            s.halt_trading("test halt")
            out = s.process_signal(_signal(pkg, "SPY", "BUY", 0.9, []), 450.0)
            assert out == {"status": "halted", "reason": "kill switch engaged"}

    def test_backtest_wrapper(self, systems):
        from pde_tpu.backtest.data_handler import SyntheticDataHandler

        prices = SyntheticDataHandler(["SPY"], n_bars=300, seed=4).prices
        ref, port = (s.run_backtest(prices, strategy="momentum", lookback=30,
                                    holding_period=10) for s in systems)
        assert port.n_bars == 300
        assert port.summary() == ref.summary()
        assert vars(port).keys() == vars(ref).keys()
        for k, v in vars(ref).items():
            if isinstance(v, (int, float, str)):
                assert getattr(port, k) == v, k
        np.testing.assert_array_equal(np.asarray(port.equity_curve), np.asarray(ref.equity_curve))
        for s in systems:
            with pytest.raises(ValueError):
                s.run_backtest(prices, strategy="nope")

    def test_monte_carlo_wrapper(self, systems):
        rets = np.random.default_rng(1).normal(0.0005, 0.01, 300)
        ref = systems[0].run_monte_carlo(rets, n_simulations=100)
        port = systems[1].run_monte_carlo(rets, n_simulations=100,
                                          generator=JaxKey(jax.random.PRNGKey(0)))
        assert port.n_simulations == ref.n_simulations == 100 and port.method == ref.method
        for k in ("final_equity_mean", "final_equity_std", "prob_loss"):
            np.testing.assert_allclose(getattr(port, k), getattr(ref, k), rtol=1e-12, err_msg=k)
        for k in ("final_equity_percentiles", "max_drawdown_percentiles", "sharpe_percentiles"):
            got, want = getattr(port, k), getattr(ref, k)
            assert got.keys() == want.keys()
            for q in want:
                np.testing.assert_allclose(got[q], want[q], rtol=1e-12, atol=1e-15, err_msg=k)

    def test_status_and_shutdown(self, systems):
        ref, port = (s.get_status() for s in systems)
        assert port["initialized"] and "components" in port
        for st in (ref, port):
            st.pop("time")
        assert port == ref
        systems[1].shutdown()
        assert not systems[1].running

    def test_factory(self):
        s = port_ts.create_trading_system(**CPU)
        assert s.initialized and s.component("ou_fitter").device == torch.device("cpu")
        s.shutdown()


class TestLiveLoop:
    def test_ticks_to_orders_critical_path(self):
        """Stream -> bars -> multi-strategy vote -> risk-gated orders, on
        the same seeded feed: the same bars, orders and positions."""
        def live(pkg):
            if pkg == "ref":
                from pde_tpu.data.streaming import SimulatedStreamProvider
            else:
                from pde_tpu_torch.data.streaming import SimulatedStreamProvider
            system = _system(pkg)
            system.initialize()
            provider = SimulatedStreamProvider(seed=9, vol_per_tick=5e-3,
                                               base_prices={"SPY": 450.0})
            stats = system.run_live(provider, ["SPY"], n_ticks=150, bar_seconds=1e-9,
                                    signal_every_bars=2, lookback=60)
            orders = [(o.symbol, o.side.value, o.quantity, o.status.value, o.avg_fill_price)
                      for o in system.component("order_manager").orders.values()]
            system.shutdown()
            return stats, orders

        (ref, ref_orders), (port, port_orders) = _both(live)
        assert port["bars"]["SPY"] >= 140
        assert port["worst_signal_to_order_s"] < 5.0
        for st in (ref, port):
            st.pop("worst_signal_to_order_s")
        assert port == ref
        assert port_orders == ref_orders

    def test_dataframe_calibration_input(self):
        """The reference's primary input type (pandas DataFrame) works."""
        import pandas as pd

        from pde_tpu.calibrate import HestonCalibrator as RefCalibrator
        from pde_tpu_torch.calibrate import HestonCalibrator

        fits = []
        for cls, where in ((RefCalibrator, {}), (HestonCalibrator, CPU)):
            data = cls.generate_synthetic_data(n_strikes=7, n_maturities=2, as_dataframe=True,
                                               **where)
            assert isinstance(data, pd.DataFrame)
            res = cls(global_maxiter=20, global_popsize=6, **where).calibrate(
                data, S0=100.0, r=0.05, q=0.02)
            assert res.fit_quality["rmse"] < 1.0
            assert 10 <= res.fit_quality["n_options"] <= 14
            fits.append(res.fit_quality["n_options"])
        assert fits[1] == fits[0]


class TestExitSemantics:
    def test_exit_signal_closes_short(self):
        """EXIT while short buys back the held quantity, as the reference."""
        def run(pkg):
            system = _system(pkg)
            system.initialize()
            broker = system.component("broker")
            broker.set_price("SPY", 100.0)
            short = SimpleNamespace(asset="SPY", signal_type="sell", confidence=0.9,
                                    supporting_strategies=["t"])
            first = _order_fields(system.process_signal(short, 100.0))
            held = broker.get_positions().get("SPY", 0.0)
            exit_sig = SimpleNamespace(asset="SPY", signal_type="exit", confidence=0.9,
                                       supporting_strategies=["t"])
            second = _order_fields(system.process_signal(exit_sig, 100.0))
            return first, held, second, broker.get_positions(), broker.get_account().cash

        ref, port = _both(run)
        assert port[1] < 0 and port[2]["side"].lower() == "buy" and port[3].get("SPY", 0.0) == 0.0
        assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)

    def test_exit_without_position_skips(self):
        sig = SimpleNamespace(asset="QQQ", signal_type="exit", confidence=0.9,
                              supporting_strategies=[])

        def run(pkg):
            system = _system(pkg)
            system.initialize()
            return system.process_signal(sig, 300.0)

        ref, port = _both(run)
        assert port == ref and port["status"] == "skipped"

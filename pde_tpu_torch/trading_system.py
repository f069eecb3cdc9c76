"""TradingSystem facade: lazy wiring of all layers + the live pipeline.

Port of ``pde_tpu/trading_system.py``.  ``TradingSystem`` takes the
``device`` (default: the CUDA card) and ``dtype`` (default: torch's
default float) that its calibrators, signals, VaR, Monte Carlo and live
vote run on; the reference's device keep-alive around the live loop, a
remote-TPU measure, has no counterpart.

Mirrors the reference trading_system.py: lazy component init with
degraded-mode tolerance (:96-154), the signal -> risk-check -> size ->
execute pipeline (:177-316), the simple bar-loop backtest (:318-420), the
Monte-Carlo wrapper (:422-464) and status/shutdown (:466-495).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

import numpy as np

from .core.config import Config, load_config, setup_logging

__all__ = ["TradingSystem", "create_trading_system"]


class TradingSystem:
    """One object wiring calibration, signals, risk and execution."""

    def __init__(self, config: Optional[Config] = None, device=None, dtype=None):
        self.config = config or Config()
        self.device = device
        self.dtype = dtype
        setup_logging(self.config.logging)
        self.initialized = False
        self.running = False
        self._components: Dict[str, Any] = {}
        self._halt_reason: Optional[str] = None

    # ---------------------------------------------------------------- init

    def initialize(self) -> Dict[str, bool]:
        """Init each subsystem independently; failures degrade, not abort
        (trading_system.py:96-154)."""
        status: Dict[str, bool] = {}

        def try_init(name, make):
            try:
                self._components[name] = make()
                status[name] = True
            except Exception:  # noqa: BLE001 - degraded init is a feature
                status[name] = False

        from .database import TimeSeriesDB

        try_init("db", lambda: TimeSeriesDB(self.config.database.sqlite_path))

        from .calibrate import HestonCalibrator, OUFitter, SABRCalibrator
        from .calibrate.orchestrator import CalibrationConfig, CalibrationOrchestrator

        db = self._components.get("db")
        where = dict(device=self.device, dtype=self.dtype)
        try_init(
            "heston_calibrator",
            lambda: HestonCalibrator(db=db, bounds=self.config.model.heston_bounds(), **where),
        )
        try_init("sabr_calibrator",
                 lambda: SABRCalibrator(beta=self.config.model.sabr_beta, **where))
        try_init("ou_fitter", lambda: OUFitter(**where))
        try_init(
            "orchestrator",
            lambda: CalibrationOrchestrator(
                config=CalibrationConfig(
                    risk_free_rate=self.config.trading.risk_free_rate,
                    dividend_yield=self.config.trading.dividend_yield,
                ),
                db=db,
                heston_calibrator=self._components.get("heston_calibrator"),
                sabr_calibrator=self._components.get("sabr_calibrator"),
                ou_fitter=self._components.get("ou_fitter"),
                **where,
            ),
        )

        from .signals import MeanReversionSignalGenerator, SignalAggregator, VolSurfaceArbitrageSignal

        try_init("vol_arb_signal", lambda: VolSurfaceArbitrageSignal(**where))
        try_init("mean_rev_signal", MeanReversionSignalGenerator)
        try_init("aggregator", SignalAggregator)

        from .risk import DrawdownController, RiskManager, VolatilityScaledPositionSizer
        from .risk.position_sizer import PositionSizerConfig

        try_init(
            "risk_manager",
            lambda: self._build_risk_manager(RiskManager),
        )
        try_init(
            "position_sizer",
            lambda: VolatilityScaledPositionSizer(
                PositionSizerConfig(
                    max_position_pct=self.config.trading.max_position_pct,
                    max_leverage=self.config.trading.max_portfolio_leverage,
                )
            ),
        )
        try_init(
            "drawdown_controller",
            lambda: DrawdownController(self.config.trading.initial_capital),
        )

        from .execution import OrderManager, SimulatedBroker
        from .execution.emergency import KillSwitch

        try_init("broker", lambda: self._build_broker(SimulatedBroker))
        try_init(
            "order_manager",
            lambda: OrderManager(
                risk_manager=self._components.get("risk_manager"),
                broker=self._components.get("broker"),
            ),
        )
        try_init(
            "kill_switch",
            lambda: KillSwitch(
                order_manager=self._components.get("order_manager"),
                broker=self._components.get("broker"),
            ),
        )

        self.initialized = True
        self.running = True
        return status

    def _build_risk_manager(self, RiskManager):
        rm = RiskManager(total_capital=self.config.trading.initial_capital,
                         risk_free_rate=self.config.trading.risk_free_rate,
                         device=self.device, dtype=self.dtype)
        rm.set_default_limits()
        return rm

    def _build_broker(self, SimulatedBroker):
        b = SimulatedBroker(
            initial_cash=self.config.trading.initial_capital,
            slippage_pct=self.config.trading.slippage_bps / 1e4,
            commission_per_share=self.config.trading.commission_per_share,
        )
        b.connect()
        return b

    def component(self, name: str):
        return self._components.get(name)

    # ------------------------------------------------------------ pipeline

    def process_signal(self, signal, current_price: float, return_series=None) -> Optional[Dict]:
        """signal -> kill-switch gate -> risk check -> size -> execute
        (trading_system.py:177-316)."""
        from .execution.order import Order, OrderSide

        if not self.initialized:
            raise RuntimeError("call initialize() first")
        ks = self._components.get("kill_switch")
        if ks is not None and not ks.check_allowed():
            return {"status": "halted", "reason": "kill switch engaged"}

        if signal.confidence < self.config.trading.min_signal_confidence:
            return {"status": "skipped", "reason": "confidence below threshold"}

        direction = str(getattr(signal, "signal_type", "buy")).lower()
        broker0 = self._components.get("broker")
        held = (broker0.get_positions().get(signal.asset, 0.0)
                if broker0 is not None else 0.0)

        if "exit" in direction or "close" in direction:
            # EXIT closes the open position: side opposite the holding,
            # quantity = what is actually held (a sizer-sized SELL here
            # would INCREASE a short exactly when the strategy said close)
            if abs(held) < 1.0:
                return {"status": "skipped", "reason": "no position to exit"}
            side = OrderSide.SELL if held > 0 else OrderSide.BUY
            quantity = abs(held)
        else:
            sizer = self._components["position_sizer"]
            rets = np.asarray(return_series) if return_series is not None else np.zeros(0)
            dd = self._components["drawdown_controller"].current_drawdown
            sizing = sizer.compute_position_size(rets, self.config.trading.initial_capital, dd)
            quantity = max(sizing.position_size * signal.confidence / current_price, 0.0)
            if quantity < 1:
                return {"status": "skipped", "reason": "size below one share"}
            side = (OrderSide.BUY if "buy" in direction or "long" in direction
                    else OrderSide.SELL)

        order = Order(symbol=signal.asset, side=side, quantity=float(int(quantity)),
                      strategy_id=",".join(getattr(signal, "supporting_strategies", [])) or "system")

        broker = self._components.get("broker")
        if broker is not None:
            broker.set_price(signal.asset, current_price)
        om = self._components["order_manager"]
        om.submit_order(order, reference_price=current_price)

        return {
            "status": order.status.value.lower(),
            "order_id": order.order_id,
            "quantity": order.quantity,
            "side": side.value,
            "avg_fill_price": order.avg_fill_price,
        }

    def halt_trading(self, reason: str = "manual") -> None:
        self._halt_reason = reason
        ks = self._components.get("kill_switch")
        if ks is not None:
            ks.engage(reason)
        self.running = False

    # ------------------------------------------------------------ backtest

    def run_backtest(self, prices: Dict[str, np.ndarray], strategy: str = "ma_crossover",
                     **strategy_params) -> Any:
        """Simple end-to-end backtest (trading_system.py:318-420)."""
        from .backtest import ArrayDataHandler, BacktestEngine, Portfolio
        from .backtest.execution import SimulatedExecutionHandler
        from .backtest.strategy import (
            BuyAndHoldStrategy,
            MeanReversionStrategy,
            MomentumStrategy,
            MovingAverageCrossStrategy,
        )

        strategies = {
            "buy_and_hold": BuyAndHoldStrategy,
            "ma_crossover": MovingAverageCrossStrategy,
            "mean_reversion": MeanReversionStrategy,
            "momentum": MomentumStrategy,
        }
        if strategy not in strategies:
            raise ValueError(f"unknown strategy '{strategy}'; options: {sorted(strategies)}")
        symbols = list(prices)
        strat = strategies[strategy](symbols, **strategy_params)
        engine = BacktestEngine(
            data_handler=ArrayDataHandler(prices),
            strategy=strat,
            portfolio=Portfolio(
                initial_capital=self.config.trading.initial_capital,
                max_position_pct=self.config.trading.max_position_pct,
            ),
            execution_handler=SimulatedExecutionHandler(),
            risk_free_rate=self.config.trading.risk_free_rate,
        )
        return engine.run()

    def run_monte_carlo(self, returns: np.ndarray, **kwargs) -> Any:
        """Monte-Carlo wrapper (trading_system.py:422-464)."""
        from .backtest.analysis import MonteCarloSimulator

        mc = MonteCarloSimulator(
            n_simulations=kwargs.pop("n_simulations", self.config.backtest.monte_carlo_simulations),
            method=kwargs.pop("method", self.config.backtest.bootstrap_method),
            block_size=kwargs.pop("block_size", self.config.backtest.block_size),
            device=self.device,
        )
        return mc.run(np.asarray(returns), **kwargs)

    # ------------------------------------------------------------ live loop

    def run_live(
        self,
        stream_provider,
        symbols: List[str],
        n_ticks: int = 100,
        bar_seconds: float = 60.0,
        signal_every_bars: int = 5,
        lookback: int = 60,
    ) -> Dict[str, Any]:
        """Drive the live critical path: ticks -> bars -> signals -> orders.

        The reference's design target is calibration -> signal -> execution
        under 5 s (design-doc.md:357); this loop implements the stream side
        of it against any DataStreamProvider (the simulated feed in tests).
        Returns loop statistics including the worst signal->fill latency.
        """
        from .backtest.multi_strategy import MultiStrategyManager
        from .data.streaming import StreamManager
        from .execution.order import Order, OrderSide

        if not self.initialized:
            raise RuntimeError("call initialize() first")

        mgr = StreamManager(stream_provider, bar_seconds=bar_seconds)
        voter = MultiStrategyManager(symbols, window=lookback, device=self.device)
        # warm the signal bundle so the first LIVE vote measures
        # steady-state latency, not compilation (the reference's <5 s target
        # is a production figure; compile happens before market open)
        voter.vote(np.full(lookback, 100.0))
        broker = self._components["broker"]
        om = self._components["order_manager"]
        ks = self._components.get("kill_switch")

        history: Dict[str, List[float]] = {s: [] for s in symbols}
        bars_seen = {s: 0 for s in symbols}
        n_orders = 0
        worst_latency = 0.0

        for _ in range(n_ticks):
            stream_provider.step(symbols)
            for s in symbols:
                new_bars = mgr.bars.get(s, [])
                while bars_seen[s] < len(new_bars):
                    bar = new_bars[bars_seen[s]]
                    bars_seen[s] += 1
                    history[s].append(bar.close)
                    broker.set_price(s, bar.close)
                    if len(history[s]) < lookback or bars_seen[s] % signal_every_bars:
                        continue
                    if ks is not None and not ks.check_allowed():
                        continue
                    t0 = time.perf_counter()
                    score = voter.vote(np.asarray(history[s][-lookback:]))
                    side = None
                    if score > 0.25 and broker.get_positions().get(s, 0.0) <= 0:
                        side = OrderSide.BUY
                    elif score < -0.25 and broker.get_positions().get(s, 0.0) >= 0:
                        side = OrderSide.SELL
                    if side is not None:
                        qty = max(
                            int(self.config.trading.initial_capital
                                * self.config.trading.max_position_pct / bar.close),
                            1,
                        )
                        om.submit_order(
                            Order(symbol=s, side=side, quantity=float(qty),
                                  strategy_id="live_multi"),
                            reference_price=bar.close,
                        )
                        n_orders += 1
                    worst_latency = max(worst_latency, time.perf_counter() - t0)

        return {
            "ticks": n_ticks,
            "bars": dict(bars_seen),
            "orders_submitted": n_orders,
            "worst_signal_to_order_s": worst_latency,
            "positions": broker.get_positions(),
        }

    # -------------------------------------------------------------- status

    def get_status(self) -> Dict[str, Any]:
        out = {
            "initialized": self.initialized,
            "running": self.running,
            "halt_reason": self._halt_reason,
            "env": self.config.env,
            "components": sorted(self._components),
            "time": datetime.now(timezone.utc).isoformat(),
        }
        broker = self._components.get("broker")
        if broker is not None:
            out["positions"] = broker.get_positions()
            out["cash"] = broker.get_account().cash
        return out

    def shutdown(self) -> None:
        self.running = False
        db = self._components.get("db")
        if db is not None:
            db.close()


def create_trading_system(config_file: Optional[str] = None, device=None,
                          dtype=None) -> TradingSystem:
    """Factory with layered config (trading_system.py:492-495)."""
    system = TradingSystem(load_config(config_file), device=device, dtype=dtype)
    system.initialize()
    return system

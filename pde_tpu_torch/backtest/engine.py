"""Event-driven backtest engine.

Plain copy of ``pde_tpu/backtest/engine.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference BacktestEngine (backtesting/engine.py:248-558): the
bar loop drains a queue routing MARKET -> portfolio/execution/strategy,
SIGNAL -> portfolio order generation, ORDER -> execution, FILL -> portfolio
(engine.py:256-288), then computes the full results block (Sharpe / Sortino /
Calmar, drawdowns, trade stats, cost analysis).

This loop is intentionally host-side (it is control flow, not math — the
same boundary the reference draws); the array fast path for vectorizable
strategies is pde_tpu_torch.backtest.vectorized.
"""

from __future__ import annotations

import queue
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .data_handler import DataHandler
from .events import EventType
from .execution import ExecutionHandler, SimulatedExecutionHandler
from .metrics import drawdown_stats, equity_to_returns, performance_metrics
from .portfolio import Portfolio
from .strategy import Strategy

__all__ = ["BacktestResults", "BacktestEngine"]


@dataclass
class BacktestResults:
    """Performance report (mirrors engine.py:45-247)."""

    equity_curve: List[Tuple[datetime, float]]
    returns: List[float]
    trade_history: List[Dict[str, Any]]

    total_return_pct: float = 0.0
    annualized_return_pct: float = 0.0
    volatility_pct: float = 0.0
    sharpe_ratio: float = 0.0
    sortino_ratio: float = 0.0
    calmar_ratio: float = 0.0

    max_drawdown_pct: float = 0.0
    avg_drawdown_pct: float = 0.0
    drawdown_duration_days: int = 0
    var_95_pct: float = 0.0
    cvar_95_pct: float = 0.0

    n_trades: int = 0
    n_winning_trades: int = 0
    n_losing_trades: int = 0
    win_rate: float = 0.0
    profit_factor: float = 0.0
    avg_trade_return_pct: float = 0.0
    avg_win_pct: float = 0.0
    avg_loss_pct: float = 0.0
    max_consecutive_wins: int = 0
    max_consecutive_losses: int = 0
    avg_holding_period_days: float = 0.0

    total_commission: float = 0.0
    total_slippage: float = 0.0
    total_costs: float = 0.0
    costs_pct_of_pnl: float = 0.0

    start_date: Optional[datetime] = None
    end_date: Optional[datetime] = None
    n_bars: int = 0
    initial_capital: float = 0.0
    final_equity: float = 0.0

    def summary(self) -> str:
        return (
            f"Backtest {self.start_date} .. {self.end_date} ({self.n_bars} bars)\n"
            f"  capital {self.initial_capital:,.0f} -> {self.final_equity:,.0f} "
            f"({self.total_return_pct:+.2f}%)\n"
            f"  ann return {self.annualized_return_pct:.2f}%  vol {self.volatility_pct:.2f}%  "
            f"sharpe {self.sharpe_ratio:.2f}  sortino {self.sortino_ratio:.2f}  "
            f"calmar {self.calmar_ratio:.2f}\n"
            f"  max dd {self.max_drawdown_pct:.2f}%  var95 {self.var_95_pct:.2f}%\n"
            f"  trades {self.n_trades}  win rate {self.win_rate:.1%}  "
            f"profit factor {self.profit_factor:.2f}\n"
            f"  costs: commission {self.total_commission:,.2f} "
            f"slippage {self.total_slippage:,.2f}"
        )


class BacktestEngine:
    """Queue-mediated event loop (engine.py:248-294)."""

    def __init__(
        self,
        data_handler: DataHandler,
        strategy: Strategy,
        portfolio: Optional[Portfolio] = None,
        execution_handler: Optional[ExecutionHandler] = None,
        risk_free_rate: float = 0.0,
    ):
        self.data_handler = data_handler
        self.strategy = strategy
        self.portfolio = portfolio or Portfolio()
        self.execution_handler = execution_handler or SimulatedExecutionHandler()
        self.risk_free_rate = risk_free_rate
        self.events: "queue.Queue" = queue.Queue()
        self.bar_count = 0

    def run(self) -> BacktestResults:
        while self.data_handler.continue_backtest:
            self.data_handler.update_bars(self.events)
            self.bar_count += 1

            while not self.events.empty():
                event = self.events.get()
                if event.event_type == EventType.MARKET:
                    self.portfolio.update_market_data(event)
                    self.execution_handler.update_market_data(event)
                    # resting limit/stop orders re-check against the new bar
                    if hasattr(self.execution_handler, "process_pending"):
                        self.execution_handler.process_pending(self.events)
                    self.strategy.calculate_signals(event, self.events)
                elif event.event_type == EventType.SIGNAL:
                    self.portfolio.generate_order(event, self.events)
                elif event.event_type == EventType.ORDER:
                    self.execution_handler.execute_order(event, self.events)
                elif event.event_type == EventType.FILL:
                    self.portfolio.update_fill(event)

        return self._calculate_results()

    # ------------------------------------------------------------- results

    def _calculate_results(self) -> BacktestResults:
        curve = self.portfolio.equity_curve
        if len(curve) < 2:
            return BacktestResults(equity_curve=curve, returns=[], trade_history=[])

        equities = [eq for _, eq in curve]
        returns = equity_to_returns(equities)
        perf = performance_metrics(returns, self.risk_free_rate)
        dd = drawdown_stats(equities)
        trade_stats = self._trade_statistics()
        total_commission = self.portfolio.total_commission
        total_slippage = self.portfolio.total_slippage

        return BacktestResults(
            equity_curve=curve,
            returns=returns.tolist(),
            trade_history=[t.__dict__ for t in self.portfolio.trades],
            total_return_pct=perf["total_return_pct"],
            annualized_return_pct=perf["annualized_return_pct"],
            volatility_pct=perf["volatility_pct"],
            sharpe_ratio=perf["sharpe_ratio"],
            sortino_ratio=perf["sortino_ratio"],
            calmar_ratio=perf["calmar_ratio"],
            max_drawdown_pct=dd["max_drawdown_pct"],
            avg_drawdown_pct=dd["avg_drawdown_pct"],
            drawdown_duration_days=dd["drawdown_duration_days"],
            var_95_pct=perf["var_95_pct"],
            cvar_95_pct=perf["cvar_95_pct"],
            **trade_stats,
            start_date=curve[0][0],
            end_date=curve[-1][0],
            n_bars=len(curve),
            initial_capital=self.portfolio.initial_capital,
            final_equity=equities[-1],
            total_commission=total_commission,
            total_slippage=total_slippage,
            total_costs=total_commission + total_slippage,
        )

    def _trade_statistics(self) -> Dict[str, Any]:
        """Win rate / profit factor / streaks (engine.py:430-547)."""
        closed = [t for t in self.portfolio.trades if t.is_closed]
        if not closed:
            return {
                "n_trades": 0, "n_winning_trades": 0, "n_losing_trades": 0,
                "win_rate": 0.0, "profit_factor": 0.0, "avg_trade_return_pct": 0.0,
                "avg_win_pct": 0.0, "avg_loss_pct": 0.0,
                "max_consecutive_wins": 0, "max_consecutive_losses": 0,
                "avg_holding_period_days": 0.0,
            }
        pnls = np.array([t.pnl for t in closed])
        rets = np.array([t.return_pct for t in closed]) * 100.0
        wins = pnls > 0
        gross_win = pnls[wins].sum()
        gross_loss = -pnls[~wins].sum()

        max_w = max_l = cur_w = cur_l = 0
        for w in wins:
            cur_w = cur_w + 1 if w else 0
            cur_l = cur_l + 1 if not w else 0
            max_w, max_l = max(max_w, cur_w), max(max_l, cur_l)

        holding = [
            (t.exit_time - t.entry_time).days
            for t in closed
            if t.exit_time is not None
        ]
        return {
            "n_trades": len(closed),
            "n_winning_trades": int(wins.sum()),
            "n_losing_trades": int((~wins).sum()),
            "win_rate": float(wins.mean()),
            "profit_factor": float(gross_win / gross_loss) if gross_loss > 0 else float("inf"),
            "avg_trade_return_pct": float(rets.mean()),
            "avg_win_pct": float(rets[wins].mean()) if wins.any() else 0.0,
            "avg_loss_pct": float(rets[~wins].mean()) if (~wins).any() else 0.0,
            "max_consecutive_wins": max_w,
            "max_consecutive_losses": max_l,
            "avg_holding_period_days": float(np.mean(holding)) if holding else 0.0,
        }

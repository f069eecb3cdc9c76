"""Backtest portfolio: positions, average-cost PnL, order generation.

Plain copy of ``pde_tpu/backtest/portfolio.py`` (host-side Python, no
numerics of its own): the port keeps its own copy because importing any
module of ``pde_tpu`` imports JAX.

Mirrors the reference backtesting/portfolio.py: Position/Trade records
(:38-165), average-cost-basis buy/sell processing with realized/unrealized
PnL (:286-446), equity/exposure/leverage properties (:224-266),
signal-strength target sizing under a max-position cap (:447-479) and
signal -> order generation (:481-604).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, List, Optional

from .events import Direction, FillEvent, MarketEvent, OrderEvent, OrderType, SignalEvent, SignalType

__all__ = ["Position", "Trade", "Portfolio"]


@dataclass
class Position:
    """Open position with average-cost basis (portfolio.py:38-97)."""

    symbol: str
    quantity: float = 0.0
    avg_price: float = 0.0
    current_price: float = 0.0

    @property
    def market_value(self) -> float:
        return self.quantity * self.current_price

    @property
    def cost_basis(self) -> float:
        return self.quantity * self.avg_price

    @property
    def is_long(self) -> bool:
        return self.quantity > 0

    @property
    def is_short(self) -> bool:
        return self.quantity < 0

    @property
    def unrealized_pnl(self) -> float:
        return (self.current_price - self.avg_price) * self.quantity

    def update_price(self, price: float) -> None:
        self.current_price = price

    def to_dict(self) -> Dict[str, Any]:
        return {
            "symbol": self.symbol,
            "quantity": self.quantity,
            "avg_price": self.avg_price,
            "current_price": self.current_price,
            "market_value": self.market_value,
            "unrealized_pnl": self.unrealized_pnl,
        }


@dataclass
class Trade:
    """Round-trip trade record (portfolio.py:99-165)."""

    symbol: str
    direction: str
    quantity: float
    entry_price: float
    entry_time: datetime
    exit_price: Optional[float] = None
    exit_time: Optional[datetime] = None
    pnl: float = 0.0
    commission: float = 0.0

    @property
    def is_closed(self) -> bool:
        return self.exit_price is not None

    @property
    def return_pct(self) -> float:
        if self.entry_price <= 0 or not self.is_closed:
            return 0.0
        raw = (self.exit_price - self.entry_price) / self.entry_price
        return raw if self.direction == "long" else -raw


class Portfolio:
    """Cash + positions + PnL accounting for the event-driven backtester."""

    def __init__(
        self,
        initial_capital: float = 100_000.0,
        max_position_pct: float = 0.2,
        allow_shorting: bool = True,
    ):
        self.initial_capital = initial_capital
        self.cash = initial_capital
        self.max_position_pct = max_position_pct
        self.allow_shorting = allow_shorting
        self.positions: Dict[str, Position] = {}
        self.current_prices: Dict[str, float] = {}
        self.trades: List[Trade] = []
        self._realized_pnl = 0.0
        self.total_commission = 0.0
        self.total_slippage = 0.0
        self.equity_curve: List[tuple] = []

    # --------------------------------------------------------------- state

    @property
    def equity(self) -> float:
        return self.cash + self.positions_value

    @property
    def positions_value(self) -> float:
        return sum(p.market_value for p in self.positions.values())

    @property
    def unrealized_pnl(self) -> float:
        return sum(p.unrealized_pnl for p in self.positions.values())

    @property
    def realized_pnl(self) -> float:
        return self._realized_pnl

    @property
    def total_pnl(self) -> float:
        return self.realized_pnl + self.unrealized_pnl

    @property
    def gross_exposure(self) -> float:
        return sum(abs(p.market_value) for p in self.positions.values())

    @property
    def net_exposure(self) -> float:
        return self.positions_value

    @property
    def leverage(self) -> float:
        eq = self.equity
        return self.gross_exposure / eq if eq > 0 else 0.0

    def get_position(self, symbol: str) -> float:
        pos = self.positions.get(symbol)
        return pos.quantity if pos else 0.0

    def get_position_value(self, symbol: str) -> float:
        pos = self.positions.get(symbol)
        return pos.market_value if pos else 0.0

    # -------------------------------------------------------------- events

    def update_market_data(self, event: MarketEvent) -> None:
        self.current_prices[event.symbol] = event.price
        if event.symbol in self.positions:
            self.positions[event.symbol].update_price(event.price)
        # one equity point per bar timestamp: multi-symbol backtests emit one
        # MarketEvent per symbol per bar, and per-event points would inflate
        # n_bars (and so every annualized metric) by the symbol count
        if self.equity_curve and self.equity_curve[-1][0] == event.timestamp:
            self.equity_curve[-1] = (event.timestamp, self.equity)
        else:
            self.equity_curve.append((event.timestamp, self.equity))

    def update_fill(self, fill: FillEvent) -> None:
        """Average-cost processing (portfolio.py:286-446)."""
        self.cash -= fill.commission
        self._realized_pnl -= fill.commission
        self.total_commission += fill.commission
        self.total_slippage += fill.slippage
        if fill.direction == Direction.BUY:
            self._process_buy(fill)
        else:
            self._process_sell(fill)

    def _process_buy(self, fill: FillEvent) -> None:
        pos = self.positions.get(fill.symbol)
        qty, px = fill.quantity, fill.fill_price
        self.cash -= qty * px

        if pos is None or pos.quantity == 0:
            self.positions[fill.symbol] = Position(fill.symbol, qty, px, px)
            self.trades.append(Trade(fill.symbol, "long", qty, px, fill.timestamp))
        elif pos.quantity > 0:  # add to long: new average cost
            total = pos.quantity + qty
            pos.avg_price = (pos.cost_basis + qty * px) / total
            pos.quantity = total
            pos.current_price = px
        else:  # covering a short
            cover = min(qty, -pos.quantity)
            realized = (pos.avg_price - px) * cover
            self._realized_pnl += realized
            self._close_trades(fill.symbol, px, fill.timestamp, realized, cover)
            pos.quantity += cover
            pos.current_price = px
            leftover = qty - cover
            if leftover > 0:  # flip to long
                pos.quantity = leftover
                pos.avg_price = px
                self.trades.append(Trade(fill.symbol, "long", leftover, px, fill.timestamp))
            if pos.quantity == 0:
                del self.positions[fill.symbol]

    def _process_sell(self, fill: FillEvent) -> None:
        pos = self.positions.get(fill.symbol)
        qty, px = fill.quantity, fill.fill_price
        self.cash += qty * px

        if pos is None or pos.quantity == 0:
            self.positions[fill.symbol] = Position(fill.symbol, -qty, px, px)
            self.trades.append(Trade(fill.symbol, "short", qty, px, fill.timestamp))
        elif pos.quantity < 0:  # add to short
            total = -pos.quantity + qty
            pos.avg_price = (-pos.cost_basis + qty * px) / total
            pos.quantity = -total
            pos.current_price = px
        else:  # closing a long
            close = min(qty, pos.quantity)
            realized = (px - pos.avg_price) * close
            self._realized_pnl += realized
            self._close_trades(fill.symbol, px, fill.timestamp, realized, close)
            pos.quantity -= close
            pos.current_price = px
            leftover = qty - close
            if leftover > 0:  # flip to short
                pos.quantity = -leftover
                pos.avg_price = px
                self.trades.append(Trade(fill.symbol, "short", leftover, px, fill.timestamp))
            if pos.quantity == 0:
                del self.positions[fill.symbol]

    def _close_trades(self, symbol: str, price: float, ts, realized: float,
                      close_qty: float) -> None:
        """Attribute a realized close of ``close_qty`` units to trade records.

        Partial closes SPLIT the entry: the open record keeps the remaining
        quantity and a closed record is appended for the realized chunk, so
        scaling out of a position books every unit of PnL exactly once.
        """
        remaining = close_qty
        per_unit = realized / close_qty if close_qty else 0.0
        splits = []
        for trade in reversed(self.trades):
            if remaining <= 1e-12:
                break
            if trade.symbol == symbol and not trade.is_closed:
                chunk = min(remaining, trade.quantity)
                if chunk < trade.quantity - 1e-12:
                    trade.quantity -= chunk
                    splits.append(
                        Trade(symbol, trade.direction, chunk,
                              trade.entry_price, trade.entry_time,
                              exit_price=price, exit_time=ts,
                              pnl=per_unit * chunk)
                    )
                else:
                    trade.exit_price = price
                    trade.exit_time = ts
                    trade.pnl = per_unit * chunk
                remaining -= chunk
        self.trades.extend(splits)

    # -------------------------------------------------------------- orders

    def calculate_target_quantity(self, symbol: str, signal: SignalEvent) -> float:
        """Equity-capped, strength-scaled sizing (portfolio.py:447-479)."""
        price = self.current_prices.get(symbol, 0.0)
        if price <= 0:
            return 0.0
        if signal.target_pct is not None:
            return self.equity * signal.target_pct / price
        max_qty = self.equity * self.max_position_pct / price
        return max_qty * signal.strength

    def generate_order(self, signal: SignalEvent, events_queue=None) -> Optional[OrderEvent]:
        """Signal -> market order, respecting current position state
        (portfolio.py:481-604)."""
        symbol = signal.symbol
        current = self.get_position(symbol)
        price = self.current_prices.get(symbol, 0.0)
        if price <= 0:
            return None

        order = None
        st = signal.signal_type

        if st == SignalType.LONG and current <= 0:
            qty = self.calculate_target_quantity(symbol, signal) + max(0.0, -current)
            if qty > 0:
                order = OrderEvent(
                    event_type=None, timestamp=signal.timestamp, symbol=symbol,
                    order_type=OrderType.MARKET, direction=Direction.BUY, quantity=qty,
                )
        elif st == SignalType.SHORT and self.allow_shorting and current >= 0:
            qty = self.calculate_target_quantity(symbol, signal) + max(0.0, current)
            if qty > 0:
                order = OrderEvent(
                    event_type=None, timestamp=signal.timestamp, symbol=symbol,
                    order_type=OrderType.MARKET, direction=Direction.SELL, quantity=qty,
                )
        elif st in (SignalType.EXIT, SignalType.EXIT_LONG) and current > 0:
            order = OrderEvent(
                event_type=None, timestamp=signal.timestamp, symbol=symbol,
                order_type=OrderType.MARKET, direction=Direction.SELL, quantity=current,
            )
        elif st in (SignalType.EXIT, SignalType.EXIT_SHORT) and current < 0:
            order = OrderEvent(
                event_type=None, timestamp=signal.timestamp, symbol=symbol,
                order_type=OrderType.MARKET, direction=Direction.BUY, quantity=-current,
            )

        if order is not None and events_queue is not None:
            events_queue.put(order)
        return order

    # ------------------------------------------------------------- summary

    def get_summary(self) -> Dict[str, Any]:
        closed = [t for t in self.trades if t.is_closed]
        wins = [t for t in closed if t.pnl > 0]
        return {
            "equity": self.equity,
            "cash": self.cash,
            "realized_pnl": self.realized_pnl,
            "unrealized_pnl": self.unrealized_pnl,
            "n_trades": len(closed),
            "win_rate": len(wins) / len(closed) if closed else 0.0,
            "gross_exposure": self.gross_exposure,
            "leverage": self.leverage,
        }

"""Structured logging: context binding, JSON formatting, domain loggers.

Plain copy of ``pde_tpu/monitoring/logging.py`` (host-side Python, no
numerics of its own): the port keeps its own copy because importing any
module of ``pde_tpu`` imports JAX.

Mirrors the reference monitoring/logging.py: bound-context structured
loggers (:52-300), JSON and console formatters (:301-450), rotating file
handlers, error grouping (:600-770) and the Trading/Risk/Audit domain
loggers (:777-981).
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import threading
import traceback
from collections import Counter
from datetime import datetime, timezone
from typing import Any, Dict, Optional

__all__ = [
    "JSONFormatter",
    "StructuredLogger",
    "configure_logging",
    "get_logger",
    "ErrorGrouper",
    "TradingLogger",
    "RiskLogger",
    "AuditLogger",
]

_CONTEXT = threading.local()


class JSONFormatter(logging.Formatter):
    """One JSON object per line (logging.py:301-380)."""

    def format(self, record: logging.LogRecord) -> str:
        payload: Dict[str, Any] = {
            "time": datetime.fromtimestamp(record.created, tz=timezone.utc).isoformat(),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            payload["exception"] = "".join(traceback.format_exception(*record.exc_info))
        payload.update(getattr(record, "context", {}) or {})
        extra = getattr(record, "fields", None)
        if extra:
            payload.update(extra)
        return json.dumps(payload, default=str)


class StructuredLogger:
    """Logger with bind()-able context (logging.py:52-300)."""

    def __init__(self, logger: logging.Logger, context: Optional[Dict[str, Any]] = None):
        self._logger = logger
        self._context = dict(context or {})

    def bind(self, **fields) -> "StructuredLogger":
        return StructuredLogger(self._logger, {**self._context, **fields})

    def _log(self, level: int, message: str, **fields) -> None:
        self._logger.log(level, message, extra={"context": self._context, "fields": fields})

    def debug(self, message: str, **fields):
        self._log(logging.DEBUG, message, **fields)

    def info(self, message: str, **fields):
        self._log(logging.INFO, message, **fields)

    def warning(self, message: str, **fields):
        self._log(logging.WARNING, message, **fields)

    def error(self, message: str, **fields):
        self._log(logging.ERROR, message, **fields)

    def critical(self, message: str, **fields):
        self._log(logging.CRITICAL, message, **fields)


def configure_logging(
    level: str = "INFO",
    json_format: bool = True,
    log_file: Optional[str] = None,
    max_bytes: int = 50 * 1024 * 1024,
    backup_count: int = 5,
) -> None:
    """Root configuration (logging.py:777-850): console (+ optional rotating
    file) with JSON or plain formatting."""
    root = logging.getLogger("pde_tpu_torch")
    root.setLevel(getattr(logging, level.upper()))
    root.handlers.clear()

    formatter = (
        JSONFormatter()
        if json_format
        else logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
    )
    console = logging.StreamHandler()
    console.setFormatter(formatter)
    root.addHandler(console)

    if log_file:
        fh = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=max_bytes, backupCount=backup_count
        )
        fh.setFormatter(JSONFormatter())
        root.addHandler(fh)


def get_logger(name: str, **context) -> StructuredLogger:
    return StructuredLogger(logging.getLogger(f"pde_tpu_torch.{name}"), context)


class ErrorGrouper:
    """Fingerprint-based error aggregation (logging.py:600-770)."""

    def __init__(self):
        self._counts: Counter = Counter()
        self._samples: Dict[str, str] = {}

    @staticmethod
    def fingerprint(exc: BaseException) -> str:
        tb = traceback.extract_tb(exc.__traceback__)
        location = f"{tb[-1].filename}:{tb[-1].lineno}" if tb else "?"
        return f"{type(exc).__name__}@{location}"

    def record(self, exc: BaseException) -> str:
        fp = self.fingerprint(exc)
        self._counts[fp] += 1
        self._samples.setdefault(fp, str(exc))
        return fp

    def top(self, n: int = 10):
        return [
            {"fingerprint": fp, "count": c, "sample": self._samples[fp]}
            for fp, c in self._counts.most_common(n)
        ]


class TradingLogger(StructuredLogger):
    """Domain logger for order flow (logging.py:860-920)."""

    def __init__(self, **context):
        super().__init__(logging.getLogger("pde_tpu_torch.trading"), context)

    def order_submitted(self, order_id: str, symbol: str, side: str, quantity: float):
        self.info("order_submitted", order_id=order_id, symbol=symbol, side=side, quantity=quantity)

    def order_filled(self, order_id: str, price: float, quantity: float):
        self.info("order_filled", order_id=order_id, price=price, quantity=quantity)

    def order_rejected(self, order_id: str, reason: str):
        self.warning("order_rejected", order_id=order_id, reason=reason)


class RiskLogger(StructuredLogger):
    """Domain logger for risk events (logging.py:921-950)."""

    def __init__(self, **context):
        super().__init__(logging.getLogger("pde_tpu_torch.risk"), context)

    def limit_breach(self, limit: str, value: float, threshold: float):
        self.error("limit_breach", limit=limit, value=value, threshold=threshold)

    def drawdown(self, current: float, level: str):
        self.warning("drawdown", current=current, level=level)


class AuditLogger(StructuredLogger):
    """Immutable-intent audit events (logging.py:951-981)."""

    def __init__(self, **context):
        super().__init__(logging.getLogger("pde_tpu_torch.audit"), context)

    def event(self, action: str, actor: str = "system", **fields):
        self.info("audit", action=action, actor=actor, **fields)

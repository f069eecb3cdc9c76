"""Request-schema validation for the market-data HTTP service (HTTP-layer

Plain copy of ``pde_tpu/data/request_schema.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.
twin of the market-data QUALITY validators in .validation).

The reference validates every route's inputs with pydantic models and
returns structured 422 responses (reference data/api.py:365-599, FastAPI's
RequestValidationError contract).  This build keeps the service
framework-thin (aiohttp), so the same contract is provided by small
hand-rolled validators: every malformed input raises
:class:`RequestValidationError` carrying FastAPI-shaped error items
(``{"loc": [...], "msg": ..., "type": ...}``), and the service middleware
turns that into a 422 JSON body — bad requests never reach the provider
layer as 500s.
"""

from __future__ import annotations

import re
from datetime import date, timedelta
from typing import Any, List, Optional, Tuple

__all__ = [
    "RequestValidationError",
    "parse_symbol",
    "parse_date_param",
    "parse_date_range",
    "parse_symbols_body",
]

# market symbols: letters/digits with the usual separators (BRK.B, BTC-USD)
_SYMBOL_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,15}$")
MAX_BATCH_SYMBOLS = 100
MAX_RANGE_DAYS = 3660  # ~10 years per request, the reference's cap spirit


class RequestValidationError(Exception):
    """Carries FastAPI-shaped error items for the 422 response body."""

    def __init__(self, errors: List[dict]):
        super().__init__(str(errors))
        self.errors = errors

    @classmethod
    def single(cls, loc: List[str], msg: str, type_: str = "value_error"):
        return cls([{"loc": loc, "msg": msg, "type": type_}])


def parse_symbol(value: str, loc_name: str = "symbol") -> str:
    value = (value or "").strip()
    if not _SYMBOL_RE.match(value):
        raise RequestValidationError.single(
            ["path", loc_name],
            "symbol must be 1-16 characters of letters, digits, '.', '_' "
            "or '-'",
        )
    return value.upper()


def parse_date_param(
    raw: Optional[str], loc_name: str, default: Optional[date] = None
) -> Optional[date]:
    if raw is None or raw == "":
        return default
    try:
        return date.fromisoformat(raw)
    except ValueError:
        raise RequestValidationError.single(
            ["query", loc_name],
            f"invalid date {raw!r}: expected ISO format YYYY-MM-DD",
            "value_error.date",
        ) from None


def parse_date_range(
    start_raw: Optional[str],
    end_raw: Optional[str],
    default_span_days: int,
    loc: str = "query",
) -> Tuple[date, date]:
    """(start, end) with defaults (end = today, start = end - span), order
    and span checked."""
    errors: List[dict] = []
    end = start = None
    try:
        end = parse_date_param(end_raw, "end", date.today())
    except RequestValidationError as exc:
        errors.extend(exc.errors)
    try:
        start = parse_date_param(
            start_raw, "start",
            (end or date.today()) - timedelta(days=default_span_days),
        )
    except RequestValidationError as exc:
        errors.extend(exc.errors)
    if errors:
        raise RequestValidationError(errors)
    if start > end:
        raise RequestValidationError.single(
            [loc, "start"], f"start {start} is after end {end}"
        )
    if (end - start).days > MAX_RANGE_DAYS:
        raise RequestValidationError.single(
            [loc, "start"],
            f"range spans {(end - start).days} days; max {MAX_RANGE_DAYS}",
        )
    return start, end


def parse_symbols_body(body: Any) -> List[str]:
    """Validate a ``{"symbols": [...], ...}`` batch body."""
    if not isinstance(body, dict):
        raise RequestValidationError.single(
            ["body"], "body must be a JSON object", "type_error.dict"
        )
    symbols = body.get("symbols")
    if not isinstance(symbols, list) or not symbols:
        raise RequestValidationError.single(
            ["body", "symbols"], "symbols must be a non-empty list",
            "type_error.list",
        )
    if len(symbols) > MAX_BATCH_SYMBOLS:
        raise RequestValidationError.single(
            ["body", "symbols"],
            f"{len(symbols)} symbols; max {MAX_BATCH_SYMBOLS} per batch",
        )
    out = []
    errors: List[dict] = []
    for i, s in enumerate(symbols):
        if not isinstance(s, str) or not _SYMBOL_RE.match(s.strip()):
            errors.append({
                "loc": ["body", "symbols", i],
                "msg": f"invalid symbol {s!r}",
                "type": "value_error",
            })
        else:
            out.append(s.strip().upper())
    if errors:
        raise RequestValidationError(errors)
    return out

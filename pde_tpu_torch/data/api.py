"""Market-data HTTP service.

Plain copy of ``pde_tpu/data/api.py`` (host-side Python, no numerics
of its own): the port keeps its own copy because importing any module of
``pde_tpu`` imports JAX.

Mirrors the reference data/api.py: a REST service exposing /health, /quotes,
/bars, /bars/batch, /options/{underlying}, /options/{underlying}/expirations,
/securities and /calendar (:365-618).  The reference uses FastAPI/uvicorn;
this build uses aiohttp (present in the image) with the same route shapes
and JSON schemas — the service layer is deliberately framework-thin.
"""

from __future__ import annotations

import json
from datetime import date, datetime, timedelta
from typing import List, Optional

from aiohttp import web

from .providers import DataProvider, SimulatedDataProvider
from .reference import ReferenceDataManager
from .request_schema import (RequestValidationError, parse_date_param,
                             parse_date_range, parse_symbol,
                             parse_symbols_body)

__all__ = ["DataService", "create_data_api", "run_server"]


class DataService:
    """Business logic behind the routes (data/api.py:162-364)."""

    def __init__(
        self,
        provider: Optional[DataProvider] = None,
        reference: Optional[ReferenceDataManager] = None,
        db=None,
    ):
        self.provider = provider or SimulatedDataProvider()
        self.reference = reference or ReferenceDataManager()
        self.db = db

    def health(self) -> dict:
        out = {"status": "ok", "provider": self.provider.name}
        if self.db is not None:
            out["database"] = self.db.health_check()
        return out

    def quote(self, symbol: str) -> dict:
        q = self.provider.get_quote(symbol)
        return {"symbol": q.symbol, "bid": q.bid, "ask": q.ask, "last": q.last,
                "mid": q.mid, "time": q.time.isoformat()}

    def bars(self, symbol: str, start: date, end: date) -> List[dict]:
        return [
            {"time": b.time.isoformat(), "open": b.open, "high": b.high,
             "low": b.low, "close": b.close, "volume": b.volume}
            for b in self.provider.get_bars(symbol, start, end)
        ]

    def options(self, underlying: str, expiration: Optional[date] = None) -> List[dict]:
        chain = self.provider.get_options_chain(underlying, expiration)
        return [
            {**row, "expiration": str(row["expiration"])} for row in chain
        ]

    def expirations(self, underlying: str) -> List[str]:
        chain = self.provider.get_options_chain(underlying)
        return sorted({str(row["expiration"]) for row in chain})

    def securities(self) -> List[dict]:
        return [s.__dict__ for s in self.reference.list_securities()]

    def calendar(self, start: date, end: date) -> List[str]:
        return [d.isoformat() for d in self.reference.calendar.trading_days_between(start, end)]


@web.middleware
async def _validation_middleware(request, handler):
    """Schema-validation contract (reference data/api.py validates every
    route with pydantic): malformed input -> 422 with FastAPI-shaped
    ``detail`` items, malformed JSON -> 400 — never a 500.  Also feeds the
    per-route request-latency histogram (reference api_latency)."""
    import time

    from ..monitoring.metrics import api_latency

    route = (request.match_info.route.resource.canonical
             if request.match_info.route.resource else request.path)
    t0 = time.perf_counter()
    try:
        return await handler(request)
    except RequestValidationError as exc:
        return web.json_response({"detail": exc.errors}, status=422)
    except json.JSONDecodeError:
        return web.json_response(
            {"detail": [{"loc": ["body"], "msg": "invalid JSON body",
                         "type": "value_error.json"}]},
            status=400,
        )
    finally:
        api_latency.labels(route=route).observe(time.perf_counter() - t0)


def create_data_api(service: Optional[DataService] = None) -> web.Application:
    """Build the aiohttp application (route parity with data/api.py:365-599,
    including its request-schema validation: bad symbols/dates/bodies get
    structured 4xx responses, not provider errors)."""
    svc = service or DataService()
    app = web.Application(middlewares=[_validation_middleware])

    async def health(request):
        return web.json_response(svc.health())

    async def quote(request):
        symbol = parse_symbol(request.match_info["symbol"])
        try:
            return web.json_response(svc.quote(symbol))
        except Exception as exc:  # noqa: BLE001
            return web.json_response({"error": str(exc)}, status=502)

    async def bars(request):
        symbol = parse_symbol(request.match_info["symbol"])
        start, end = parse_date_range(
            request.query.get("start"), request.query.get("end"),
            default_span_days=365,
        )
        try:
            return web.json_response({"symbol": symbol, "bars": svc.bars(symbol, start, end)})
        except Exception as exc:  # noqa: BLE001
            return web.json_response({"error": str(exc)}, status=502)

    async def bars_batch(request):
        body = await request.json()
        symbols = parse_symbols_body(body)
        start, end = parse_date_range(
            body.get("start"), body.get("end"), default_span_days=365,
            loc="body",
        )
        out = {}
        for s in symbols:
            try:
                out[s] = svc.bars(s, start, end)
            except Exception as exc:  # noqa: BLE001
                out[s] = {"error": str(exc)}
        return web.json_response(out)

    async def options(request):
        u = parse_symbol(request.match_info["underlying"], "underlying")
        expiration = parse_date_param(
            request.query.get("expiration"), "expiration")
        return web.json_response({"underlying": u, "chain": svc.options(u, expiration)})

    async def expirations(request):
        u = parse_symbol(request.match_info["underlying"], "underlying")
        return web.json_response({"underlying": u, "expirations": svc.expirations(u)})

    async def securities(request):
        return web.json_response({"securities": svc.securities()})

    async def calendar(request):
        start, end = parse_date_range(
            request.query.get("start"), request.query.get("end"),
            default_span_days=30,
        )
        return web.json_response({"trading_days": svc.calendar(start, end)})

    async def metrics(request):
        """Prometheus scrape endpoint (the compose/k8s stacks target it)."""
        from ..monitoring import metrics as m

        if not m.PROMETHEUS_AVAILABLE:
            return web.Response(text="# prometheus_client not installed\n",
                                content_type="text/plain")
        from prometheus_client import generate_latest

        return web.Response(body=generate_latest(m.REGISTRY),
                            content_type="text/plain")

    app.router.add_get("/metrics", metrics)
    app.router.add_get("/health", health)
    app.router.add_get("/quotes/{symbol}", quote)
    app.router.add_get("/bars/{symbol}", bars)
    app.router.add_post("/bars/batch", bars_batch)
    app.router.add_get("/options/{underlying}", options)
    app.router.add_get("/options/{underlying}/expirations", expirations)
    app.router.add_get("/securities", securities)
    app.router.add_get("/calendar", calendar)
    return app


def run_server(host: str = "0.0.0.0", port: int = 8080, service: Optional[DataService] = None):
    """Blocking server entrypoint (data/api.py:600-618)."""
    web.run_app(create_data_api(service), host=host, port=port)

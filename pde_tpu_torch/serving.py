"""Low-latency option-pricing service with dynamic micro-batching (twin of
``pde_tpu/serving.py``).

Callers price in-process in the reference's C++ (the OpenMP batch loop,
src/cpp/models/heston.cpp:236-244): each caller pays the full quadrature
for its own handful of quotes.  On the card one batched pricer amortizes
dispatch and the characteristic function across ALL concurrent callers,
so the serving design is a **micro-batching front end**:

1. Callers submit :class:`PricingRequest`s and receive futures.
2. A single dispatch thread coalesces the queue into micro-batches
   (``max_batch`` requests or ``max_wait_ms``, whichever first).
3. Batches are padded to a small set of **shape buckets**.
4. Each request carries its own Heston parameter vector, so one batch can
   mix underlyings, maturities, calls/puts, and even models-per-desk.

The core (:class:`BatchPricer`, :class:`MicroBatchingServer`) is
transport-agnostic and testable in-process; :func:`create_pricing_api`
wraps it in an aiohttp application (``aiohttp`` is imported only there,
and in :func:`run_server`).  Greeks are reverse-mode (:meth:`BatchPricer._price`).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from .core.precision import default_float, resolve_device
from .models import heston

__all__ = [
    "PricingRequest",
    "PricingResult",
    "BatchPricer",
    "MicroBatchingServer",
    "create_pricing_api",
]

_DEFAULT_BUCKETS = (8, 32, 128, 512, 2048)


@dataclass(frozen=True)
class PricingRequest:
    """One option quote to price under per-request Heston parameters.

    ``params`` is (kappa, theta, sigma, rho, v0) — the caller (typically a
    signal or risk service holding the day's calibration per underlying)
    supplies it, so a single micro-batch can span underlyings.
    """

    strike: float
    maturity: float
    spot: float
    params: Sequence[float]
    rate: float = 0.0
    dividend: float = 0.0
    is_call: bool = True
    want_greeks: bool = False


@dataclass(frozen=True)
class PricingResult:
    price: float
    delta: Optional[float] = None
    vega: Optional[float] = None

    def to_dict(self) -> dict:
        out = {"price": self.price}
        if self.delta is not None:
            out["delta"] = self.delta
        if self.vega is not None:
            out["vega"] = self.vega
        return out


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class BatchPricer:
    """Shape-bucketed batched Heston pricer (device math, no threads).

    Every request in a batch carries its own parameter vector, priced by
    the corrected Gauss-Legendre Carr-Madan rule
    (:func:`~pde_tpu_torch.models.heston.price_carr_madan_gl`, reference
    semantics src/cpp/models/heston.cpp:94-151) over the request axis: the
    parameter fields are (B, 1) columns against the pricer's
    (B, n_points + 6) integrand.  ``device`` (default: the CUDA card) and
    ``dtype`` (default: torch's default float) set where and in which
    precision batches are priced.  The buckets keep the set of batch
    shapes small, as they keep the reference's compiled programs few.
    """

    def __init__(self, buckets: Sequence[int] = _DEFAULT_BUCKETS,
                 n_points: int = 64, device=None,
                 dtype: Optional[torch.dtype] = None):
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.n_points = int(n_points)
        self.device = resolve_device(device)
        self.dtype = dtype or default_float()

    # -- device math ----------------------------------------------------------
    def _price(self, cols: torch.Tensor, greeks: bool) -> torch.Tensor:
        """Prices (B,) of a padded (B, 11) batch, or with ``greeks`` the
        (3, B) stack of price, delta and vega: reverse mode, dV/dS and
        dV/dv0 of the summed prices (each price depends on its own row
        only), vega = dV/dv0 * 2 sqrt(max(v0, 1e-12)), the market
        convention the reference reports (src/cpp/solvers/
        heston_pde.hpp:544-559).  Forward mode would not do here: its
        levels are per process, and the server prices on its own thread."""
        params = heston.HestonParams(*(cols[:, i:i + 1] for i in range(5)))
        strike, maturity, spot, rate, dividend, is_call = cols[:, 5:].unbind(1)

        def price(p, s):
            return heston.price_carr_madan_gl(p, strike, maturity, s, rate, dividend,
                                              is_call, n_points=self.n_points)

        if not greeks:
            return price(params, spot)
        spot = spot.detach().requires_grad_(True)
        v0 = params.v0.detach().requires_grad_(True)
        with torch.enable_grad():
            value = price(params._replace(v0=v0), spot)
            delta, dv0 = torch.autograd.grad(value.sum(), (spot, v0))
        vega = dv0[:, 0] * 2.0 * torch.sqrt(torch.clamp_min(v0.detach()[:, 0], 1e-12))
        return torch.stack([value.detach(), delta, vega])

    def warmup(self, greeks: bool = True) -> None:
        """Run every bucket once up front (serving should never pay a first-
        request setup)."""
        import dataclasses

        for b in self.buckets:
            req = PricingRequest(100.0, 1.0, 100.0, (2.0, 0.04, 0.3, -0.7, 0.04))
            self.price([req] * b)
            if greeks:
                self.price([dataclasses.replace(req, want_greeks=True)] * b)

    # -- public -------------------------------------------------------------
    @staticmethod
    def validate(r: PricingRequest) -> None:
        """Reject malformed requests up front.  JAX clamps out-of-range
        gathers instead of raising, so a short parameter vector would
        otherwise price silently wrong — the one failure mode a pricing
        service must never have."""
        p = np.asarray(r.params, dtype=np.float64)
        if p.shape != (5,):
            raise ValueError(
                f"params must be 5 values (kappa, theta, sigma, rho, v0), "
                f"got shape {p.shape}"
            )
        fields = (r.strike, r.maturity, r.spot, r.rate, r.dividend)
        if not (np.all(np.isfinite(p)) and np.all(np.isfinite(fields))):
            raise ValueError("non-finite value in pricing request")
        if r.strike <= 0 or r.spot <= 0:
            raise ValueError("strike and spot must be positive")

    def price(self, requests: List[PricingRequest]) -> List[PricingResult]:
        """Price a batch synchronously (launch + finalize)."""
        return self.finalize(self.price_async(requests))

    def price_async(self, requests: List[PricingRequest]):
        """Launch a batch on the device WITHOUT blocking.

        The card's launches are asynchronous: the returned handle holds the
        device tensor whose computation is in flight, and :meth:`finalize`
        makes the one host read and builds the results.  The batch goes to
        the device as one padded (bucket, 11) array in one copy."""
        if not requests:
            return (requests, None, False)
        for r in requests:
            self.validate(r)
        n = len(requests)
        b = _bucket_for(n, self.buckets)
        rows = np.empty((b, 11), dtype=np.float64)
        for i, r in enumerate(requests):
            rows[i, :5] = r.params
            rows[i, 5:] = (r.strike, r.maturity, r.spot, r.rate, r.dividend,
                           bool(r.is_call))
        rows[n:] = rows[n - 1]  # repeat-last padding: always finite
        cols = torch.from_numpy(rows).to(device=self.device, dtype=self.dtype)
        any_greeks = any(r.want_greeks for r in requests)
        return (requests, self._price(cols, any_greeks), any_greeks)

    @staticmethod
    def finalize(handle) -> List[PricingResult]:
        """Block on a :meth:`price_async` handle (one device-to-host copy)
        and build the results."""
        requests, out_dev, greeks = handle
        if out_dev is None:
            return []
        n = len(requests)
        out = out_dev.cpu().numpy()
        if not greeks:
            return [PricingResult(float(p)) for p in out[:n]]
        prices, gd, gv = out[:, :n]
        return [PricingResult(float(prices[i]), float(gd[i]), float(gv[i]))
                if r.want_greeks else PricingResult(float(prices[i]))
                for i, r in enumerate(requests)]


@dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0
    errors: int = 0
    batch_sizes: List[int] = field(default_factory=list)

    @property
    def mean_batch(self) -> float:
        return (sum(self.batch_sizes) / len(self.batch_sizes)
                if self.batch_sizes else 0.0)

    def to_dict(self) -> dict:
        return {
            "requests": self.requests,
            "batches": self.batches,
            "errors": self.errors,
            "mean_batch_size": round(self.mean_batch, 2),
        }


class MicroBatchingServer:
    """Queue + dispatch thread turning concurrent callers into micro-batches.

    ``submit`` is thread-safe and returns a ``concurrent.futures.Future`` of
    a :class:`PricingResult`.  The dispatch loop collects up to ``max_batch``
    requests or waits at most ``max_wait_ms`` past the first request of a
    batch — the classic latency/throughput knob of serving systems.
    """

    def __init__(self, pricer: Optional[BatchPricer] = None,
                 max_batch: int = 2048, max_wait_ms: float = 2.0):
        self.pricer = pricer or BatchPricer()
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.stats = ServerStats()
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._running = False

    # -- lifecycle ----------------------------------------------------------
    def start(self, warmup: bool = False) -> "MicroBatchingServer":
        if warmup:
            self.pricer.warmup()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pricing-dispatch")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        # fail any stragglers rather than hanging their callers
        while True:
            try:
                _, fut = self._queue.get_nowait()
            except queue.Empty:
                break
            fut.set_exception(RuntimeError("pricing server stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client API ----------------------------------------------------------
    def submit(self, request: PricingRequest) -> "Future[PricingResult]":
        if not self._running:
            raise RuntimeError("server not started")
        fut: "Future[PricingResult]" = Future()
        self._queue.put((request, fut))
        return fut

    def price(self, request: PricingRequest,
              timeout: Optional[float] = 30.0) -> PricingResult:
        return self.submit(request).result(timeout=timeout)

    # -- dispatch loop --------------------------------------------------------
    def _drain_batch(self):
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        """One dispatch thread, deliberately synchronous.

        While ``pricer.price`` blocks on the device, arrivals pile up in the
        queue and the next drain takes them all — batch size self-adjusts to
        one client wave per device round-trip with no extra machinery.
        With closed-loop callers a two-stage pipeline (launch thread +
        completion thread around ``price_async``/``finalize``) splits each
        wave into cohorts and halves the batch, and throughput is bounded by
        n_clients / round-trip either way.  Open-loop callers
        that want overlap can drive ``price_async`` directly."""
        while self._running:
            batch = self._drain_batch()
            if not batch:
                continue
            requests = [r for r, _ in batch]
            futures = [f for _, f in batch]
            try:
                results = self.pricer.price(requests)
            except Exception as exc:  # noqa: BLE001 — a bad batch must not
                # kill the dispatch thread; every caller sees the error
                self.stats.errors += len(batch)
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(exc)
                continue
            for fut, res in zip(futures, results):
                fut.set_result(res)
            self.stats.requests += len(batch)
            self.stats.batches += 1
            self.stats.batch_sizes.append(len(batch))


_PRICING_SERVER_KEY = None


def pricing_server_key():
    """The aiohttp AppKey under which :func:`create_pricing_api` stores the
    server (lazy: aiohttp is an optional dependency)."""
    global _PRICING_SERVER_KEY
    from aiohttp import web

    if _PRICING_SERVER_KEY is None:
        _PRICING_SERVER_KEY = web.AppKey(
            "pricing_server", MicroBatchingServer
        )
    return _PRICING_SERVER_KEY


def create_pricing_api(server: Optional[MicroBatchingServer] = None):
    """aiohttp application exposing the micro-batching pricer.

    Routes (style-matched to the data service, pde_tpu/data/api.py):
      POST /price   {"requests": [{strike, maturity, spot, params, ...}]}
      GET  /stats   dispatch statistics
      GET  /health  liveness
    """
    from aiohttp import web

    srv = server or MicroBatchingServer().start()

    async def price(request):
        import asyncio

        try:
            body = await request.json()
            reqs = [
                PricingRequest(
                    strike=float(r["strike"]),
                    maturity=float(r["maturity"]),
                    spot=float(r["spot"]),
                    params=[float(x) for x in r["params"]],
                    rate=float(r.get("rate", 0.0)),
                    dividend=float(r.get("dividend", 0.0)),
                    is_call=bool(r.get("is_call", True)),
                    want_greeks=bool(r.get("want_greeks", False)),
                )
                for r in body["requests"]
            ]
        except (KeyError, TypeError, ValueError) as exc:
            return web.json_response({"error": f"bad request: {exc}"},
                                     status=400)
        futs = [srv.submit(r) for r in reqs]
        loop = asyncio.get_event_loop()
        results = await asyncio.gather(
            *[loop.run_in_executor(None, f.result, 30.0) for f in futs]
        )
        return web.json_response({"results": [r.to_dict() for r in results]})

    async def stats(request):
        return web.json_response(srv.stats.to_dict())

    async def health(request):
        return web.json_response({"status": "ok",
                                  "running": srv._running})

    app = web.Application()
    app.router.add_post("/price", price)
    app.router.add_get("/stats", stats)
    app.router.add_get("/health", health)
    app[pricing_server_key()] = srv
    return app


def run_server(host: str = "0.0.0.0", port: int = 8081,
               max_wait_ms: Optional[float] = None) -> None:
    """Serve the micro-batching pricer on the card.  Every bucket is priced
    once before the socket opens, so the first caller pays no setup."""
    import os

    from aiohttp import web

    wait = (float(os.environ.get("PDE_PRICING_MAX_WAIT_MS", 2.0))
            if max_wait_ms is None else max_wait_ms)
    srv = MicroBatchingServer(max_wait_ms=wait).start(warmup=True)
    try:
        web.run_app(create_pricing_api(srv), host=host, port=port)
    finally:
        srv.stop()

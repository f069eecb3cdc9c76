"""Long-running service entrypoints backing the deploy layer.

`python -m pde_tpu_torch.services [--device DEVICE] <calibration|signals|
execution|data-ingestion>` runs the port's twin of the JAX package's
service loops (``pde_tpu/services.py``), which the per-service Dockerfiles
run (deploy/docker/Dockerfile.*).  Note
the reference's Dockerfiles point at ``quant_trading.*.service`` modules
that do not exist in its tree (deploy/docker/Dockerfile.calibration:35);
these are real, tested equivalents.

Each service is a :class:`ServiceLoop`: run one iteration, sleep the
configured interval, exit cleanly on SIGTERM/SIGINT (K8s sends SIGTERM on
pod shutdown), and keep serving through iteration failures (counted, logged,
alertable via the metrics registry) — a calibration hiccup must not
crash-loop the pod.

Environment knobs (all optional):
  PDE_SYMBOLS                     comma-separated universe (default SPY,QQQ)
  PDE_SERVICE_INTERVAL_S          loop interval override (per-service defaults below)
  PDE_DATA_PROVIDER               provider name for data.providers.create_provider
  PDE_DB_PATH                     sqlite path (default from core config)

The numerics run on the port: the calibration pass on its
``CalibrationOrchestrator``, the signal pass on its ``OUFitter``, the
execution chunk on its trading system, the simulated provider's chain on
its Black-Scholes.  Every step takes ``device`` and ``dtype`` and hands them
on; ``device=None`` is the card (``core/precision.default_device``), so a
step never runs quietly on the CPU.  ``main`` takes ``--device`` before the
service name, as ``pde_tpu_torch.cli`` does.  No environment knob is added.
"""

from __future__ import annotations

import functools
import os
import signal
import sys
import time
from typing import Callable, List, Optional

from .core.precision import default_float, resolve_device

__all__ = ["ServiceLoop", "main"]

_DEFAULT_INTERVALS = {
    "calibration": 86_400.0,  # daily (reference orchestrator cadence)
    "signals": 300.0,
    "data-ingestion": 900.0,
    "execution": 60.0,  # run_live session chunks
}


def _symbols() -> List[str]:
    return [s.strip() for s in os.environ.get("PDE_SYMBOLS", "SPY,QQQ").split(",") if s.strip()]


def _provider(device=None, dtype=None):
    from .data.providers import create_provider

    name = os.environ.get("PDE_DATA_PROVIDER", "simulated")
    # only the simulated provider prices on a device
    where = dict(device=resolve_device(device), dtype=dtype) if name == "simulated" else {}
    return create_provider(name, **where)


def _db():
    from .core.config import load_config
    from .database.db import TimeSeriesDB

    path = os.environ.get("PDE_DB_PATH") or load_config().database.sqlite_path
    return TimeSeriesDB(path)


class ServiceLoop:
    """Iterate ``step`` every ``interval_s`` until SIGTERM/SIGINT.

    ``max_iterations`` bounds the loop for tests (None = forever).
    Failures are logged and counted; the loop keeps going.
    """

    def __init__(
        self,
        name: str,
        step: Callable[[], object],
        interval_s: float,
        max_iterations: Optional[int] = None,
    ):
        self.name = name
        self.step = step
        self.interval_s = interval_s
        self.max_iterations = max_iterations
        self.iterations = 0
        self.failures = 0
        self._stop = False

    def _handle_signal(self, signum, frame):  # noqa: ARG002
        self._stop = True

    def stop(self) -> None:
        self._stop = True

    def run(self) -> int:
        from .monitoring.logging import get_logger

        log = get_logger(f"pde_tpu_torch.services.{self.name}")
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, self._handle_signal)
            except ValueError:
                pass  # not the main thread (tests)
        log.info("service starting", extra={"interval_s": self.interval_s})
        while not self._stop:
            t0 = time.time()
            try:
                result = self.step()
                log.info(
                    "iteration ok",
                    extra={"n": self.iterations, "elapsed_s": round(time.time() - t0, 3),
                           "result": str(result)[:200]},
                )
            except Exception as exc:  # noqa: BLE001 — service must keep serving
                self.failures += 1
                log.error(
                    "iteration failed",
                    extra={"n": self.iterations, "failures": self.failures, "error": repr(exc)},
                )
            self.iterations += 1
            if self.max_iterations is not None and self.iterations >= self.max_iterations:
                break
            # sleep in 1 s slices so SIGTERM is honored promptly
            deadline = time.time() + self.interval_s
            while not self._stop and time.time() < deadline:
                time.sleep(min(1.0, max(0.0, deadline - time.time())))
        log.info("service stopped", extra={"iterations": self.iterations, "failures": self.failures})
        return 0 if self.failures < self.iterations or self.iterations == 0 else 1


# ---------------------------------------------------------------- services


def _chain_to_market_options(chain, S0):
    """Provider options-chain rows -> the calibrator's input schema.

    Quotes outside 0.5-2.0 moneyness are dropped: far-from-money chains
    carry bid/ask noise, not calibration signal (the reference gates its
    chain the same way before model comparison,
    signals/vol_surface_arbitrage.py:317-341; count capping happens later
    in the orchestrator's _filter_options).
    """
    from datetime import date

    import numpy as np

    today = date.today()
    strikes, mats, mids, kinds = [], [], [], []
    for row in chain:
        T = max((row["expiration"] - today).days, 1) / 365.0
        mid = 0.5 * (row["bid"] + row["ask"])
        if mid <= 0:
            continue
        if S0 > 0 and not (0.5 <= row["strike"] / S0 <= 2.0):
            continue
        strikes.append(row["strike"])
        mats.append(T)
        mids.append(mid)
        kinds.append(row.get("option_type", "call"))
    return {
        "strike": np.asarray(strikes),
        "maturity": np.asarray(mats),
        "mid_price": np.asarray(mids),
        "option_type": kinds,
    }


def calibration_step(provider=None, db=None, symbols=None, device=None, dtype=None):
    """One daily-calibration pass over the universe (the card's workload)."""
    from .calibrate.orchestrator import CalibrationOrchestrator

    provider = provider or _provider(device, dtype)
    db = db or _db()
    orch = CalibrationOrchestrator(db=db, device=device, dtype=dtype)
    statuses = {}
    for sym in symbols or _symbols():
        S0 = float(provider.get_quote(sym).last)
        chain = provider.get_options_chain(sym)
        options = _chain_to_market_options(chain, S0)
        res = orch.run_daily_calibration(sym, options, S0)
        statuses[sym] = res.status.name if hasattr(res.status, "name") else str(res.status)
    return statuses


def signals_step(provider=None, db=None, symbols=None, device=None, dtype=None):
    """OU scan + mean-reversion signal pass; signals persist to the DB."""
    import numpy as np

    from .calibrate import OUFitter
    from datetime import date, timedelta

    provider = provider or _provider(device, dtype)
    db = db or _db()
    fitter = OUFitter(device=device, dtype=dtype)
    end = date.today()
    out = {}
    for sym in symbols or _symbols():
        bars = provider.get_bars(sym, end - timedelta(days=365), end)
        closes = np.asarray([b.close for b in bars], dtype=float)
        if len(closes) < 50:
            out[sym] = "insufficient_data"
            continue
        res = fitter.fit(np.log(closes))
        hl_days = float(res.params.half_life()) * 252.0
        candidate = bool(res.success and 5.0 <= hl_days <= 120.0)
        if candidate:
            db.store_signal(
                asset=sym, strategy="mean_reversion", signal_type="candidate",
                confidence=min(1.0, 30.0 / hl_days),
                payload={"mu": float(res.params.mu), "half_life_days": hl_days},
            )
        out[sym] = "candidate" if candidate else "no_signal"
    return out


def ingestion_step(provider=None, db=None, symbols=None, device=None, dtype=None):
    """Incremental bar ingestion: resume each symbol from its last row."""
    from .data.ingestion import DataIngestionPipeline, IncrementalIngestion

    provider = provider or _provider(device, dtype)
    db = db or _db()
    inc = IncrementalIngestion(DataIngestionPipeline(provider, db))
    results = inc.ingest(symbols or _symbols())
    return {s: r.status.name if hasattr(r.status, "name") else str(r.status)
            for s, r in results.items()}


def execution_step(symbols=None, n_ticks: int = 200, device=None, dtype=None):
    """One live-session chunk: ticks -> bars -> signals -> orders."""
    from .data.streaming import SimulatedStreamProvider
    from .trading_system import create_trading_system

    syms = symbols or _symbols()
    system = create_trading_system(device=resolve_device(device), dtype=dtype)
    system.initialize()
    stream = SimulatedStreamProvider(base_prices={s: 100.0 for s in syms})
    stats = system.run_live(stream, syms, n_ticks=n_ticks)
    return {k: stats[k] for k in ("orders_submitted", "worst_signal_to_order_s") if k in stats}


_STEPS = {
    "calibration": calibration_step,
    "signals": signals_step,
    "data-ingestion": ingestion_step,
    "execution": execution_step,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = None
    if argv[:1] == ["--device"] and len(argv) >= 2:
        device, argv = argv[1], argv[2:]
    if not argv or argv[0] not in _STEPS:
        print(f"usage: python -m pde_tpu_torch.services [--device DEVICE] "
              f"{{{'|'.join(_STEPS)}}}", file=sys.stderr)
        return 2
    name = argv[0]
    # the card unless --device names another device; raises without one
    step = functools.partial(_STEPS[name], device=resolve_device(device), dtype=default_float())
    interval = float(os.environ.get("PDE_SERVICE_INTERVAL_S", _DEFAULT_INTERVALS[name]))
    max_iter = int(os.environ["PDE_SERVICE_MAX_ITERATIONS"]) if "PDE_SERVICE_MAX_ITERATIONS" in os.environ else None
    return ServiceLoop(name, step, interval, max_iterations=max_iter).run()


if __name__ == "__main__":
    raise SystemExit(main())

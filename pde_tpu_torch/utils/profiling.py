"""Timing and trace capture on the card (twin of ``pde_tpu/utils/profiling.py``).

* :func:`time_jitted` — the first call (lazy CUDA initialisation and the
  build of a hand-written kernel at its first use, the counterpart of a
  jit's compile) timed apart from the warm calls, each of which is timed
  between two device synchronizations; the median of the warm calls.
* :class:`DeviceTimer` — named sections that synchronize the device when
  they end, so a section's time includes the work it queued.
* :func:`trace` — a ``torch.profiler`` capture of the block, CPU and CUDA
  activity, written as a Chrome trace (Perfetto, ``chrome://tracing``).

A CPU-only run synchronizes nothing: its calls finish when they return.
The reference's ``device_keepalive`` and its transfer-forced timing kept a
TPU reached over a network tunnel awake; a local card needs neither, and
the port has no such code.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch

__all__ = ["DeviceTimer", "time_jitted", "trace", "Timings"]


@dataclass
class Timings:
    """First-call / warm-call split of a callable."""

    compile_s: float
    median_run_s: float
    runs_s: List[float] = field(default_factory=list)

    @property
    def per_second(self) -> float:
        return 1.0 / self.median_run_s if self.median_run_s > 0 else float("inf")


def _sync() -> None:
    """Wait for the work queued on the current card, if CUDA is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_jitted(fn: Callable, *args, n_runs: int = 10, **kwargs) -> Timings:
    """Time ``fn(*args, **kwargs)``: the first call apart (``compile_s``),
    then ``n_runs`` warm calls, each between two synchronizations
    (``runs_s``), and their median (``median_run_s``)."""
    _sync()
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    _sync()
    compile_s = time.perf_counter() - t0
    runs = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        runs.append(time.perf_counter() - t0)
    return Timings(compile_s=compile_s, median_run_s=statistics.median(runs), runs_s=runs)


class DeviceTimer:
    """Accumulating section timer with device synchronization.

    >>> timer = DeviceTimer()
    >>> with timer("pricing"):
    ...     prices = price_fn(params)
    >>> timer.report()
    """

    def __init__(self):
        self.sections: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        _sync()  # the work queued before the section is not its own
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.sections.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, times in self.sections.items():
            s = sorted(times)
            out[name] = {
                "n": len(s),
                "total_s": sum(s),
                "median_s": s[len(s) // 2],
                "max_s": s[-1],
            }
        return out


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA when the card
    is there) and write ``trace.json``, a Chrome trace, into ``log_dir``
    (default: ``pde_tpu_torch_trace`` in the temporary directory).  Yields
    the directory."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "pde_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

"""Timing and trace capture on the card (twin of ``pde_tpu/utils/profiling.py``).

* :func:`time_jitted` — the first call (lazy CUDA initialisation and the
  build of a hand-written kernel at its first use, the counterpart of a
  jit's compile) timed apart from the warm calls, each of which is timed
  between two device synchronizations; the median of the warm calls.
* :func:`span` — a named span of the program in the profiler's trace,
  ``pde_tpu_torch.<module>.<phase>``, on the same clock as the device's
  operations; with no profiler on it only checks that none is.
* :func:`trace` — a ``torch.profiler`` capture of the block, CPU and CUDA
  activity, written as a Chrome trace (Perfetto, ``chrome://tracing``),
  the program's spans among its events.

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
from typing import Callable, List

import torch
from torch.profiler import record_function

__all__ = ["span", "time_jitted", "trace", "Timings"]

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


@dataclass
class Timings:
    """First-call / warm-call split of a callable."""

    compile_s: float
    median_run_s: float
    runs_s: List[float] = field(default_factory=list)

    @property
    def per_second(self) -> float:
        return 1.0 / self.median_run_s if self.median_run_s > 0 else float("inf")


def span(name: str):
    """A context manager that marks the block as the span ``name`` in the
    trace of a profiler that is on (``torch.profiler.record_function``:
    a span's parent is the span open around it), and does nothing but one
    check when none is, so the hot paths carry their spans always.  It
    never synchronizes the device and keeps no record of its own."""
    if _profiler_enabled():
        return record_function(name)
    return _OFF


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

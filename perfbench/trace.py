"""The traced run: ``torch.profiler`` over the measured window, read back
from its Chrome trace into intervals on one clock (microseconds).

The harness marks the window (``perfbench.window``) and each timed call
(``perfbench.call``) with ``record_function``; the device's work is the
trace's kernels, copies and sets.  Nothing here reads the program's own
state: a metric reads a :class:`TraceView`.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass

from .stats import gaps, union_length

WINDOW, CALL = "perfbench.window", "perfbench.call"
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"})


@dataclass(frozen=True)
class Span:
    name: str
    start: float
    end: float

    @property
    def dur(self) -> float:
        return self.end - self.start


class TraceView:
    """The window's device intervals, the harness's call spans and the
    host's operations, in microseconds on the trace's clock."""

    def __init__(self, events: list[dict]):
        device, host, calls, window = [], [], [], None
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            span = Span(e.get("name", ""), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                device.append((cat, span))
            elif cat == "user_annotation" and span.name == WINDOW:
                window = span
            elif cat == "user_annotation" and span.name == CALL:
                calls.append(span)
            elif cat in HOST_CATS:
                host.append(span)
        if window is None:
            raise ValueError(f"the trace holds no {WINDOW!r} span")
        self.window = window
        inside = lambda s: s.end > window.start and s.start < window.end  # noqa: E731
        self.device = [s for _, s in device if inside(s)]
        self.kernels = [s for c, s in device if c == "kernel" and inside(s)]
        self.calls = sorted(calls, key=lambda s: s.start)
        self.host = [s for s in host + calls if inside(s)]
        self._by_name: dict = {}

    # -- whole window ------------------------------------------------------
    @property
    def window_us(self) -> float:
        return self.window.dur

    def busy_us(self, lo=None, hi=None, without: str | None = None) -> float:
        """Time in [lo, hi] (default: the window) in which any operation
        ran on the device; ``without`` leaves out the operations whose name
        holds it."""
        lo = self.window.start if lo is None else lo
        hi = self.window.end if hi is None else hi
        spans, starts, reach = self._sorted(without)
        # spans before i all end by lo, spans from j on start at hi or later
        i, j = bisect.bisect_right(reach, lo), bisect.bisect_left(starts, hi)
        return union_length(spans[i:j], lo, hi)

    def _sorted(self, without):
        """The device's (start, end) intervals sorted, their starts, and
        the running maximum of their ends (read once a ``without``: a
        traced window holds some 10^5 operations, read once a call)."""
        if without not in self._by_name:
            spans = sorted((s.start, s.end) for s in self.device
                           if without is None or without not in s.name)
            reach = list(itertools.accumulate((e for _, e in spans), max))
            self._by_name[without] = (spans, [a for a, _ in spans], reach)
        return self._by_name[without]

    def kernels_named(self, fragment: str) -> list[Span]:
        return [k for k in self.kernels if fragment in k.name]

    # -- per call ----------------------------------------------------------
    def call_of(self, t: float):
        """Index of the call span holding time ``t``, or None."""
        lo, hi = 0, len(self.calls) - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            c = self.calls[mid]
            if t < c.start:
                hi = mid - 1
            elif t >= c.end:
                lo = mid + 1
            else:
                return mid
        return None

    # -- breakdown ---------------------------------------------------------
    def top_device_ops(self, n: int = 10) -> list[list]:
        """The device operations that took the most time: [name, seconds]."""
        total = defaultdict(float)
        for s in self.device:
            total[s.name] += s.dur
        return [[name, us * 1e-6] for name, us in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The device's idle time in the window by what the host was doing
        in the middle of each idle stretch (the innermost host operation
        open then, or the harness between calls): [name, seconds], the
        longest first."""
        host = sorted(self.host, key=lambda s: s.start)
        starts = [s.start for s in host]
        total = defaultdict(float)
        for lo, hi in gaps([(s.start, s.end) for s in self.device],
                           self.window.start, self.window.end):
            mid, name = 0.5 * (lo + hi), "(between calls)"
            k = bisect.bisect_right(starts, mid)
            # the innermost open operation: the latest started still open
            for s in reversed(host[max(0, k - 64):k]):
                if s.end > mid:
                    name = s.name
                    break
            total[name] += hi - lo
        return [[name, us * 1e-6] for name, us in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def profiled(enabled: bool):
    """Profile the block on the host and the card when ``enabled``; yields
    a one-item list that holds the :class:`TraceView` once the block ends."""
    box: list = []
    if not enabled:
        yield box
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield box
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    del prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    box.append(TraceView(events))

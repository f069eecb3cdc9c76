"""The traced run's device work and device idle put down to the program's
own spans.

The port marks the phases of its benchmarked paths with spans named
``pde_tpu_torch.<module>.<phase>`` (``pde_tpu_torch.utils.profiling.span``,
a ``record_function`` when a profiler is on).  They are in the trace among
the host's operations (``TraceView.host``), on the device's clock, and so
are the host's launch calls.  This module reads the :class:`TraceView` as
it stands:

1. The device's operations (kernels, copies, sets) in start order are
   matched one to one with the host's launch calls in start order
   (``cudaLaunchKernel*``, ``cuLaunchKernel*``, ``cudaMemcpy*``,
   ``cudaMemset*``; a launch inside another launch, a ``cuLaunchKernel``
   inside a ``cudaLaunchKernel``, is the same launch), call by call: each
   of the harness's calls takes as many operations as it made launches,
   the next in order, and the kinds (kernel, copy, set) must agree one by
   one.  The device's clock drifts from the host's in the trace (by up
   to 0.05 ms in a 10 s window on an H100, then it jumps back), so an
   operation's call is its launch's, never read from its own time.  A
   call whose kinds do not line up, at the next operation or a few either
   side (:data:`OFFSETS`), is left out and counted (``unmatched_calls``);
   with more than :data:`MAX_UNMATCHED` of the calls left out, a metric
   that rests on the matching reads None.  Each matched operation belongs
   to the program spans open at its launch, the innermost last.  This
   assumes one device operation per launch call: a CUDA graph's launch
   would need this module extended.
2. Each idle stretch of the window ends where the host launched the next
   operation; it is put on the host's clock by that operation's offset
   and split by overlap among the innermost program spans open during it.
   What no program span covers is the harness's (:data:`HARNESS`).

A trace without program spans (a program that has none) reads None.
"""

from __future__ import annotations

import bisect
import functools
import math
from collections import defaultdict
from dataclasses import dataclass

from .stats import gaps, union_length

PREFIX = "pde_tpu_torch."
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")
MAX_UNMATCHED = 0.05
OFFSETS = (0, -1, 1, -2, 2, -3, 3)   # realignments tried where a call's kinds differ
HARNESS = "harness"


@dataclass(frozen=True)
class Op:
    """A device operation of a matched call and the program spans open at
    its launch, outermost first (empty: the harness launched it)."""
    start: float
    end: float
    kind: str          # "kernel", "copy" or "set"
    stack: tuple

    @property
    def owner(self) -> str:
        return self.stack[-1] if self.stack else HARNESS


@dataclass
class Reading:
    calls: int                 # the traced calls
    matched: list              # each matched call: (call span, [Op])
    idle_us: dict              # innermost span (or HARNESS) -> idle µs in the window
    host_us: dict              # span name -> its host µs in the window
    names: frozenset           # the program spans' names

    @property
    def unmatched(self) -> int:
        return self.calls - len(self.matched)

    @property
    def sound(self) -> bool:
        return bool(self.matched) and self.unmatched <= MAX_UNMATCHED * self.calls

    def device_ms(self, keep) -> float:
        """Device time a matched call of the operations ``keep(op)`` takes:
        the union of their intervals, as ``busy_us`` reads it."""
        total = sum(union_length([(o.start, o.end) for o in ops if keep(o)], -math.inf, math.inf)
                    for _, ops in self.matched)
        return total / len(self.matched) * 1e-3

    def count(self, keep) -> float:
        """Operations ``keep(op)`` a matched call."""
        return sum(sum(1 for o in ops if keep(o)) for _, ops in self.matched) / len(self.matched)

    def count_by_owner(self, keep) -> dict:
        """Operations ``keep(op)`` a matched call by the innermost span that
        launched them."""
        out = defaultdict(int)
        for _, ops in self.matched:
            for o in ops:
                if keep(o):
                    out[o.owner] += 1
        return {name: n / len(self.matched) for name, n in sorted(out.items())}

    def by_owner_ms(self) -> dict:
        """Device time a matched call by the innermost span that launched it."""
        owners = {o.owner for _, ops in self.matched for o in ops}
        return {name: self.device_ms(lambda o, n=name: o.owner == n) for name in sorted(owners)}

    def host_ms(self, name: str) -> float:
        """Host time a traced call inside the spans called ``name``."""
        return self.host_us.get(name, 0.0) / self.calls * 1e-3

    def unsound(self) -> dict:
        return {"value": None, "unmatched_calls": self.unmatched, "calls": self.calls}


def reading(run) -> Reading | None:
    """The run's trace read once (the metrics of one run share it); None
    without a trace, without calls or without program spans."""
    view = getattr(run, "trace", None)
    if view is None or not view.calls:
        return None
    return read(view)


@functools.lru_cache(maxsize=1)
def read(view) -> Reading | None:
    program = [s for s in view.host if s.name.startswith(PREFIX)]
    if not program:
        return None
    pieces = segments(program)
    starts = [p[0] for p in pieces]

    def stack_at(t):
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and pieces[k][0] <= t < pieces[k][1]:
            return pieces[k][2]
        return ()

    launches = launch_calls(view.host)
    l_starts = [s.start for s in launches]
    want = [launch_kind(s.name) for s in launches]
    kernels = {id(s) for s in view.kernels}
    device = sorted(view.device, key=lambda s: s.start)
    kinds = [kind(d, kernels) for d in device]
    shift = [None] * len(device)      # host clock less device clock, at each matched op
    matched, lag = [], 0     # launches less device operations ahead of the call
    for c in view.calls:
        a, b = bisect.bisect_left(l_starts, c.start), bisect.bisect_left(l_starts, c.end)
        q = next((a - lag + o for o in OFFSETS
                  if 0 <= a - lag + o and kinds[a - lag + o:b - lag + o] == want[a:b]), None)
        if q is None:
            continue
        lag = a - q
        ops = []
        for i, launch in enumerate(launches[a:b], q):
            d = device[i]
            shift[i] = launch.start - d.start
            ops.append(Op(d.start, d.end, kinds[i], stack_at(launch.start)))
        matched.append((c, ops))

    # an idle stretch ends where the host launched the next operation: put
    # it on the host's clock by that operation's shift (the last stretch,
    # or one before an unmatched operation, by the stretch before it)
    d_starts, stretches = [d.start for d in device], []
    delta = next((v for v in shift if v is not None), 0.0)
    for lo, hi in gaps([(d.start, d.end) for d in device], view.window.start, view.window.end):
        j = bisect.bisect_left(d_starts, hi)
        if j < len(device) and shift[j] is not None:
            delta = shift[j]
        stretches.append((lo + delta, hi + delta))
    host = defaultdict(float)
    for s in program:
        host[s.name] += s.dur
    return Reading(len(view.calls), matched, split(stretches, pieces), dict(host),
                   frozenset(s.name for s in program))


def kind(span, kernels) -> str:
    if id(span) in kernels:
        return "kernel"
    return "set" if span.name.startswith("Memset") else "copy"


def launch_kind(name: str) -> str:
    if name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
        return "kernel"
    return "set" if name.startswith("cudaMemset") else "copy"


def launch_calls(host) -> list:
    """The host's launch calls in start order, a call nested in another
    (a ``cuLaunchKernel`` inside a ``cudaLaunchKernel``) dropped."""
    out = []
    for s in sorted((s for s in host if s.name.startswith(LAUNCHES)),
                    key=lambda s: (s.start, -s.end)):
        if out and s.start < out[-1].end:
            continue
        out.append(s)
    return out


def segments(spans) -> list:
    """The host's time cut into pieces ``(start, end, stack)`` in order,
    ``stack`` the names of the program spans open, outermost first; time
    outside every span is in no piece.  The spans nest (one thread); a
    span that runs past its parent by the trace's rounding is cut there."""
    out, stack, cur = [], [], None

    def advance(to):
        nonlocal cur
        if stack and to > cur:
            out.append((cur, to, tuple(n for n, _ in stack)))
        cur = to

    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1][1] <= s.start:
            advance(stack[-1][1])
            stack.pop()
        advance(s.start)
        stack.append((s.name, min(s.end, stack[-1][1]) if stack else s.end))
    while stack:
        advance(stack[-1][1])
        stack.pop()
    return out


def split(stretches, pieces) -> dict:
    """µs of the ``(lo, hi)`` stretches by the innermost span of the pieces
    they overlap; the rest under :data:`HARNESS`."""
    out = defaultdict(float)
    k = 0
    for lo, hi in sorted(stretches):
        covered = 0.0
        while k < len(pieces) and pieces[k][1] <= lo:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < hi:
            a, b, stack = pieces[j]
            part = min(b, hi) - max(a, lo)
            if part > 0:
                out[stack[-1]] += part
                covered += part
            j += 1
        out[HARNESS] += (hi - lo) - covered
    return dict(out)


def phase(run, suffix: str):
    """A metric of the device time a call of the operations launched under
    the spans whose name ends in ``suffix``, with their launches and host
    time in its notes."""
    r = reading(run)
    names = {n for n in r.names if n.endswith(suffix)} if r else ()
    if not names:
        return None
    if not r.sound:
        return r.unsound()
    under = lambda o: any(n in names for n in o.stack)  # noqa: E731
    return {"value": r.device_ms(under), "unmatched_calls": r.unmatched,
            "launches": r.count(under), "host_ms": sum(r.host_ms(n) for n in names),
            "device_ms_by_span": r.by_owner_ms()}

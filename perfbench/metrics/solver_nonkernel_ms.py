"""Milliseconds of device time a call outside the march kernel: in each
traced call, the time in which a kernel, copy or set other than the cell's
march kernel ran on the card, averaged over the calls.  That is the
solver's band build and readout and the copy of the results to the host,
read from the device's trace alone (the host's share of a call is not in
it)."""

import importlib


def read(run):
    if run.trace is None or not run.trace.calls or run.kernel is None:
        return None
    t = run.trace
    fragment = importlib.import_module(f"perfbench.counts.{run.kernel}").KERNEL
    if not t.kernels_named(fragment):
        return None
    return sum(t.busy_us(c.start, c.end, without=fragment) for c in t.calls) / len(t.calls) * 1e-3

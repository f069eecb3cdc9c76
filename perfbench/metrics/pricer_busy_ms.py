"""Milliseconds a call in which an operation ran on the card, over the
traced calls: the device time of the Fourier pricer's kernels and the
copy of the prices to the host."""


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    t = run.trace
    busy = sum(t.busy_us(c.start, c.end) for c in t.calls)
    return busy / len(t.calls) * 1e-3

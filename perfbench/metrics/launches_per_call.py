"""Kernels launched on the card a timed call: every kernel of the traced
window over the calls in it."""


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    return len(run.trace.kernels) / len(run.trace.calls)

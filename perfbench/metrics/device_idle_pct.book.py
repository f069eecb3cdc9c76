"""Share of the traced window in which no operation (kernel, copy or set)
ran on the card, in percent."""


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    return 100.0 * (1.0 - t.busy_us() / t.window_us)

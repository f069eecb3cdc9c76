"""The 95th percentile of a call's latency over every call of the window
(the host's clock, from the call to its results on the host), in
milliseconds."""

import statistics


def read(run):
    if len(run.latencies_ms) < 2:
        return None
    return statistics.quantiles(run.latencies_ms, n=20, method="inclusive")[18]

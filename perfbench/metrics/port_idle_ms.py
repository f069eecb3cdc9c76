"""Device idle a call, in milliseconds, while the host was inside the
program's spans: each idle stretch of the window split by overlap among
the innermost spans open during it, over the traced calls
(:mod:`perfbench.spans`).  Notes: the idle by span, the harness's apart;
together they are ``device_idle_pct.book`` of the window over the calls."""

from perfbench import spans


def read(run):
    r = spans.reading(run)
    if r is None:
        return None
    by_span = {name: us / r.calls * 1e-3 for name, us in sorted(r.idle_us.items())}
    return {"value": sum(ms for name, ms in by_span.items() if name != spans.HARNESS),
            "idle_ms_by_span": by_span}

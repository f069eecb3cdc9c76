"""A kernel's share of its roofline from a traced run: the least time the
card could take for one book's march (``counts/<kernel>.py`` on the cell's
shapes, over the H100's published peaks) over the kernel's mean device time
a launch, in percent.

The reader of the metric ``<kernel>_roofline`` is one line,
``read = rooflines.reader(__name__)``: the kernel is the metric's name, and
``counts/<kernel>.py`` counts its work."""

from __future__ import annotations

import importlib

from .peaks import bound_s


def share(run, kernel: str):
    """``{"value": percent, "binds": "flops" or "bytes", "bound_s": ...}``
    for the kernel ``counts/<kernel>.py`` counts, or None where the trace
    holds no launch of it.  A launch marches one book of the cell."""
    if run.trace is None:
        return None
    counts = importlib.import_module(f"perfbench.counts.{kernel}")
    launches = run.trace.kernels_named(counts.KERNEL)
    if not launches:
        return None
    mean_s = sum(k.dur for k in launches) / len(launches) * 1e-6
    t, binds = bound_s(counts.flops(run.shapes), counts.bytes_moved(run.shapes))
    return {"value": 100.0 * t / mean_s, "binds": binds, "bound_s": t, "kernel_s": mean_s,
            "launches": len(launches)}


def reader(module_name: str):
    """The ``read`` of the metric module ``module_name``
    (``perfbench.metrics.<kernel>_roofline``)."""
    kernel = module_name.rsplit(".", 1)[-1].removesuffix("_roofline")
    return lambda run: share(run, kernel)

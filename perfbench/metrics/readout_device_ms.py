"""Device time a call, in milliseconds, of the operations the solver
launched under its readout of price and Greeks (the span
``pde_tpu_torch.<solver>.readout``), read as ``bands_device_ms`` reads
the band build's (:mod:`perfbench.spans`)."""

from perfbench import spans


def read(run):
    return spans.phase(run, ".readout")

"""Device time a call, in milliseconds, of the operations the solver
launched under its band build (the span ``pde_tpu_torch.<solver>.bands``):
the union of their intervals, as ``busy_us`` reads it, over the matched
calls (:mod:`perfbench.spans`).  Notes: their launches and the span's host
time a call, and every span's device time a call."""

from perfbench import spans


def read(run):
    return spans.phase(run, ".bands")

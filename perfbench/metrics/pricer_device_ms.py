"""Device time a call, in milliseconds, of the operations the Fourier
pricer launched (under the span ``pde_tpu_torch.heston.price_carr_madan_gl``),
read as ``bands_device_ms`` reads the band build's (:mod:`perfbench.spans`):
``pricer_busy_ms`` less the harness's own operations.  Its notes split it
into the quadrature rule, the integrand and the price (``device_ms_by_span``)."""

from perfbench import spans


def read(run):
    return spans.phase(run, ".price_carr_madan_gl")

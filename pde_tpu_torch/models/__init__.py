"""Pricing models: Black-Scholes closed forms, Heston Carr-Madan pricers and
the models that plug into their characteristic-function hook (Bates, SVCJ,
term-structure and forward-start Heston), digitals, variance and VIX
products, rough Heston, two-asset closed forms, the Heston QE Monte Carlo
engine (with the Bates and SVCJ jump simulators), Dupire local volatility,
the SABR smile, the Ornstein-Uhlenbeck process, the short-rate models
(Vasicek, CIR, Hull-White, G2++) and credit (hazard curves, CDS)."""

from . import (  # noqa: F401
    bates,
    black_scholes,
    credit,
    digital,
    forward_start,
    g2,
    heston,
    heston_mc,
    local_vol,
    multi_asset,
    ou,
    rates,
    rough_heston,
    sabr,
    svcj,
    term_heston,
    varswap,
    vix,
)
from .g2 import G2Params  # noqa: F401
from .rates import CIRParams, DiscountCurve, HullWhiteParams, VasicekParams  # noqa: F401

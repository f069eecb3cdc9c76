"""Pricing models: Black-Scholes closed forms, Heston Carr-Madan pricers and
the models that plug into their characteristic-function hook (Bates, SVCJ,
term-structure and forward-start Heston), digitals, variance and VIX
products, rough Heston, two-asset closed forms, Dupire local volatility,
the SABR smile and the Ornstein-Uhlenbeck process."""

from . import (  # noqa: F401
    bates,
    black_scholes,
    digital,
    forward_start,
    heston,
    local_vol,
    multi_asset,
    ou,
    rough_heston,
    sabr,
    svcj,
    term_heston,
    varswap,
    vix,
)

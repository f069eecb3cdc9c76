"""Pricing models: Black-Scholes closed forms, Heston Carr-Madan pricers,
Dupire local volatility, the SABR smile and the Ornstein-Uhlenbeck
process."""

from . import black_scholes, heston, local_vol, ou, sabr  # noqa: F401

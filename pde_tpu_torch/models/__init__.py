"""Pricing models: Black-Scholes closed forms, Heston Carr-Madan pricers,
Dupire local volatility and the SABR smile."""

from . import black_scholes, heston, local_vol, sabr  # noqa: F401

"""Pricing models: Black-Scholes closed forms and Heston Carr-Madan pricers."""

from . import black_scholes, heston  # noqa: F401

"""Standard normal CDF/PDF (twin of ``pde_tpu/utils/stats.py``, the part
the Black-Scholes formulas use)."""

from __future__ import annotations

import math

import torch

__all__ = ["norm_cdf", "norm_pdf"]

_INV_SQRT_2PI = 0.3989422804014327


def norm_cdf(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF: 0.5 * (1 + erf(x / sqrt(2)))."""
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def norm_pdf(x: torch.Tensor) -> torch.Tensor:
    """Standard normal PDF."""
    return _INV_SQRT_2PI * torch.exp(-0.5 * x * x)

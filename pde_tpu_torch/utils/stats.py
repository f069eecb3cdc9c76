"""Scalar/vector statistical primitives (twin of ``pde_tpu/utils/stats.py``):
mean/variance/std and the standard normal CDF/PDF, reference math utils
src/cpp/core/math_utils.hpp:26-56.

Inputs that are not tensors become tensors of torch's default float on the
card (``precision.device_of``), as every model function takes plain
numbers; ``axis=None`` reduces over all elements.
"""

from __future__ import annotations

import math

import torch

from ..core.precision import device_of, result_dtype, to_tensor

__all__ = ["mean", "variance", "std_dev", "norm_cdf", "norm_pdf"]

_INV_SQRT_2PI = 0.3989422804014327


def _floating(x) -> torch.Tensor:
    return to_tensor(x, result_dtype(x), device_of(x))


def mean(x, axis=None) -> torch.Tensor:
    return torch.mean(_floating(x), dim=axis)


def variance(x, axis=None, ddof: int = 1) -> torch.Tensor:
    """Sample variance (ddof=1 by default, matching the reference)."""
    return torch.var(_floating(x), dim=axis, correction=ddof)


def std_dev(x, axis=None, ddof: int = 1) -> torch.Tensor:
    return torch.std(_floating(x), dim=axis, correction=ddof)


def norm_cdf(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF: 0.5 * (1 + erf(x / sqrt(2)))."""
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def norm_pdf(x: torch.Tensor) -> torch.Tensor:
    """Standard normal PDF."""
    return _INV_SQRT_2PI * torch.exp(-0.5 * x * x)

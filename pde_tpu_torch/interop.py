"""Carry inputs and parameters from the JAX package into the port's tensors.

Everything crosses as numpy: ``np.asarray`` reads a JAX array without this
module importing JAX, so the port stays JAX-free while the tests feed both
packages identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.heston import HestonParams

__all__ = ["tensor", "heston_params", "quotes", "grouping"]


def tensor(x, device="cpu", dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Any array-like (numpy, JAX, scalar) as a tensor of ``dtype`` on
    ``device``; copied, since a JAX array's numpy view is read-only."""
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def heston_params(p, device="cpu", dtype: torch.dtype = torch.float64) -> HestonParams:
    """A parameter record with kappa/theta/sigma/rho/v0 fields (the JAX
    package's ``HestonParams``) as the port's, field by field."""
    return HestonParams(*(tensor(getattr(p, k), device, dtype)
                          for k in HestonParams._fields))


def quotes(strikes, maturities, prices, is_calls, device="cpu",
           dtype: torch.dtype = torch.float64):
    """Quote arrays as (strikes, maturities, prices, is_calls) tensors;
    ``is_calls`` becomes a bool tensor."""
    return (tensor(strikes, device, dtype), tensor(maturities, device, dtype),
            tensor(prices, device, dtype),
            torch.as_tensor(np.asarray(is_calls, dtype=bool), device=device))


def grouping(t_idx, unique_T, device="cpu", dtype: torch.dtype = torch.float64):
    """The ``(t_idx, unique_T)`` maturity grouping of ``group_maturities``
    as (int64 index, float) tensors."""
    return (torch.as_tensor(np.asarray(t_idx, dtype=np.int64), device=device),
            tensor(unique_T, device, dtype))

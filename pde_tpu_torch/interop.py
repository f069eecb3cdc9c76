"""Carry inputs and parameters from the JAX package into the port's tensors.

Everything crosses as numpy: ``np.asarray`` reads a JAX array without this
module importing JAX, so the port stays JAX-free while the tests feed both
packages identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.bates import BatesParams
from .models.credit import HazardCurve, SwapTrade
from .models.forward_start import ForwardStartParams
from .models.g2 import G2Params
from .models.heston import HestonParams
from .models.local_vol import SurfaceInterpolator
from .models.ou import OUParams
from .models.rates import CIRParams, DiscountCurve, HullWhiteParams, VasicekParams
from .models.rough_heston import RoughHestonParams
from .models.sabr import SABRParams
from .models.slv import LeverageSurface
from .models.svcj import SVCJParams
from .models.term_heston import TermHestonParams
from .solvers.bates_pide import BatesPIDEParams
from .solvers.bs_pde import BSPDEParams
from .solvers.heston_adi import HestonPDEParams
from .solvers.hjb import HJBParams, StoppingProblem
from .solvers.pide import KouJumps, MertonJumps

__all__ = ["tensor", "heston_params", "sabr_params", "ou_params", "quotes", "grouping",
           "surface_interpolator", "heston_pde_params", "bs_pde_params", "hjb_params",
           "bates_params", "svcj_params", "term_heston_params", "forward_start_params",
           "rough_heston_params", "discount_curve", "vasicek_params", "cir_params",
           "hull_white_params", "g2_params", "hazard_curve", "swap_trade",
           "leverage_surface", "merton_jumps", "kou_jumps", "bates_pide_params"]


def tensor(x, device="cpu", dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Any array-like (numpy, JAX, scalar) as a tensor of ``dtype`` on
    ``device``; copied, since a JAX array's numpy view is read-only."""
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def heston_params(p, device="cpu", dtype: torch.dtype = torch.float64) -> HestonParams:
    """A parameter record with kappa/theta/sigma/rho/v0 fields (the JAX
    package's ``HestonParams``) as the port's, field by field."""
    return HestonParams(*(tensor(getattr(p, k), device, dtype)
                          for k in HestonParams._fields))


def _fields(cls, p, device, dtype):
    """A parameter record as the port's ``cls``, field by field, each field
    (number or array) a tensor of ``dtype`` on ``device``."""
    return cls(*(tensor(getattr(p, k), device, dtype) for k in cls._fields))


def bates_params(p, device="cpu", dtype: torch.dtype = torch.float64) -> BatesParams:
    """The JAX package's ``bates.BatesParams`` as the port's."""
    return _fields(BatesParams, p, device, dtype)


def svcj_params(p, device="cpu", dtype: torch.dtype = torch.float64) -> SVCJParams:
    """The JAX package's ``svcj.SVCJParams`` as the port's."""
    return _fields(SVCJParams, p, device, dtype)


def term_heston_params(p, device="cpu",
                       dtype: torch.dtype = torch.float64) -> TermHestonParams:
    """The JAX package's ``term_heston.TermHestonParams`` (edges and the
    per-interval arrays included) as the port's."""
    return _fields(TermHestonParams, p, device, dtype)


def forward_start_params(p, device="cpu",
                         dtype: torch.dtype = torch.float64) -> ForwardStartParams:
    """The JAX package's ``forward_start.ForwardStartParams`` as the port's."""
    return _fields(ForwardStartParams, p, device, dtype)


def rough_heston_params(p, device="cpu",
                        dtype: torch.dtype = torch.float64) -> RoughHestonParams:
    """The JAX package's ``rough_heston.RoughHestonParams`` as the port's."""
    return _fields(RoughHestonParams, p, device, dtype)


def discount_curve(c, device="cpu", dtype: torch.dtype = torch.float64) -> DiscountCurve:
    """The JAX package's ``rates.DiscountCurve`` (times, dfs) as the port's."""
    return _fields(DiscountCurve, c, device, dtype)


def vasicek_params(p, device="cpu", dtype: torch.dtype = torch.float64) -> VasicekParams:
    """The JAX package's ``rates.VasicekParams`` as the port's."""
    return _fields(VasicekParams, p, device, dtype)


def cir_params(p, device="cpu", dtype: torch.dtype = torch.float64) -> CIRParams:
    """The JAX package's ``rates.CIRParams`` as the port's."""
    return _fields(CIRParams, p, device, dtype)


def hull_white_params(p, device="cpu",
                      dtype: torch.dtype = torch.float64) -> HullWhiteParams:
    """The JAX package's ``rates.HullWhiteParams`` (its curve included) as
    the port's."""
    return HullWhiteParams(tensor(p.a, device, dtype), tensor(p.sigma, device, dtype),
                           discount_curve(p.curve, device, dtype))


def g2_params(p, device="cpu", dtype: torch.dtype = torch.float64) -> G2Params:
    """The JAX package's ``g2.G2Params`` (its curve included) as the port's."""
    return G2Params(*(tensor(getattr(p, k), device, dtype) for k in G2Params._fields[:5]),
                    discount_curve(p.curve, device, dtype))


def hazard_curve(h, device="cpu", dtype: torch.dtype = torch.float64) -> HazardCurve:
    """The JAX package's ``credit.HazardCurve`` as the port's."""
    return _fields(HazardCurve, h, device, dtype)


def swap_trade(t, device="cpu", dtype: torch.dtype = torch.float64) -> SwapTrade:
    """The JAX package's ``credit.SwapTrade`` as the port's."""
    return _fields(SwapTrade, t, device, dtype)


def sabr_params(p, device="cpu", dtype: torch.dtype = torch.float64) -> SABRParams:
    """A parameter record with alpha/beta/rho/nu fields (the JAX package's
    ``SABRParams``) as the port's, field by field."""
    return SABRParams(*(tensor(getattr(p, k), device, dtype)
                        for k in SABRParams._fields))


def ou_params(p, device="cpu", dtype: torch.dtype = torch.float64) -> OUParams:
    """A parameter record with theta/mu/sigma fields (the JAX package's
    ``OUParams``) as the port's, field by field."""
    return OUParams(*(tensor(getattr(p, k), device, dtype) for k in OUParams._fields))


def _pde_params(cls, p, floats, device, dtype):
    """A PDE parameter record as the port's ``cls``, field by field: the
    model/contract values in ``floats`` as 0-d tensors of ``dtype`` (so the
    solver runs in that dtype), the rest (flags, grid sizes and spans,
    methods) as they are."""
    return cls(**{k: tensor(getattr(p, k), device, dtype) if k in floats
                  else getattr(p, k) for k in cls._fields})


def heston_pde_params(p, device="cpu", dtype: torch.dtype = torch.float64) -> HestonPDEParams:
    """The JAX package's ``heston_adi.HestonPDEParams`` as the port's."""
    return _pde_params(HestonPDEParams, p, ("kappa", "theta", "sigma", "rho", "v0",
                                            "r", "q", "T", "K"), device, dtype)


def bs_pde_params(p, device="cpu", dtype: torch.dtype = torch.float64) -> BSPDEParams:
    """The JAX package's ``bs_pde.BSPDEParams`` as the port's."""
    return _pde_params(BSPDEParams, p, ("sigma", "r", "q", "T", "K"), device, dtype)


def merton_jumps(j, device="cpu", dtype: torch.dtype = torch.float64) -> MertonJumps:
    """The JAX package's ``pide.MertonJumps`` as the port's."""
    return _fields(MertonJumps, j, device, dtype)


def kou_jumps(j, device="cpu", dtype: torch.dtype = torch.float64) -> KouJumps:
    """The JAX package's ``pide.KouJumps`` as the port's."""
    return _fields(KouJumps, j, device, dtype)


def bates_pide_params(p, device="cpu", dtype: torch.dtype = torch.float64) -> BatesPIDEParams:
    """The JAX package's ``bates_pide.BatesPIDEParams`` as the port's: the
    jump leg as the port's record of the same family (its class name)."""
    jumps = (merton_jumps if type(p.jumps).__name__ == "MertonJumps" else kou_jumps)(
        p.jumps, device, dtype)
    return _pde_params(BatesPIDEParams, p._replace(jumps=jumps),
                       ("kappa", "theta", "sigma", "rho", "v0", "r", "q", "T", "K"),
                       device, dtype)


def hjb_params(p) -> HJBParams:
    """The JAX package's ``hjb.HJBParams`` as the port's, field by field:
    numbers as Python numbers (the solver's ``dtype`` argument sets the
    precision), ``problem`` by its integer value as the port's own
    ``StoppingProblem``."""
    fields = {k: getattr(p, k) for k in HJBParams._fields}
    fields["problem"] = StoppingProblem(int(p.problem))
    return HJBParams(**fields)


def surface_interpolator(interp, device="cpu",
                         dtype: torch.dtype = torch.float64) -> SurfaceInterpolator:
    """The port's interpolator on the same grid as a JAX
    ``SurfaceInterpolator``: its ``log_k``, ``t`` and ``vols``, as numpy
    (``log_k`` taken as it is, not through a round trip by ``exp``)."""
    log_k = np.array(interp.log_k)
    out = SurfaceInterpolator(np.exp(log_k), np.array(interp.t),
                              np.array(interp.vols), device=device, dtype=dtype)
    out.log_k = tensor(log_k, device, dtype)
    return out


def leverage_surface(lev, device="cpu",
                     dtype: torch.dtype = torch.float64) -> LeverageSurface:
    """The JAX package's calibrated ``slv.LeverageSurface`` as the port's,
    field by field."""
    return _fields(LeverageSurface, lev, device, dtype)


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

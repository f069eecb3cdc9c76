"""The general traffic generator: books of options drawn from a mix's
parameters (``traffic/<mix>.json``, its ``book`` object) with a
``torch.Generator`` on the run's device seeded from ``--seed``.  The same
seed gives the same books; every seed gives books of the same shape.

Two layouts:

* ``grid`` — ``underlyings`` names, each with a spot drawn from ``spot``
  and, where the mix has ``heston``, its own Heston parameters drawn from
  those ranges; each name lists ``moneyness.n`` strikes (spot times
  ``linspace`` over ``moneyness.range``) at ``maturity.n`` maturities
  (``linspace`` over ``maturity.range``).  Option b is name b // (nK nT),
  maturity (b // nK) % nT, strike b % nK.
* ``uniform`` — ``options`` options on one spot (a number), strikes and
  maturities drawn uniformly from ``strike`` and ``maturity``.

``calls``: ``"alternate"`` makes even options calls and odd ones puts.
"""

from __future__ import annotations

import torch

HESTON = ("kappa", "theta", "sigma", "rho", "v0")


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def uniform(g, n: int, lo: float, hi: float, device, dtype=torch.float32):
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    return (lo + (hi - lo) * u).to(dtype)


def book_size(spec: dict) -> int:
    if spec["layout"] == "grid":
        return spec["underlyings"] * spec["moneyness"]["n"] * spec["maturity"]["n"]
    return spec["options"]


def book(spec: dict, g, device, dtype=torch.float32) -> dict:
    """One book: ``S0``, ``K``, ``T`` and ``is_call`` (1.0 a call, 0.0 a
    put), and the Heston fields where the mix draws them, each (B,)."""
    B = book_size(spec)
    if spec["layout"] == "grid":
        U, nK, nT = spec["underlyings"], spec["moneyness"]["n"], spec["maturity"]["n"]
        spot = uniform(g, U, *spec["spot"], device, dtype)
        per_name = {k: uniform(g, U, *spec["heston"][k], device, dtype)
                    for k in HESTON if "heston" in spec}
        b = torch.arange(B, device=device)
        name, t_i, k_i = b // (nK * nT), (b // nK) % nT, b % nK
        m = torch.linspace(*spec["moneyness"]["range"], nK, dtype=torch.float64,
                           device=device).to(dtype)
        mats = torch.linspace(*spec["maturity"]["range"], nT, dtype=torch.float64,
                              device=device).to(dtype)
        out = {"S0": spot[name], "K": spot[name] * m[k_i], "T": mats[t_i]}
        out.update({k: v[name] for k, v in per_name.items()})
    elif spec["layout"] == "uniform":
        out = {"S0": torch.full((B,), float(spec["spot"]), dtype=dtype, device=device),
               "K": uniform(g, B, *spec["strike"], device, dtype),
               "T": uniform(g, B, *spec["maturity"], device, dtype)}
    else:
        raise ValueError(f"unknown book layout {spec['layout']!r}")
    if spec["calls"] != "alternate":
        raise ValueError(f"unknown call/put pattern {spec['calls']!r}")
    out["is_call"] = (torch.arange(B, device=device) % 2 == 0).to(dtype)
    return out


def pool(spec: dict, n: int, seed: int, device, dtype=torch.float32) -> list[dict]:
    """``n`` books drawn one after another from the seed's generator."""
    g = generator(seed, device)
    return [book(spec, g, device, dtype) for _ in range(n)]

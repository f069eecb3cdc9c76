"""The comparison that decides ``correct``: each output field of the
compared books against the plain reference, as the widest gap over every
option, in units that make the fields of one book comparable across
strikes: prices, vegas and thetas per unit of strike, deltas as they are,
gammas times the strike.  A Greek taken at the nearest grid node is held to
the nearer of the reference's readings where two nodes tie.  A value that
is not finite reads as an infinite gap."""

from __future__ import annotations

import numpy as np
import torch

# the power of the strike that makes a field's gap dimensionless
STRIKE_POWER = {"price": -1, "vega": -1, "theta": -1, "delta": 0, "gamma": 1}


def gaps(out: dict, ref: dict, K, fields) -> dict:
    """``{field: widest gap}`` of the program's ``out`` against ``ref``;
    ``alt_<field>`` in ``ref`` is the reading at the other node of a tie."""
    K = K.to(torch.float64)
    result = {}
    for f in fields:
        p = out[f].to(device=K.device, dtype=torch.float64)
        gap = (p - ref[f]).abs()
        if "alt_" + f in ref:
            gap = torch.minimum(gap, (p - ref["alt_" + f]).abs())
        gap = torch.nan_to_num(gap * K ** STRIKE_POWER[f], nan=float("inf"))
        result[f] = float(gap.max())
    return result


def sample(called: list[int], n: int, seed: int) -> list[int]:
    """``n`` of the pool's called books, drawn from the seed."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    return sorted(int(i) for i in rng.choice(sorted(called), size=min(n, len(called)),
                                             replace=False))


def widest(per_book: list[dict]) -> dict:
    """The widest reading of each field over the compared books, named
    ``<field>_gap``."""
    return {f"{f}_gap": max(g[f] for g in per_book) for f in per_book[0]}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (a missing limit fails)."""
    return all(name in limits and value <= limits[name] for name, value in numbers.items())

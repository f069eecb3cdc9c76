"""A book of contracts marked by the Fourier pricer, each row with its
own Heston parameters as (N, 1) columns, as the pricing service calls it:
``pde_tpu_torch.models.heston.price_carr_madan_gl``."""

from __future__ import annotations

import torch

from perfbench.book import BookCell
from perfbench.reference import heston_cf as ref

HESTON = ("kappa", "theta", "sigma", "rho", "v0")


class Cell(BookCell):
    fields = ("price",)

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from pde_tpu_torch.models import heston

        self._heston = heston
        n = self.work_per_call
        self.rate = torch.full((n,), config["r"], dtype=self.dtype, device=self.device)
        self.dividend = torch.full((n,), config["q"], dtype=self.dtype, device=self.device)
        self.quad = config["fourier"]

    def price(self, b):
        h = self._heston
        params = h.HestonParams(*(b[k][:, None] for k in HESTON))
        p = h.price_carr_madan_gl(params, b["K"], b["T"], b["S0"], self.rate, self.dividend,
                                  b["is_call"] > 0.5, n_points=self.quad["n_points"],
                                  du=self.quad["du"], alpha=self.quad["alpha"])
        return {"price": p}

    def reference(self, book, dtype):
        rounding = None if dtype == torch.float64 else "bfloat16"
        return {"price": ref.prices(book, self.config["r"], self.config["q"], self.quad,
                                    rounding)}

    @property
    def shapes(self):
        return {"N": self.work_per_call, "M": self.quad["n_points"] + 6}


def build(config, traffic, seed, device):
    return Cell(config, traffic, seed, device)

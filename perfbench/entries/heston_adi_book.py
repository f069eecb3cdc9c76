"""A book of Heston options priced with grid Greeks through the fused
Douglas march: ``pde_tpu_torch.solvers.heston_adi.solve_fused_batch`` (the
band build, one launch of K1, the readout)."""

from __future__ import annotations

from perfbench.book import BookCell
from perfbench.reference import heston_adi as ref


class Cell(BookCell):
    kernel = "k1"   # its march kernel's counts, perfbench/counts/<kernel>.py
    fields = ref.FIELDS

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from pde_tpu_torch.solvers import heston_adi

        self._solve = heston_adi.solve_fused_batch
        self.grid = config["grid"]

    def price(self, b):
        g = self.grid
        res = self._solve(b["kappa"], b["theta"], b["sigma"], b["rho"], b["v0"],
                          self.config["r"], self.config["q"], b["T"], b["K"], b["is_call"],
                          b["S0"], n_spot=g["n_spot"], n_vol=g["n_vol"], n_time=g["n_time"],
                          s_min_mult=g["s_min_mult"], s_max_mult=g["s_max_mult"],
                          v_max=g["v_max"], device=self.device)
        return res._asdict()

    def reference(self, book, dtype):
        return ref.solve(book, self.grid, self.config["r"], self.config["q"], dtype)

    @property
    def shapes(self):
        g = self.grid
        return {"B": self.work_per_call, "nS": g["n_spot"], "nv": g["n_vol"],
                "nT": g["n_time"]}


def build(config, traffic, seed, device):
    return Cell(config, traffic, seed, device)

"""A book of European options under one Dupire surface through the fused
theta-scheme march: ``pde_tpu_torch.solvers.local_vol_pde.
solve_fused_batch(route="fused")`` (the surface lookup and band lattice,
one launch of K3, the readout).  The surface is the benchmark's own
(:mod:`perfbench.dupire`), made at set-up from the configuration's Heston
parameters and handed to the port and the reference alike."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import dupire
from perfbench.book import BookCell
from perfbench.reference import local_vol_cn as ref


class Cell(BookCell):
    kernel = "k3"   # its march kernel's counts, perfbench/counts/<kernel>.py
    fields = ref.FIELDS

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from pde_tpu_torch.models.local_vol import SurfaceInterpolator
        from pde_tpu_torch.solvers import local_vol_pde

        self._solve = local_vol_pde.solve_fused_batch
        s = config["surface"]
        ks = np.exp(np.linspace(np.log(s["strike_range"][0]), np.log(s["strike_range"][1]),
                                s["n_strikes"]))
        ts = np.linspace(*s["maturity_range"], s["n_maturities"])
        vols = dupire.local_vol_surface(config["heston"], ks, ts, s["spot"], config["r"],
                                        config["q"], self.device).to(self.dtype)
        self.surface = {"strikes": ks, "maturities": ts, "vols": vols}
        self.interp = SurfaceInterpolator(ks, ts, vols, device=self.device, dtype=self.dtype)
        self.grid = config["grid"]

    def price(self, b):
        g = self.grid
        res = self._solve(self.interp, b["S0"], K=b["K"], T=b["T"], r=self.config["r"],
                          q=self.config["q"], is_call=b["is_call"], n_space=g["n_space"],
                          n_time=g["n_time"], s_min_mult=g["s_min_mult"],
                          s_max_mult=g["s_max_mult"], scheme=g["scheme"], route="fused",
                          device=self.device)
        return res._asdict()

    def reference(self, book, dtype):
        grid = dict(self.grid, w={"crank_nicolson": 0.5, "implicit": 1.0}[self.grid["scheme"]])
        surface = dict(self.surface, vols=self.surface["vols"].to(torch.float64))
        return ref.solve(book, surface, grid, self.config["r"], self.config["q"], dtype)

    @property
    def shapes(self):
        return {"B": self.work_per_call, "n": self.grid["n_space"], "nT": self.grid["n_time"]}


def build(config, traffic, seed, device):
    return Cell(config, traffic, seed, device)

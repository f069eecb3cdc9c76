#!/usr/bin/env python3
"""How far float32 moves a Longstaff-Schwartz price, on the CPU.

For each seed, one replay of a CPU generator's draws feeds
``price_american_lsm_batch`` and ``price_american_lsm`` at four strikes of
``chip_smoke.py``'s 128-strike book (calls at even indices of 70..130) in
float64 and float32.  It prints one JSON line a seed: the largest float32
move from float64 of the 4-strike book and of the single prices (the
"CPU's float32 tolerance" of the smoke's book check), the largest float32
gap between the 128-strike book and the single prices at those strikes,
and each gap in units of that contract's standard error.  Float32 moves an
LSM price only by flipping exercise decisions at near ties, so the gaps
are noise on the scale of the tolerance, a small fraction of a standard
error.

Run from the repository root (CPU only, ~1 min a seed):

    python3 scripts/torch_lsm_f32_noise.py [n_seeds] [n_paths] [n_steps]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pde_tpu_torch.models import heston_mc  # noqa: E402
from pde_tpu_torch.models.heston import HestonParams  # noqa: E402
from pde_tpu_torch.solvers import lsm  # noqa: E402

PICKS = [0, 43, 86, 127]


def main(n_seeds=14, n_paths=1 << 15, n_steps=32):
    cpu = torch.device("cpu")
    kw = dict(rate=0.05, n_steps=n_steps, n_paths=n_paths)
    strikes = torch.linspace(70.0, 130.0, 128, dtype=torch.float64)
    calls = torch.arange(128) % 2 == 0
    for seed in range(n_seeds):
        replay = heston_mc._Replay(heston_mc._draws(torch.Generator().manual_seed(seed), cpu))
        out = {}
        for dtype in (torch.float64, torch.float32):
            p = HestonParams(*(torch.tensor(v, dtype=dtype) for v in (2.0, 0.04, 0.3, -0.7, 0.04)))
            s0, k = torch.tensor(100.0, dtype=dtype), strikes.to(dtype)
            book4, se = lsm.price_american_lsm_batch(p, k[PICKS], calls[PICKS], 1.0, s0, replay,
                                                     **kw)
            single = torch.stack([lsm.price_american_lsm(p, float(k[i]), 1.0, s0, replay,
                                                         is_call=bool(calls[i]), **kw)[0]
                                  for i in PICKS])
            book128 = lsm.price_american_lsm_batch(p, k, calls, 1.0, s0, replay, **kw)[0][PICKS]
            out[dtype] = (book4.double(), single.double(), book128.double(), se.double())
        b64, s64, _, se = out[torch.float64]
        b32, s32, b128, _ = out[torch.float32]
        tol = max(float((b32 - b64).abs().max()), float((s32 - s64).abs().max()))
        gap = (b128 - s32).abs()
        print(json.dumps(dict(seed=seed, cpu_f32_tolerance=tol, book128_vs_single_f32=gap.tolist(),
                              gap_over_tolerance=float(gap.max()) / max(tol, 1e-30),
                              gap_over_se=(gap / se).tolist())), flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))

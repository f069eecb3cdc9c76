"""The port's Andersen-Broadie dual bound (``pde_tpu_torch/solvers/
lsm_dual.py``) held against ``pde_tpu`` (x64) on the CPU.

Gates, each with its reason:
- ``dual_upper_bound`` on the reference's own draws
  (``jax_key_draws.JaxKey``: the ``(k_reg, k_outer, k_inner)`` split, one
  bundle key for C_0 and one per date): all four outputs at 1e-10 relative
  in float64 (the same arithmetic; the regression and the bundle means sum
  in another order, ~1e-15);
- on a ``torch.Generator``'s paths (Philox, not threefry): the reference's
  own sandwich gates (``tests/test_lsm_dual.py``): upper + 4 s.e. >= lower
  - 4 s.e., gap < 4% + 4 s.e.; the deep-ITM floor.
Sizes: 4-6 dates, at most 2048 regression paths and 64 x 8 outer x inner
paths.
"""

import jax
import numpy as np
import pytest
import torch
from jax_key_draws import JaxKey

from pde_tpu.models.heston import HestonParams as JParams
from pde_tpu.solvers import lsm_dual as jdual
from pde_tpu_torch.models.heston import HestonParams as TParams
from pde_tpu_torch.solvers import lsm_dual as tdual

F64 = torch.float64
FIELDS = (2.0, 0.04, 0.3, -0.7, 0.04)
JP, TP = JParams(*FIELDS), TParams(*FIELDS)
S0 = torch.tensor(100.0, dtype=F64)
SIZE = dict(n_steps=4, n_reg_paths=2048, n_outer=64, n_inner=8)


@pytest.mark.parametrize("strike,kw", [
    (100.0, dict(rate=0.05)),
    (95.0, dict(rate=0.03, dividend=0.05, is_call=True, n_steps=6)),
])
def test_dual_matches_reference(strike, kw):
    key = jax.random.PRNGKey(7)
    size = {**SIZE, **{k: v for k, v in kw.items() if k == "n_steps"}}
    kw = {k: v for k, v in kw.items() if k != "n_steps"}
    want = jdual.dual_upper_bound(JP, strike, 1.0, 100.0, key, **size, **kw)
    got = tdual.dual_upper_bound(TP, strike, 1.0, S0, JaxKey(key), **size, **kw)
    for g, w in zip(got, want):
        assert g.shape == ()
        np.testing.assert_allclose(float(g), float(w), rtol=1e-10, atol=0.0)


def test_sandwich_on_generator_paths():
    lo, sel, up, seu = (float(x) for x in tdual.dual_upper_bound(
        TP, 100.0, 1.0, S0, torch.Generator().manual_seed(7), rate=0.05, n_steps=6,
        n_reg_paths=2048, n_outer=128, n_inner=16))
    assert up + 4 * seu >= lo - 4 * sel
    assert up - lo < 0.04 * lo + 4 * (sel + seu), (lo, up)


def test_deep_itm_floor():
    lo, _, up, seu = (float(x) for x in tdual.dual_upper_bound(
        TP, 140.0, 1.0, S0, torch.Generator().manual_seed(1), rate=0.05, **SIZE))
    assert lo >= 40.0 - 1e-9
    assert up + 4 * seu >= 40.0

"""The port's Heston scan and single-option paths held against ``pde_tpu``.

Gates, each with its reason:
- ``solve``/``solve_batch``/``greeks_ad`` in float64: 1e-8 relative on the
  price and the Greeks, 1e-8 absolute on the grid; the same march in the
  same order, so round-off only.  ``remat=True`` equals ``remat=False``
  at 1e-12 (it recomputes the same steps).
- K2 (``fused_douglas_march``): its plain twin against the reference's
  Pallas kernel in interpret mode, float32, at the kernel's stated
  tolerance, 1e-5 relative + 1e-6 absolute (pde_tpu/ops/adi_fused.py:12);
  ``solve_fused`` in both packages at the same gate.
The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from pde_tpu.ops import adi_fused as jops
from pde_tpu.solvers import heston_adi as ja
from pde_tpu_torch import interop
from pde_tpu_torch.ops import adi_fused as tops
from pde_tpu_torch.solvers import heston_adi as ta

F64 = torch.float64
SMALL = ja.HestonPDEParams(kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, v0=0.04, r=0.05,
                           q=0.02, T=1.0, K=100.0, n_spot=24, n_vol=12, n_time=8)
AMER = dict(is_call=False, american=True, r=0.08, q=0.0)
MODES = {"european": {}, "projection": AMER, "it_lcp": dict(AMER, american_method="it_lcp")}
GREEKS = ("price", "delta", "gamma", "vega", "theta")
K2_GATE = dict(rtol=1e-5, atol=1e-6)


def _check(got, want, rtol=1e-8, grid_atol=1e-8):
    for f in GREEKS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=rtol, atol=1e-12, err_msg=f)
    np.testing.assert_allclose(got.prices.numpy(), np.asarray(want.prices), rtol=0,
                               atol=grid_atol)
    np.testing.assert_allclose(got.spot_grid.numpy(), np.asarray(want.spot_grid),
                               rtol=1e-12)


@pytest.mark.parametrize("scheme", ["douglas", "craig_sneyd", "hv"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_solve_matches_reference_f64(scheme, mode):
    """solve: three ADI schemes x European / American projection / IT-LCP."""
    p = SMALL._replace(scheme=scheme, **MODES[mode])
    got = ta.solve(interop.heston_pde_params(p), 100.0, device="cpu")
    assert got.prices.dtype == F64 and got.prices.shape == (24, 12)
    _check(got, ja.solve(p, 100.0))


def test_solve_batch_mixed_book():
    """The 4-option book of tests/test_solvers.py:194-196 (strikes,
    maturities, calls and puts) in one march, in both packages, and each
    row equal to its single-option solve."""
    K = np.array([90.0, 100.0, 110.0, 100.0])
    T = np.array([0.5, 1.0, 1.0, 2.0])
    is_call = np.array([True, True, False, False])
    kw = dict(n_spot=24, n_vol=12, n_time=8)
    args = (2.0, 0.04, 0.3, -0.7, 0.04, 0.05, 0.02, T, K, is_call, 100.0)
    want = ja.solve_batch(*args, **kw)
    got = ta.solve_batch(*args, **kw, device="cpu", dtype=F64)
    assert got.price.shape == (4,) and got.prices.shape == (4, 24, 12)
    _check(got, want)
    single = ta.solve(interop.heston_pde_params(SMALL._replace(K=110.0, is_call=False)),
                      100.0, device="cpu")
    np.testing.assert_allclose(float(got.price[2]), float(single.price), rtol=1e-10)


def test_greeks_ad_matches_reference():
    """Adjoint price, delta and d/d{kappa..T} through the march by autograd
    against jax.value_and_grad; remat=True gives the same adjoint."""
    args = (2.0, 0.04, 0.3, -0.7, 0.04, 0.05, 0.02, 1.0, 100.0, True, 100.0)
    kw = dict(n_spot=16, n_vol=8, n_time=6)
    want = ja.greeks_ad(*args, **kw)
    got = ta.greeks_ad(*args, **kw, device="cpu", dtype=F64)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-8, err_msg=k)
    remat = ta.greeks_ad(*args, **kw, remat=True, device="cpu", dtype=F64)
    for k in want:
        np.testing.assert_allclose(float(remat[k]), float(got[k]), rtol=1e-12, err_msg=k)


def test_greeks_ad_american_it_lcp():
    """The Ikonen-Toivanen American put differentiates too (the multiplier
    update and the edge floors sit on the tape)."""
    args = (2.0, 0.04, 0.3, -0.7, 0.04, 0.08, 0.0, 1.0, 100.0, False, 90.0)
    kw = dict(n_spot=16, n_vol=8, n_time=6, american=True, american_method="it_lcp")
    want = ja.greeks_ad(*args, **kw)
    got = ta.greeks_ad(*args, **kw, device="cpu", dtype=F64)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-8, atol=1e-12,
                                   err_msg=k)


def _k2_inputs(p):
    """K2's inputs for ``p``, built by the port in float64, as numpy."""
    t = lambda k: torch.tensor(float(getattr(p, k)), dtype=F64)  # noqa: E731
    args, _ = ta._fused_inputs(p, *(t(k) for k in ("kappa", "theta", "sigma", "rho",
                                                   "r", "q", "T", "K")))
    return args


K2_VARIANTS = {"call": {}, "put": dict(is_call=False), "american_put": AMER,
               "american_put_it_lcp": MODES["it_lcp"]}


@pytest.mark.parametrize("variant", sorted(K2_VARIANTS))
def test_k2_plain_matches_pallas(variant):
    """The variants of tests/test_solvers.py:217-222."""
    p = ta.HestonPDEParams(*SMALL._replace(**K2_VARIANTS[variant]))
    args = _k2_inputs(p)
    np_args = [tuple(b.numpy() for b in a) if isinstance(a, tuple) else a.numpy()
               for a in args]
    size = dict(n_spot=24, n_vol=12, n_time=8)
    want = np.asarray(jops.fused_douglas_march(*np_args, **size, interpret=True))
    before = tops.fused_douglas_march.launches
    got = tops.fused_douglas_march(*args, **size)
    assert got.dtype == torch.float32 and got.shape == (24, 12)
    np.testing.assert_allclose(got.numpy(), want, **K2_GATE)
    assert tops.fused_douglas_march.launches == before


@pytest.mark.parametrize("variant", sorted(K2_VARIANTS))
def test_solve_fused_matches_reference(variant):
    """solve_fused in both packages, and within the reference test's 5e-4
    of the float64 scan solve (tests/test_solvers.py:226-231)."""
    p = SMALL._replace(**K2_VARIANTS[variant])
    want = ja.solve_fused(p, 100.0, interpret=True)
    got = ta.solve_fused(interop.heston_pde_params(p), 100.0, device="cpu")
    assert got.prices.dtype == F64
    for f in GREEKS + ("prices",):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   err_msg=f, **K2_GATE)
    scan = ta.solve(interop.heston_pde_params(p), 100.0, device="cpu")
    np.testing.assert_allclose(got.prices.numpy(), scan.prices.numpy(), atol=5e-4)


@pytest.mark.parametrize("grid,lanes,bands", [((100, 50), (16, 8), True),
                                              ((40, 20), (32, 16), True),
                                              ((16, 8), (16, 8), True),
                                              ((160, 50), (16, 4), False)])
def test_k2_smem_plan(grid, lanes, bands):
    """K2's shared-memory route (csrc/adi_fused.cu): lanes per S column and
    per v row are powers of two within the 1024-thread block and at most
    one per row; the block holds V, R, 1/pivot and lambda on the padded
    grid, in every exercise mode (it_lcp is a flag on the device, so
    lambda's room is always there), plus the v vectors and the spot grid;
    the six (nS, nv) band fields join them where they fit, within a block's
    227 KB (at 100x50 they do; at 160x50 they are read in place)."""
    nS, nv = grid
    ps, gs, gv, bands_smem, n_bytes = tops._smem_plan_single(nS, nv)
    assert (gs, gv) == lanes and bands_smem == bands
    assert nv * gs <= 1024 and nS * gv <= 1024 and gs <= nS and gv <= nv
    assert nv <= ps < nv + 32
    assert n_bytes == 4 * ((10 if bands else 4) * nS * ps + 10 * nv + nS) <= 232448
    if grid == (100, 50):
        assert n_bytes == 218400
        cs, cv = -(-nS // gs), -(-nv // gv)
        s_words = [(t % gs) * cs * ps + t // gs for t in range(32)]
        v_words = [(t // gv) * ps + (t % gv) * cv for t in range(32)]
        assert tops._bank_degree(s_words) + tops._bank_degree(v_words) <= 3


def test_k2_large_grid_has_no_smem_plan():
    """At 200x100 K2's state alone (V, R, 1/pivot, lambda: 80 KB a field)
    exceeds a block's 227 KB: the wrapper sends it to the first design."""
    assert tops._smem_plan_single(200, 100) is None


def test_rejections():
    p = ta.HestonPDEParams(n_spot=16, n_vol=8, n_time=4)
    for bad in (dict(kappa=0.0), dict(rho=1.0), dict(v0=-0.1), dict(scheme="ftcs")):
        with pytest.raises(ValueError):
            ta.solve(p._replace(**bad), 100.0, device="cpu")
    with pytest.raises(ValueError, match="american_method"):
        ta.solve_fused(p._replace(american=True, american_method="psor"), 100.0,
                       device="cpu")
    with pytest.raises(ValueError, match="Douglas"):
        ta.solve_fused(p._replace(scheme="hv"), 100.0, device="cpu")
    with pytest.raises(ValueError):  # K2 input of the wrong shape
        tops.fused_douglas_march(*_k2_inputs(p), n_spot=17, n_vol=8, n_time=4)

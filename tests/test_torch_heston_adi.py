"""The PyTorch port's fused-ADI slice held against the JAX package.

K1 (``fused_douglas_march_batched``): the JAX Pallas kernel in interpret
mode against the port's plain twin on identical seeded inputs; then the
whole ``solve_fused_batch`` in both packages.  Both march in float32, so
the gate is the repo's own variant gate, rtol 2e-5 / atol 2e-5
(tests/test_solvers.py:307-309).  The CUDA kernel itself runs only on the
card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from pde_tpu.ops import adi_fused as jops
from pde_tpu.solvers import heston_adi as ja
from pde_tpu_torch.ops import adi_fused as tops
from pde_tpu_torch.solvers import heston_adi as ta

GATE = dict(rtol=2e-5, atol=2e-5)
FIELDS = ("price", "delta", "gamma", "vega", "theta")
# theta is -(A0 + A1 + A2) V at one node: the operator's 1/dx^2 and 1/dv^2
# scales amplify float32 noise in V.  On the coarse 16x8 book below the
# JAX package's own float32 theta is 2.8e-5 away from its float64 scan
# solve (solve_batch), so 2e-5 absolute is below the reference's own
# precision there; the port's float32 theta is 2.3e-5 away from it.
THETA_GATE_16x8 = dict(rtol=2e-5, atol=1e-4)


def _book_inputs(rng, B, grid):
    """Seeded book of B options (numpy draws) -> the march's inputs, built
    by the port's operator assembly."""
    draw = lambda lo, hi: rng.uniform(lo, hi, B)  # noqa: E731
    args = [torch.as_tensor(a, dtype=torch.float32) for a in (
        draw(1.0, 3.0), draw(0.02, 0.08), draw(0.2, 0.5), draw(-0.8, -0.3),
        draw(0.0, 0.08), draw(0.0, 0.04), draw(0.3, 1.0), draw(80.0, 120.0),
        (rng.uniform(size=B) < 0.5), (rng.uniform(size=B) < 0.5))]
    kappa, theta, sigma, rho, r, q, T, K, call, amer = args
    ins, _ = ta._march_inputs(kappa, theta, sigma, rho, r, q, T, K, call, amer,
                              grid["n_spot"], grid["n_vol"], grid["n_time"],
                              0.2, 5.0, 1.0)
    return list(ins)


@pytest.mark.parametrize("use_it", [False, True])
def test_k1_plain_matches_pallas(rng, use_it):
    grid = dict(n_spot=24, n_vol=12, n_time=8)
    ins = _book_inputs(rng, 6, grid)
    want = np.asarray(jops.fused_douglas_march_batched(
        *(a.numpy() for a in ins), **grid, use_it=use_it, interpret=True))
    before = tops.fused_douglas_march_batched.launches
    got = tops.fused_douglas_march_batched(*ins, **grid, use_it=use_it)
    assert got.shape == want.shape == (24, 12, 6)
    np.testing.assert_allclose(got.numpy(), want, **GATE)
    # a CPU tensor runs the plain twin, never the kernel
    assert tops.fused_douglas_march_batched.launches == before


def test_k1_rejects_bad_inputs(rng):
    grid = dict(n_spot=8, n_vol=5, n_time=2)
    ins = _book_inputs(rng, 2, grid)
    with pytest.raises(ValueError):  # wrong shape
        tops.fused_douglas_march_batched(*ins, n_spot=9, n_vol=5, n_time=2)
    with pytest.raises(ValueError):
        tops.fused_douglas_march_batched(*ins[:-1], ins[-1].double(), **grid)
    with pytest.raises(ValueError):  # neither a CUDA nor a CPU tensor
        tops.fused_douglas_march_batched(*(a.to("meta") for a in ins), **grid)


@pytest.mark.parametrize("method,amer", [
    ("projection", [0.0, 0.0, 0.0, 1.0]),
    ("it_lcp", [1.0, 1.0, 0.0, 1.0]),
])
def test_solve_fused_batch_mixed_book(method, amer):
    """The mixed book of tests/test_solvers.py:238-252: strikes,
    maturities, rates, kappa, calls/puts and European/American in ONE
    batch, both American treatments."""
    kw = dict(n_spot=24, n_vol=12, n_time=8)
    K = np.array([90.0, 100.0, 110.0, 100.0])
    T = np.array([0.5, 1.0, 1.5, 1.0])
    is_call = np.array([1.0, 0.0, 1.0, 0.0])
    kappa = np.array([2.0, 1.5, 2.0, 2.5])
    r = np.array([0.05, 0.05, 0.03, 0.08])
    q = np.array([0.02, 0.0, 0.02, 0.0])
    amer = np.array(amer)
    want = ja.solve_fused_batch(kappa, 0.04, 0.3, -0.7, 0.04, r, q, T, K, is_call,
                                100.0, american=amer, american_method=method,
                                interpret=True, **kw)
    got = ta.solve_fused_batch(kappa, 0.04, 0.3, -0.7, 0.04, r, q, T, K, is_call,
                               100.0, american=amer, american_method=method, **kw)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), err_msg=f, **GATE)
    np.testing.assert_allclose(got.prices.numpy(), np.asarray(want.prices), **GATE)


def test_solve_fused_batch_130_options():
    """A batch that is no multiple of 128 (tests/test_solvers.py:267-286):
    the port needs no lane padding."""
    kw = dict(n_spot=16, n_vol=8, n_time=4)
    B = 130
    K = np.linspace(80.0, 120.0, B)
    T = np.linspace(0.3, 1.2, B)
    is_call = (np.arange(B) % 2).astype(float)
    want = ja.solve_fused_batch(2.0, 0.04, 0.3, -0.7, 0.04, 0.05, 0.02, T, K,
                                is_call, 100.0, interpret=True, **kw)
    got = ta.solve_fused_batch(2.0, 0.04, 0.3, -0.7, 0.04, 0.05, 0.02, T, K,
                               is_call, 100.0, **kw)
    assert got.price.shape == (B,)
    for f in FIELDS:
        gate = THETA_GATE_16x8 if f == "theta" else GATE
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), err_msg=f, **gate)


def test_solve_fused_batch_rejections():
    args = (2.0, 0.04, 0.3, -0.7, 0.04, 0.05, 0.02, 1.0, 100.0, 1.0, 100.0)
    kw = dict(n_spot=16, n_vol=8, n_time=4)
    with pytest.raises(ValueError):
        ta.solve_fused_batch(*args, american=1.0, american_method="psor", **kw)
    for flag in ("pcr_v", "pcr_s"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            ta.solve_fused_batch(*args, **kw, **{flag: True})


def test_kernel_variant_resolves_from_callers_flags():
    assert ta.np_any_flag(np.array([0.0, 1.0]))
    assert not ta.np_any_flag(torch.zeros(3))
    assert not ta.np_any_flag(False)

"""The port's Black-Scholes solvers held against ``pde_tpu``.

K4 (``fused_cn_march_1d``): the JAX Pallas kernel in interpret mode against
the port's plain twin on identical seeded inputs, then the whole
``solve_fused_batch`` in both packages.  Both march in float32 in the same
step order with the same factorisation (a true divide in both), so the
gate is the repo's float32 variant gate, rtol 2e-5 / atol 2e-5
(tests/test_solvers.py:307-309).  ``solve`` (the scan route, every scheme
and American method) in float64 at 1e-8, the same recurrences in the same
order; ``reference_compat`` against the reference engine's golden values
at the tolerances of tests/test_golden_pde.py.  The CUDA kernels
themselves run only on the card: tests/test_torch_cuda.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from pde_tpu.ops import cn1d_fused as jops
from pde_tpu.solvers import bs_pde as jbs
from pde_tpu_torch import interop
from pde_tpu_torch.ops import cn1d_fused as tops
from pde_tpu_torch.solvers import bs_pde as tbs

with open(os.path.join(os.path.dirname(__file__), "golden",
                       "reference_pde_values.json")) as fh:
    GOLD = json.load(fh)

GATE = dict(rtol=2e-5, atol=2e-5)
FIELDS = ("price", "delta", "gamma", "theta", "prices", "spot_grid")


def _k4_inputs(rng, n, n_time, B):
    """A seeded mixed book as K4's (pay, sc), built by the port's own
    operator assembly."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    args = [t(a) for a in (rng.uniform(0.15, 0.45, B), rng.uniform(0.0, 0.08, B),
                           rng.uniform(0.0, 0.04, B), rng.uniform(0.25, 1.5, B),
                           rng.uniform(80.0, 120.0, B), rng.uniform(size=B) < 0.5,
                           np.arange(B) % 2 == 0)]
    pay, sc, _ = tbs._march_inputs(*args, n, n_time, 0.2, 5.0)
    return pay, sc


@pytest.mark.parametrize("w", [0.5, 1.0])
def test_k4_plain_matches_pallas(rng, w):
    n, n_time, B = 40, 10, 7
    pay, sc = _k4_inputs(rng, n, n_time, B)
    want = np.asarray(jops.fused_cn_march_1d(pay.numpy(), sc.numpy(), n_space=n,
                                             n_time=n_time, w=w, interpret=True))
    before = tops.fused_cn_march_1d.launches
    got = tops.fused_cn_march_1d(pay, sc, n_space=n, n_time=n_time, w=w)
    assert got.shape == want.shape == (n, B) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **GATE)
    # a CPU tensor runs the plain twin, never the kernel
    assert tops.fused_cn_march_1d.launches == before


def test_k4_rejects_bad_inputs(rng):
    pay, sc = _k4_inputs(rng, 12, 2, 3)
    kw = dict(n_space=12, n_time=2)
    with pytest.raises(ValueError):  # wrong shape
        tops.fused_cn_march_1d(pay, sc[:11], **kw)
    with pytest.raises(ValueError):  # float64
        tops.fused_cn_march_1d(pay.double(), sc, **kw)
    with pytest.raises(ValueError):  # neither a CUDA nor a CPU tensor
        tops.fused_cn_march_1d(pay.to("meta"), sc.to("meta"), **kw)
    with pytest.raises(ValueError):  # the payoff of another lattice
        tops.fused_cn_march_1d(pay[:-1], sc, **kw)
    with pytest.raises(ValueError):  # not contiguous
        tops.fused_cn_march_1d(pay.T.contiguous().T, sc, **kw)
    with pytest.raises(ValueError):  # too few steps
        tops.fused_cn_march_1d(pay, sc, n_space=12, n_time=0)
    with pytest.raises(RuntimeError, match="no backward"):
        tops.fused_cn_march_1d(pay.requires_grad_(), sc, **kw)


@pytest.mark.parametrize("n,plan", [(3, (1, 48)), (32, (1, 512)), (33, (2, 528)),
                                    (100, (4, 1600)), (200, (7, 3200)), (300, (10, 4800)),
                                    (512, (16, 8192)), (513, None), (4000, None)])
def test_k4_warp_plan(n, plan):
    """K4's warp route: ceil(n / 32) rows a lane (7 at the bench's n =
    200), at most the kernel's 16-row register chunk (n <= 512), and a
    block's shared memory the payoff/result tile of its four options; longer
    lattices take the first design (None)."""
    assert tops._warp_plan(n) == plan
    if plan is not None:
        ch, n_bytes = plan
        assert 32 * ch >= n > 32 * (ch - 1) and n_bytes == 4 * tops._TILE * n


@pytest.mark.parametrize("n,route", [(3, "warp"), (200, "warp"), (512, "warp"),
                                     (513, "first"), (600, "first")])
def test_k4_launch_follows_the_plan(monkeypatch, n, route):
    """The card's launcher takes the warp route exactly where _warp_plan
    gives a chunk, from n alone (the launchers stand in as fakes here)."""
    taken = []
    monkeypatch.setattr(tops, "_launch_warp", lambda *a: taken.append("warp"))
    monkeypatch.setattr(tops, "_launch_first", lambda *a: taken.append("first"))
    tops._launch(None, None, n, 4, 0.5)
    assert taken == [route]


@pytest.mark.parametrize("scheme", ["crank_nicolson", "implicit"])
def test_solve_fused_batch_mixed_book(scheme):
    """The mixed book of tests/test_solvers.py:89-95: vols, maturities,
    strikes, calls and puts, European and American in ONE batch."""
    sig = np.array([0.15, 0.2, 0.3, 0.25, 0.4])
    T = np.array([0.25, 0.5, 1.0, 1.5, 0.75])
    K = np.array([90.0, 95.0, 100.0, 105.0, 110.0])
    is_call = np.array([1.0, 0.0, 1.0, 0.0, 1.0])
    amer = np.array([0.0, 0.0, 0.0, 1.0, 1.0])
    kw = dict(n_space=96, n_time=24, scheme=scheme)
    want = jbs.solve_fused_batch(sig, 0.05, 0.01, T, K, is_call, 100.0, american=amer,
                                 interpret=True, **kw)
    got = tbs.solve_fused_batch(sig, 0.05, 0.01, T, K, is_call, 100.0, american=amer,
                                device="cpu", **kw)
    assert got.price.shape == (5,) and got.prices.shape == (5, 96)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   err_msg=f, **GATE)
    np.testing.assert_array_equal(got.early_exercise_optimal.numpy(),
                                  np.asarray(want.early_exercise_optimal))


def test_solve_fused_batch_130_options():
    """A batch that is no multiple of 128: the port needs no lane padding."""
    B = 130
    K = np.linspace(80.0, 120.0, B)
    T = np.linspace(0.25, 1.5, B)
    sig = np.linspace(0.15, 0.45, B)
    is_call = (np.arange(B) % 2).astype(float)
    kw = dict(n_space=32, n_time=10)
    want = jbs.solve_fused_batch(sig, 0.05, 0.01, T, K, is_call, 100.0,
                                 american=np.ones(B), interpret=True, **kw)
    got = tbs.solve_fused_batch(sig, 0.05, 0.01, T, K, is_call, 100.0,
                                american=np.ones(B), device="cpu", **kw)
    np.testing.assert_allclose(got.price.numpy(), np.asarray(want.price), **GATE)


def test_solve_fused_batch_rejections():
    args = (0.2, 0.05, 0.01, 1.0, 100.0, 1.0, 100.0)
    with pytest.raises(ValueError, match="scheme"):
        tbs.solve_fused_batch(*args, scheme="explicit", device="cpu")
    with pytest.raises(ValueError, match=">= 10"):
        tbs.solve_fused_batch(*args, n_space=8, device="cpu")


SOLVE_CASES = [(scheme, american, method)
               for scheme in ("crank_nicolson", "implicit", "explicit")
               for american, method in ((False, "projection"), (True, "projection"),
                                        (True, "psor"), (True, "brennan_schwartz"))]


@pytest.mark.parametrize("scheme,american,method", SOLVE_CASES)
def test_solve_matches_reference_f64(scheme, american, method):
    """solve: every scheme x American method, float64, 1e-8."""
    p = jbs.BSPDEParams(sigma=0.25, r=0.06, q=0.01, T=0.5, K=100.0, is_call=False,
                        american=american, american_method=method, n_space=40,
                        n_time=200 if scheme == "explicit" else 20, scheme=scheme)
    want = jbs.solve(p, 95.0)
    got = tbs.solve(interop.bs_pde_params(p), 95.0, device="cpu")
    assert got.prices.dtype == torch.float64
    for f in ("price", "delta", "gamma", "theta", "prices", "spot_grid"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-8, atol=1e-8, err_msg=f)
    assert bool(got.early_exercise_optimal) == bool(want.early_exercise_optimal)


BS_COMPAT = tbs.BSPDEParams(sigma=0.2, r=0.05, q=0.02, T=1.0, K=100.0, is_call=True,
                            reference_compat=True)


@pytest.mark.parametrize("case", ["euro_call", "euro_put", "amer_put", "off_strike"])
def test_reference_compat_matches_golden(case):
    """reference_compat=True reproduces the reference C++ engine's values
    (tests/golden/reference_pde_values.json) as tests/test_golden_pde.py
    holds the JAX package to them: 1e-10 absolute."""
    solve = lambda p, s0: tbs.solve(p, s0, device="cpu", dtype=torch.float64)  # noqa: E731
    near = lambda x, key: x == pytest.approx(GOLD[key], abs=1e-10)  # noqa: E731
    if case == "euro_call":
        r = solve(BS_COMPAT, 100.0)
        for f in ("price", "delta", "gamma", "theta"):
            assert near(float(getattr(r, f)), f"bs_pde_euro_call_{f}"), f
    elif case == "euro_put":
        assert near(float(solve(BS_COMPAT._replace(is_call=False), 100.0).price),
                    "bs_pde_euro_put_price")
    elif case == "amer_put":
        r = solve(BS_COMPAT._replace(is_call=False, american=True, r=0.08), 100.0)
        assert near(float(r.price), "bs_pde_amer_put_price")
        assert bool(r.early_exercise_optimal) == bool(GOLD["bs_pde_amer_put_early"])
    else:
        p = BS_COMPAT._replace(is_call=False)
        assert near(float(solve(p, 90.0).price), "bs_pde_euro_put_S90")
        assert near(float(solve(p, 115.0).price), "bs_pde_euro_put_S115")


def test_solve_rejections():
    p = tbs.BSPDEParams()
    for bad in (dict(sigma=0.0), dict(T=0.0), dict(K=-1.0), dict(n_space=8),
                dict(scheme="leapfrog")):
        with pytest.raises(ValueError):
            tbs.solve(p._replace(**bad), 100.0, device="cpu")

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
                               100.0, american=amer, american_method=method,
                               device="cpu", **kw)
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
                               is_call, 100.0, device="cpu", **kw)
    assert got.price.shape == (B,)
    for f in FIELDS:
        gate = THETA_GATE_16x8 if f == "theta" else GATE
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), err_msg=f, **gate)


def test_solve_fused_batch_rejections():
    args = (2.0, 0.04, 0.3, -0.7, 0.04, 0.05, 0.02, 1.0, 100.0, 1.0, 100.0)
    kw = dict(n_spot=16, n_vol=8, n_time=4, device="cpu")
    with pytest.raises(ValueError):
        ta.solve_fused_batch(*args, american=1.0, american_method="psor", **kw)
    # the PCR sweep variants are ported: they price, they do not raise
    for flag in ("pcr_v", "pcr_s"):
        assert bool(torch.isfinite(ta.solve_fused_batch(*args, **kw, **{flag: True}).price))


@pytest.mark.parametrize("variant", [dict(pcr_v=True), dict(pcr_s=True),
                                     dict(pcr_v=True, pcr_s=True)])
def test_pcr_variants_match_reference(variant):
    """K1's PCR sweeps (level coefficients once, two multiply-adds a level
    each step) in both packages on the mixed book of
    tests/test_solvers.py:288-309, at its 2e-5 variant gate."""
    kw = dict(n_spot=32, n_vol=16, n_time=8)
    K = np.array([90.0, 100.0, 110.0, 100.0])
    T = np.array([0.5, 1.0, 1.5, 1.0])
    is_call = np.array([1.0, 0.0, 1.0, 0.0])
    amer = np.array([0.0, 1.0, 0.0, 1.0])
    args = (2.0, 0.04, 0.3, -0.7, 0.04, 0.05, 0.02, T, K, is_call, 100.0)
    want = ja.solve_fused_batch(*args, american=amer, interpret=True, **kw, **variant)
    got = ta.solve_fused_batch(*args, american=amer, device="cpu", **kw, **variant)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   err_msg=f, **GATE)
    np.testing.assert_allclose(got.prices.numpy(), np.asarray(want.prices), **GATE)
    base = ta.solve_fused_batch(*args, american=amer, device="cpu", **kw)
    np.testing.assert_allclose(got.price.numpy(), base.price.numpy(), **GATE)


def test_kernel_variant_resolves_from_callers_flags():
    assert ta.np_any_flag(np.array([0.0, 1.0]))
    assert not ta.np_any_flag(torch.zeros(3))
    assert not ta.np_any_flag(False)


@pytest.mark.parametrize("use_it", [False, True])
@pytest.mark.parametrize("grid,lanes", [((100, 50), (8, 4)), ((40, 20), (16, 8)),
                                        ((16, 8), (16, 8)), ((50, 100), (4, 8))])
def test_k1_smem_plan(grid, lanes, use_it):
    """The shared-memory route's layout (csrc/adi_fused_batched.cu): lanes
    per S column and per v row are powers of two within the 512-thread
    block and at most one per row; the padded stride keeps the bench grid's
    first warp free of bank conflicts in both sweeps; the block's bytes are
    V, R, 1/pivot (and lambda with IT) on the padded grid plus the bands."""
    nS, nv = grid
    ps, gs, gv, n_bytes = tops._smem_plan(nS, nv, use_it)
    assert (gs, gv) == lanes
    assert nv * gs <= 512 and nS * gv <= 512 and gs <= nS and gv <= nv
    assert nv <= ps < nv + 32
    assert n_bytes == 4 * ((3 + use_it) * nS * ps + 15 * nv + 2 * nS) <= 232448
    if grid == (100, 50):
        cs, cv = -(-nS // gs), -(-nv // gv)
        assert tops._bank_degree([(t % gs) * cs * ps + t // gs for t in range(32)]) == 1
        assert tops._bank_degree([(t // gv) * ps + (t % gv) * cv for t in range(32)]) == 1


@pytest.mark.parametrize("use_it", [False, True])
def test_k1_large_grid_has_no_smem_plan(use_it):
    """200x100 needs 80 KB a field: more than a block's 227 KB, so the
    wrapper sends it to the first design (the reference takes such grids)."""
    assert tops._smem_plan(200, 100, use_it) is None


@pytest.mark.parametrize("use_it", [False, True])
def test_k1_pcr_s_smem_plan(use_it):
    """The PCR S sweep on the shared-memory route: the Thomas route's lanes
    and stride; V, R, 1/d, the ping-pong grid (and lambda with IT) on the
    padded grid, the double buffer of two levels of alpha and beta for each
    S-sweep thread's chunk (or the factorisation's three bands, if more)
    and the bands, within a block's 227 KB at 100x50.  None where the state
    outgrows a block (200x100) or the columns' lane groups outgrow the
    512-thread block (nv = 600)."""
    ps, gs, gv, n_bytes = tops._smem_plan(100, 50, use_it, True)
    assert (ps, gs, gv) == tops._smem_plan(100, 50, use_it)[:3] == (52, 8, 4)
    cs = -(-100 // gs)
    buffer = max(4 * cs * 50 * gs, 3 * 100 * ps)
    assert buffer == tops._pcr_buffer(100, 50, ps, gs) == 20800
    assert n_bytes == 4 * ((4 + use_it) * 100 * ps + buffer + 15 * 50 + 2 * 100) <= 232448
    assert n_bytes == (191000 if use_it else 170200)
    assert tops._smem_plan(200, 100, use_it, True) is None
    assert tops._smem_plan(4, 600, use_it) is not None
    assert tops._smem_plan(4, 600, use_it, True) is None


@pytest.mark.parametrize("pcr_v,pcr_s", [(False, False), (False, True), (True, False),
                                         (True, True)])
def test_k1_route_resolves_from_flags(pcr_v, pcr_s):
    """The wrapper's route: the Thomas march and each PCR variant (the v
    sweep, the S sweep, both) take the shared-memory design at 100x50, each
    with its own plan; a grid too large for a block takes the first design
    (no plan) whatever the flags."""
    for use_it in (False, True):
        plan = tops._route_plan(100, 50, use_it, pcr_v, pcr_s)
        assert plan == tops._smem_plan(100, 50, use_it, pcr_s, pcr_v) is not None
        assert plan[:3] == (52, 8, 4)
        assert plan[3] == {(False, False): 66200, (True, False): 87000,
                           (False, True): 170200, (True, True): 191000}[use_it, pcr_s] \
            + (2200 if pcr_v else 0)
        assert tops._route_plan(200, 100, use_it, pcr_v, pcr_s) is None


@pytest.mark.parametrize("use_it", [False, True])
@pytest.mark.parametrize("grid", [(100, 50), (40, 20), (16, 8)])
def test_k1_pcr_v_smem_plan(grid, use_it):
    """The PCR v sweep on the shared-memory route: its level coefficients
    (alpha and beta of each of levels_v levels, then 1/d) take the place of
    the Thomas v factors in shared memory, 2 levels_v nv + nv floats for
    2 nv, and it ping-pongs through V's own row, so it adds no field.
    Alone it stays under the ~113 KB that lets two blocks share an SM."""
    nS, nv = grid
    base = tops._smem_plan(nS, nv, use_it)
    plan = tops._smem_plan(nS, nv, use_it, False, True)
    assert plan[:3] == base[:3]
    assert plan[3] == base[3] + 4 * (2 * tops._levels(nv) - 1) * nv
    assert plan[3] <= 232448 // 2
    both = tops._smem_plan(nS, nv, use_it, True, True)
    assert both[3] == tops._smem_plan(nS, nv, use_it, True)[3] + plan[3] - base[3]
    if grid == (100, 50):
        assert (plan[3], both[3]) == ((89200, 193200) if use_it else (68400, 172400))


def test_k1_first_design_builds_without_contraction(monkeypatch, tmp_path):
    """K1's first design launches from a second build of its source without
    FMA contraction (so that it rounds as the plain twin does), the
    shared-memory routes from the default build; both need nvcc, and
    without it the build raises rather than falls back."""
    from pde_tpu_torch.ops import build

    file, extra = build.VARIANTS[tops._SOURCE_EXACT]
    assert file == tops._SOURCE and (build.CSRC / file).exists()
    assert extra == ("-fmad=false",) and "-fmad=false" not in build.SOURCE_FLAGS.get(file, ())
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "NVCC_DEFAULT", str(build.CSRC / "no-nvcc-here"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    for source in (tops._SOURCE, tops._SOURCE_EXACT):
        monkeypatch.delitem(build._LOADED, source, raising=False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.load_library(source)
    assert not (tmp_path / "build").exists()  # nothing half built is left

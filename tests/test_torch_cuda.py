"""The port's CUDA kernels on the card (marked ``cuda``; each test skips
without a GPU).  This file imports neither JAX nor the JAX package, so it
also runs on a machine that has only PyTorch, from the repository root:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from pde_tpu_torch.models import local_vol
from pde_tpu_torch.ops import adi_fused, cn1d_fused, cn1d_tv_fused, tridiag
from pde_tpu_torch.solvers import bs_pde, heston_adi, hjb, lcp, local_vol_pde

# kernel vs plain twin: both float32 with the same step order; FMA
# contraction (K1, K2, K3) and the order in which the lane scans of K1, K2,
# K3, K4 and K5 compose the values entering each chunk differ
GATE = dict(rtol=1e-4, atol=1e-5)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _book(B, seed):
    """Seeded book (numpy draws) as solve_fused_batch arguments."""
    rng = np.random.default_rng(seed)
    draw = lambda lo, hi: rng.uniform(lo, hi, B)  # noqa: E731
    return dict(kappa=draw(1.0, 3.0), theta=draw(0.02, 0.08), sigma=draw(0.2, 0.5),
                rho=draw(-0.8, -0.3), v0=draw(0.02, 0.06), r=draw(0.0, 0.08),
                q=draw(0.0, 0.04), T=draw(0.3, 1.0), K=draw(80.0, 120.0),
                is_call=(rng.uniform(size=B) < 0.5), S0=100.0,
                american=(rng.uniform(size=B) < 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("use_it", [False, True])
def test_kernel_matches_plain(use_it):
    _need_cuda()
    book = _book(33, 1)
    args = heston_adi._broadcast_batch(*book.values(), "cuda")
    kappa, theta, sigma, rho, _, r, q, T, K, call, _, amer = args
    ins, _ = heston_adi._march_inputs(kappa, theta, sigma, rho, r, q, T, K, call,
                                      amer, 40, 20, 20, 0.2, 5.0, 1.0)
    before = adi_fused.fused_douglas_march_batched.launches
    got = adi_fused.fused_douglas_march_batched(*ins, 40, 20, 20, use_it=use_it)
    want = adi_fused._fused_douglas_march_batched_plain(*ins, 40, 20, 20, use_it)
    torch.cuda.synchronize()
    assert adi_fused.fused_douglas_march_batched.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["projection", "it_lcp"])
def test_book_on_card_matches_cpu(method):
    """solve_fused_batch through the kernel (card) and through the plain
    twin (CPU) on one book."""
    _need_cuda()
    book = _book(70, 2)
    kw = dict(n_spot=40, n_vol=20, n_time=20, american_method=method)
    on_card = heston_adi.solve_fused_batch(**book, **kw, device="cuda")
    on_cpu = heston_adi.solve_fused_batch(**book, **kw, device="cpu")
    for f in ("price", "delta", "gamma", "vega"):
        np.testing.assert_allclose(getattr(on_card, f).cpu().numpy(),
                                   getattr(on_cpu, f).numpy(), err_msg=f, **GATE)


def _surface(device):
    """A seeded local-vol grid as an interpolator on ``device``."""
    rng = np.random.default_rng(3)
    return local_vol.SurfaceInterpolator(np.linspace(60.0, 150.0, 9), [0.1, 0.5, 1.0, 2.0],
                                         0.15 + 0.2 * rng.random((4, 9)), device=device,
                                         dtype=torch.float32)


def _lv_book(B, seed):
    rng = np.random.default_rng(seed)
    return dict(K=rng.uniform(80.0, 120.0, B), T=rng.uniform(0.25, 1.5, B),
                is_call=(rng.uniform(size=B) < 0.5).astype(float),
                american=(rng.uniform(size=B) < 0.5).astype(float))


@pytest.mark.cuda
@pytest.mark.parametrize("w", [0.5, 1.0])
def test_k3_matches_plain(w):
    _need_cuda()
    dev = torch.device("cuda")
    book = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
            for k, v in _lv_book(45, 4).items()}
    pay, bands, sc, _ = local_vol_pde._march_inputs(
        _surface(dev), book["K"], book["T"], book["is_call"], book["american"], 0.04,
        0.01, 64, 24, 0.2, 5.0)
    before = cn1d_tv_fused.fused_cn_march_1d_tv.launches
    got = cn1d_tv_fused.fused_cn_march_1d_tv(pay, bands, sc, 64, 24, w)
    want = cn1d_tv_fused._fused_cn_march_1d_tv_plain(pay, bands, sc, 64, 24, w)
    torch.cuda.synchronize()
    assert cn1d_tv_fused.fused_cn_march_1d_tv.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [0.5, 1.0])
def test_k4_matches_plain(w):
    _need_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    B = 70
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    pay, sc, _ = bs_pde._march_inputs(
        t(rng.uniform(0.15, 0.45, B)), t(rng.uniform(0.0, 0.08, B)),
        t(rng.uniform(0.0, 0.04, B)), t(rng.uniform(0.25, 1.5, B)),
        t(rng.uniform(80.0, 120.0, B)), t(rng.uniform(size=B) < 0.5),
        t(rng.uniform(size=B) < 0.5), 64, 24, 0.2, 5.0)
    before = cn1d_fused.fused_cn_march_1d.launches
    got = cn1d_fused.fused_cn_march_1d(pay, sc, 64, 24, w)
    want = cn1d_fused._fused_cn_march_1d_plain(pay, sc, 64, 24, w)
    torch.cuda.synchronize()
    assert cn1d_fused.fused_cn_march_1d.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


@pytest.mark.cuda
def test_local_vol_book_on_card_matches_cpu():
    """solve_fused_batch through K3 (card) and through its plain twin (CPU)."""
    _need_cuda()
    book = _lv_book(50, 6)
    kw = dict(r=0.04, q=0.01, n_space=64, n_time=24)
    on_card = local_vol_pde.solve_fused_batch(_surface("cuda"), 100.0, **book, **kw,
                                              device="cuda")
    on_cpu = local_vol_pde.solve_fused_batch(_surface("cpu"), 100.0, **book, **kw,
                                             device="cpu")
    for f in ("price", "delta", "gamma"):
        np.testing.assert_allclose(getattr(on_card, f).cpu().numpy(),
                                   getattr(on_cpu, f).numpy(), err_msg=f, **GATE)


@pytest.mark.cuda
def test_bs_book_on_card_matches_cpu():
    """solve_fused_batch through K4 (card) and through its plain twin (CPU)."""
    _need_cuda()
    rng = np.random.default_rng(7)
    B = 60
    args = (rng.uniform(0.15, 0.45, B), 0.05, 0.01, rng.uniform(0.25, 1.5, B),
            rng.uniform(80.0, 120.0, B), (rng.uniform(size=B) < 0.5).astype(float), 100.0)
    kw = dict(american=(rng.uniform(size=B) < 0.5).astype(float), n_space=64, n_time=24)
    on_card = bs_pde.solve_fused_batch(*args, **kw, device="cuda")
    on_cpu = bs_pde.solve_fused_batch(*args, **kw, device="cpu")
    for f in ("price", "delta", "gamma", "theta"):
        np.testing.assert_allclose(getattr(on_card, f).cpu().numpy(),
                                   getattr(on_cpu, f).numpy(), err_msg=f, **GATE)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["pcr_v", "pcr_s"])
def test_k1_pcr_matches_plain(variant):
    """K1's PCR sweeps against the plain twin's, IT-LCP and projection mixed."""
    _need_cuda()
    book = _book(33, 8)
    args = heston_adi._broadcast_batch(*book.values(), "cuda")
    kappa, theta, sigma, rho, _, r, q, T, K, call, _, amer = args
    ins, _ = heston_adi._march_inputs(kappa, theta, sigma, rho, r, q, T, K, call,
                                      amer, 40, 20, 20, 0.2, 5.0, 1.0)
    k1 = adi_fused.fused_douglas_march_batched
    before = getattr(k1, "launches_" + variant)
    for use_it in (False, True):
        got = k1(*ins, 40, 20, 20, use_it=use_it, **{variant: True})
        want = adi_fused._fused_douglas_march_batched_plain(*ins, 40, 20, 20, use_it,
                                                            **{variant: True})
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)
    assert getattr(k1, "launches_" + variant) == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", [{}, dict(is_call=False, american=True, r=0.08, q=0.0),
                                  dict(is_call=False, american=True, r=0.08, q=0.0,
                                       american_method="it_lcp")])
def test_k2_matches_plain(case):
    """K2 against its plain twin at 40x20 (the shared-memory route)."""
    _need_cuda()
    p = heston_adi.HestonPDEParams(q=0.02, n_spot=40, n_vol=20, n_time=20)._replace(**case)
    t = lambda k: torch.tensor(float(getattr(p, k)), device="cuda")  # noqa: E731
    args, _ = heston_adi._fused_inputs(p, *(t(k) for k in ("kappa", "theta", "sigma", "rho",
                                                           "r", "q", "T", "K")))
    before = adi_fused.fused_douglas_march.launches
    got = adi_fused.fused_douglas_march(*args, 40, 20, 20)
    want = adi_fused._fused_douglas_march_plain(*adi_fused._stack_single(*args), 40, 20, 20)
    torch.cuda.synchronize()
    assert adi_fused.fused_douglas_march.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


def _tridiagonal(B, n, seed, dev="cuda"):
    """Seeded diagonally dominant systems (B, n) in float32 on ``dev``."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return (t(rng.uniform(-1, 0, (B, n - 1))), t(2.5 + rng.uniform(0, 1, (B, n))),
            t(rng.uniform(-1, 0, (B, n - 1))), t(rng.normal(size=(B, n))),
            t(rng.uniform(-0.5, 0.5, (B, n))))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(300, 64), (5, 200)])
def test_k5_matches_plain(B, n):
    """K5 through tridiagonal_solve's kernel branch against its twin."""
    _need_cuda()
    lower, diag, upper, rhs, _ = _tridiagonal(B, n, 9)
    before = tridiag.thomas_batched.launches
    got = tridiag.tridiagonal_solve(lower, diag, upper, rhs)
    want = tridiag._thomas_batched_plain(lower, diag, upper, rhs)
    torch.cuda.synchronize()
    assert tridiag.thomas_batched.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


@pytest.mark.cuda
@pytest.mark.parametrize("with_x0", [False, True])
def test_k6_matches_plain(with_x0):
    """K6 against its plain twin, the port's projected_sor in float32."""
    _need_cuda()
    lower, diag, upper, b, g = _tridiagonal(64, 100, 10)
    x0 = 0.5 * b if with_x0 else None
    before = lcp.projected_sor_batched.launches
    got, resid = lcp.projected_sor_batched(lower, diag, upper, b, g, n_iter=80, x0=x0)
    want, _ = lcp._projected_sor(lower, diag, upper, b, g, x0, 1.5, 80)
    torch.cuda.synchronize()
    assert lcp.projected_sor_batched.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)
    assert float(resid) < 1e-2


@pytest.mark.cuda
def test_heston_solve_on_card_matches_cpu():
    """heston_adi.solve with its sweeps on K5 (card) and on the factored
    Thomas solve (CPU), both float32."""
    _need_cuda()
    p = heston_adi.HestonPDEParams(q=0.02, n_spot=40, n_vol=20, n_time=20)
    before = tridiag.thomas_batched.launches
    on_card = heston_adi.solve(p, 100.0, device="cuda")
    assert tridiag.thomas_batched.launches > before
    on_cpu = heston_adi.solve(p, 100.0, device="cpu")
    for f in ("price", "delta", "gamma", "vega"):
        np.testing.assert_allclose(float(getattr(on_card, f)), float(getattr(on_cpu, f)),
                                   err_msg=f, **GATE)


@pytest.mark.cuda
def test_bs_solve_psor_on_card_matches_cpu():
    """bs_pde.solve(american_method="psor") with each step's LCP on K6
    (card) and on the tensor-op sweeps (CPU), both float32."""
    _need_cuda()
    p = bs_pde.BSPDEParams(is_call=False, american=True, american_method="psor",
                           n_space=64, n_time=20)
    before = lcp.projected_sor_batched.launches
    on_card = bs_pde.solve(p, 100.0, device="cuda")
    assert lcp.projected_sor_batched.launches == before + 20
    on_cpu = bs_pde.solve(p, 100.0, device="cpu")
    for f in ("price", "delta", "gamma", "theta"):
        np.testing.assert_allclose(float(getattr(on_card, f)), float(getattr(on_cpu, f)),
                                   err_msg=f, **GATE)


def _k1_inputs(B, n_spot, n_vol, n_time, seed):
    """K1's inputs for a seeded book on ``n_spot`` x ``n_vol`` on the card."""
    args = heston_adi._broadcast_batch(*_book(B, seed).values(), "cuda")
    kappa, theta, sigma, rho, _, r, q, T, K, call, _, amer = args
    ins, _ = heston_adi._march_inputs(kappa, theta, sigma, rho, r, q, T, K, call, amer,
                                      n_spot, n_vol, n_time, 0.2, 5.0, 1.0)
    return ins


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["european", "projection", "it"])
@pytest.mark.parametrize("grid", [(16, 8), (40, 20), (100, 50)])
@pytest.mark.parametrize("B", [1, 37, 130])
def test_k1_smem_route_matches_plain(B, grid, mode):
    """K1's shared-memory route (lane-group scans) against the plain twin
    at ragged batch sizes and grids; the projection and IT books mix
    American and European options."""
    _need_cuda()
    nS, nv = grid
    ins = list(_k1_inputs(B, nS, nv, 20, 11))
    if mode == "european":
        ins[7] = ins[7].clone()
        ins[7][5] = 0.0
    k1 = adi_fused.fused_douglas_march_batched
    before, before_smem = k1.launches, k1.launches_smem
    got = k1(*ins, nS, nv, 20, use_it=mode == "it")
    want = adi_fused._fused_douglas_march_batched_plain(*ins, nS, nv, 20, mode == "it")
    torch.cuda.synchronize()
    assert (k1.launches, k1.launches_smem) == (before + 1, before_smem + 1)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


@pytest.mark.cuda
@pytest.mark.parametrize("use_it", [False, True])
def test_k1_large_grid_takes_first_design(use_it):
    """A grid whose state exceeds a block's shared memory (200x100: 80 KB
    a field) runs the first design, and agrees with the twin."""
    _need_cuda()
    assert adi_fused._smem_plan(200, 100, use_it) is None
    ins = _k1_inputs(5, 200, 100, 10, 12)
    k1 = adi_fused.fused_douglas_march_batched
    before, before_smem = k1.launches, k1.launches_smem
    got = k1(*ins, 200, 100, 10, use_it=use_it)
    want = adi_fused._fused_douglas_march_batched_plain(*ins, 200, 100, 10, use_it)
    torch.cuda.synchronize()
    assert (k1.launches, k1.launches_smem) == (before + 1, before_smem)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [0.5, 1.0])
@pytest.mark.parametrize("B", [1, 7, 37, 256])
@pytest.mark.parametrize("n", [3, 33, 200])
def test_k3_warp_route_matches_plain(n, B, w):
    """K3's warp route against its twin where a lane's chunk holds one row
    or none (n = 3, 33) and at the bench width, at ragged batch sizes
    (partial blocks of eight options)."""
    _need_cuda()
    dev = torch.device("cuda")
    book = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
            for k, v in _lv_book(B, 13).items()}
    pay, bands, sc, _ = local_vol_pde._march_inputs(
        _surface(dev), book["K"], book["T"], book["is_call"], book["american"], 0.04,
        0.01, n, 24, 0.2, 5.0)
    k3 = cn1d_tv_fused.fused_cn_march_1d_tv
    before = k3.launches_smem
    got = k3(pay, bands, sc, n, 24, w)
    want = cn1d_tv_fused._fused_cn_march_1d_tv_plain(pay, bands, sc, n, 24, w)
    torch.cuda.synchronize()
    assert k3.launches_smem == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


@pytest.mark.cuda
def test_k3_long_lattice_takes_first_design():
    """A lattice too long for the warp route's shared memory (n = 600)
    runs the first design, and agrees with the twin."""
    _need_cuda()
    assert cn1d_tv_fused._smem_bytes(600) is None
    dev = torch.device("cuda")
    book = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
            for k, v in _lv_book(5, 14).items()}
    pay, bands, sc, _ = local_vol_pde._march_inputs(
        _surface(dev), book["K"], book["T"], book["is_call"], book["american"], 0.04,
        0.01, 600, 6, 0.2, 5.0)
    k3 = cn1d_tv_fused.fused_cn_march_1d_tv
    before, before_smem = k3.launches, k3.launches_smem
    got = k3(pay, bands, sc, 600, 6)
    want = cn1d_tv_fused._fused_cn_march_1d_tv_plain(pay, bands, sc, 600, 6, 0.5)
    torch.cuda.synchronize()
    assert (k3.launches, k3.launches_smem) == (before + 1, before_smem)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


K2_MODES = {"european": {}, "projection": dict(is_call=False, american=True, r=0.08, q=0.0),
            "it_lcp": dict(is_call=False, american=True, r=0.08, q=0.0,
                           american_method="it_lcp")}


def _k2_inputs(n_spot, n_vol, n_time, mode):
    """K2's public inputs for bench_full.py's option at ``n_spot`` x
    ``n_vol`` on the card, in one of the three exercise modes."""
    p = heston_adi.HestonPDEParams(q=0.02, n_spot=n_spot, n_vol=n_vol,
                                   n_time=n_time)._replace(**K2_MODES[mode])
    t = lambda k: torch.tensor(float(getattr(p, k)), device="cuda")  # noqa: E731
    return heston_adi._fused_inputs(p, *(t(k) for k in ("kappa", "theta", "sigma", "rho",
                                                        "r", "q", "T", "K")))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(K2_MODES))
@pytest.mark.parametrize("grid", [(16, 8), (40, 20), (100, 50), (160, 50)])
def test_k2_smem_route_matches_plain(grid, mode):
    """K2's shared-memory route (lane-group scans) against its twin; at
    160x50 the bands no longer fit beside the state and are read in place."""
    _need_cuda()
    nS, nv = grid
    plan = adi_fused._smem_plan_single(nS, nv)
    assert plan is not None and plan[3] == (grid != (160, 50))
    args = _k2_inputs(nS, nv, 20, mode)
    k2 = adi_fused.fused_douglas_march
    before, before_smem = k2.launches, k2.launches_smem
    got = k2(*args, nS, nv, 20)
    want = adi_fused._fused_douglas_march_plain(*adi_fused._stack_single(*args), nS, nv, 20)
    torch.cuda.synchronize()
    assert (k2.launches, k2.launches_smem) == (before + 1, before_smem + 1)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


@pytest.mark.cuda
def test_k2_large_grid_takes_first_design():
    """A grid whose state exceeds a block's shared memory (200x100) runs
    K2's first design, and agrees with the twin."""
    _need_cuda()
    assert adi_fused._smem_plan_single(200, 100) is None
    args = _k2_inputs(200, 100, 10, "it_lcp")
    k2 = adi_fused.fused_douglas_march
    before, before_smem = k2.launches, k2.launches_smem
    got = k2(*args, 200, 100, 10)
    want = adi_fused._fused_douglas_march_plain(*adi_fused._stack_single(*args), 200, 100, 10)
    torch.cuda.synchronize()
    assert (k2.launches, k2.launches_smem) == (before + 1, before_smem)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


@pytest.mark.cuda
@pytest.mark.parametrize("use_it", [False, True])
@pytest.mark.parametrize("grid", [(40, 20), (100, 50)])
@pytest.mark.parametrize("B", [1, 37, 130, 512])
def test_k1_pcr_s_smem_route_matches_plain(B, grid, use_it):
    """K1's PCR S sweep on the shared-memory route (levels streamed a level
    ahead) against the twin's, European and IT-LCP books (mixed American
    and European options)."""
    _need_cuda()
    nS, nv = grid
    ins = list(_k1_inputs(B, nS, nv, 20, 15))
    if not use_it:
        ins[7] = ins[7].clone()
        ins[7][5] = 0.0
    k1 = adi_fused.fused_douglas_march_batched
    before = (k1.launches_smem, k1.launches_pcr_s, k1.launches_pcr_s_smem)
    got = k1(*ins, nS, nv, 20, use_it=use_it, pcr_s=True)
    want = adi_fused._fused_douglas_march_batched_plain(*ins, nS, nv, 20, use_it, pcr_s=True)
    torch.cuda.synchronize()
    assert (k1.launches_smem, k1.launches_pcr_s, k1.launches_pcr_s_smem) == \
        tuple(n + 1 for n in before)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


@pytest.mark.cuda
@pytest.mark.parametrize("use_it", [False, True])
@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("grid", [(16, 8), (40, 20), (100, 50)])
@pytest.mark.parametrize("variant", [dict(pcr_v=True), dict(pcr_v=True, pcr_s=True)])
def test_k1_pcr_v_smem_route_matches_plain(variant, grid, B, use_it):
    """The PCR v sweep, alone and with the PCR S sweep, on the
    shared-memory route (level coefficients in shared memory, a level a
    __syncwarp) against the twin's, European and IT-LCP books."""
    _need_cuda()
    nS, nv = grid
    ins = list(_k1_inputs(B, nS, nv, 20, 17))
    if not use_it:
        ins[7] = ins[7].clone()
        ins[7][5] = 0.0
    k1 = adi_fused.fused_douglas_march_batched
    counts = ("launches", "launches_smem", "launches_pcr_v_smem", "launches_pcr_s_smem")
    before = [getattr(k1, c) for c in counts]
    got = k1(*ins, nS, nv, 20, use_it=use_it, **variant)
    want = adi_fused._fused_douglas_march_batched_plain(*ins, nS, nv, 20, use_it, **variant)
    torch.cuda.synchronize()
    moved = [getattr(k1, c) - n for c, n in zip(counts, before)]
    assert moved == [1, 1, 1, int(variant.get("pcr_s", False))]
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [dict(pcr_v=True), dict(pcr_v=True, pcr_s=True)])
def test_k1_pcr_v_takes_first_design(variant):
    """The PCR v sweep, alone or with the PCR S sweep, runs the first design
    on a grid too large for the shared-memory route (200x100)."""
    _need_cuda()
    assert adi_fused._route_plan(200, 100, True, True, variant.get("pcr_s", False)) is None
    ins = _k1_inputs(5, 200, 100, 10, 16)
    k1 = adi_fused.fused_douglas_march_batched
    before = (k1.launches, k1.launches_smem, k1.launches_pcr_v, k1.launches_pcr_v_smem)
    got = k1(*ins, 200, 100, 10, use_it=True, **variant)
    want = adi_fused._fused_douglas_march_batched_plain(*ins, 200, 100, 10, True, **variant)
    torch.cuda.synchronize()
    assert (k1.launches, k1.launches_smem, k1.launches_pcr_v, k1.launches_pcr_v_smem) == \
        (before[0] + 1, before[1], before[2] + 1, before[3])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


def _shared_bands(B, n, seed):
    """Seeded systems whose three bands are one row expanded over the
    batch (batch stride 0), as the scan's v sweep gives them."""
    lower, diag, upper, rhs, _ = _tridiagonal(1, n, seed)
    return lower.expand(B, -1), diag.expand(B, -1), upper.expand(B, -1), \
        torch.randn((B, n), generator=torch.Generator("cuda").manual_seed(seed), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,shared", [(50, 100, False), (100, 50, True), (1, 200, True),
                                        (37, 100, False), (37, 50, True), (512, 200, False)])
def test_k5_lane_route_matches_plain(B, n, shared):
    """K5's lane-group route (Moebius scan of the pivots, affine scans of
    both sweeps) against its twin at the scan paths' shapes, with bands
    shared by every system (read in place, batch stride 0) and ragged
    batches (a partly filled last block)."""
    _need_cuda()
    system = _shared_bands(B, n, 18) if shared else _tridiagonal(B, n, 18)[:4]
    k5 = tridiag.thomas_batched
    before = (k5.launches, k5.launches_smem)
    got = k5(*system)
    want = tridiag._thomas_batched_plain(*system)
    torch.cuda.synchronize()
    assert (k5.launches, k5.launches_smem) == (before[0] + 1, before[1] + 1)
    assert got.shape == (B, n) and got.is_contiguous()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


@pytest.mark.cuda
def test_k5_long_systems_take_first_design():
    """Systems too long for the lane-group route's shared memory (n = 4000)
    run the first design, and agree with the twin."""
    _need_cuda()
    assert tridiag._lane_plan(4000) is None
    system = _tridiagonal(3, 4000, 19)[:4]
    k5 = tridiag.thomas_batched
    before = (k5.launches, k5.launches_smem)
    got = k5(*system)
    want = tridiag._thomas_batched_plain(*system)
    torch.cuda.synchronize()
    assert (k5.launches, k5.launches_smem) == (before[0] + 1, before[1])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


def _k4_book(B, n, n_time, seed, dev="cuda"):
    """K4's (pay, sc) for a seeded book with mixed American flags."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return bs_pde._march_inputs(
        t(rng.uniform(0.15, 0.45, B)), t(rng.uniform(0.0, 0.08, B)),
        t(rng.uniform(0.0, 0.04, B)), t(rng.uniform(0.25, 1.5, B)),
        t(rng.uniform(80.0, 120.0, B)), t(rng.uniform(size=B) < 0.5),
        t(rng.uniform(size=B) < 0.5), n, n_time, 0.2, 5.0)[:2]


@pytest.mark.cuda
@pytest.mark.parametrize("w", [0.5, 1.0])
@pytest.mark.parametrize("B", [1, 7, 37, 512])
@pytest.mark.parametrize("n", [3, 33, 100, 200, 300, 512])
def test_k4_warp_route_matches_plain(n, B, w):
    """K4's warp route against its twin where a lane's chunk holds one row
    or none (n = 3, 33), on each register chunk (4, 8 and 16 slots a lane;
    at n = 300 a lane uses 10 of its 16, at 512 all) and at the bench width
    (200), at ragged batch sizes (partial blocks), with mixed American
    flags."""
    _need_cuda()
    pay, sc = _k4_book(B, n, 24, 24)
    k4 = cn1d_fused.fused_cn_march_1d
    before = (k4.launches, k4.launches_warp)
    got = k4(pay, sc, n, 24, w)
    want = cn1d_fused._fused_cn_march_1d_plain(pay, sc, n, 24, w)
    torch.cuda.synchronize()
    assert (k4.launches, k4.launches_warp) == (before[0] + 1, before[1] + 1)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **GATE)


@pytest.mark.cuda
def test_k4_long_lattice_takes_first_design():
    """A lattice longer than the warp route's register chunk (n = 600) runs
    the first design, and equals the twin bit for bit."""
    _need_cuda()
    assert cn1d_fused._warp_plan(600) is None
    pay, sc = _k4_book(5, 600, 6, 25)
    k4 = cn1d_fused.fused_cn_march_1d
    before = (k4.launches, k4.launches_warp)
    got = k4(pay, sc, 600, 6)
    want = cn1d_fused._fused_cn_march_1d_plain(pay, sc, 600, 6, 0.5)
    torch.cuda.synchronize()
    assert (k4.launches, k4.launches_warp) == (before[0] + 1, before[1])
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def _k6_check(B, n, seed, with_x0, warp):
    """K6 through the public wrapper against its twin, bit for bit, with
    the route checked and the residual equal to _residual on the result."""
    lower, diag, upper, b, g = _tridiagonal(B, n, seed)
    x0 = 0.5 * b if with_x0 else None
    k6 = lcp.projected_sor_batched
    before = (k6.launches, k6.launches_warp)
    got, resid = k6(lower, diag, upper, b, g, n_iter=40, x0=x0)
    want, _ = lcp._projected_sor(lower, diag, upper, b, g, x0, 1.5, 40)
    torch.cuda.synchronize()
    assert (k6.launches, k6.launches_warp) == (before[0] + 1, before[1] + int(warp))
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert float(resid) == float(lcp._residual(lower, diag, upper, b, g, got))


@pytest.mark.cuda
@pytest.mark.parametrize("with_x0", [False, True])
@pytest.mark.parametrize("B", [1, 5, 512])
@pytest.mark.parametrize("n", [2, 3, 33, 100, 150, 200, 256])
def test_k6_warp_route_matches_plain(n, B, with_x0):
    """K6's warp route (one warp per system, branch-free exact division,
    the residual in the kernel) equals its twin bit for bit, where a lane
    holds part of a chunk or none (n = 2, 3, 33), on each register chunk
    (2, 4 and 8 slots a lane; slots past the chunk at n = 150, all used at
    256) and at the bench width (200), at ragged batch sizes, with and
    without a start."""
    _need_cuda()
    _k6_check(B, n, 26, with_x0, warp=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [257, 300, 512, 600])
def test_k6_long_systems_take_first_design(n):
    """Systems longer than the warp route's register chunk (n > 256) run
    the first design, bit for bit, the residual computed in PyTorch."""
    _need_cuda()
    assert lcp._warp_plan(n) is None
    _k6_check(3, n, 27, True, warp=False)


def _guard_cases():
    """Each kernel wrapper with small inputs on the card: (wrapper, inputs,
    call)."""
    dev = "cuda"
    ins = _k1_inputs(3, 12, 6, 3, 20)
    k2 = _k2_inputs(12, 6, 3, "european")
    book = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
            for k, v in _lv_book(3, 21).items()}
    k3 = local_vol_pde._march_inputs(_surface(dev), book["K"], book["T"], book["is_call"],
                                     book["american"], 0.04, 0.01, 16, 3, 0.2, 5.0)[:3]
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    k4 = bs_pde._march_inputs(t([0.2, 0.3]), t([0.05, 0.05]), t([0.01, 0.0]), t([1.0, 0.5]),
                              t([100.0, 90.0]), t([1.0, 0.0]), t([0.0, 1.0]), 16, 3, 0.2,
                              5.0)[:2]
    system = _tridiagonal(4, 10, 22)
    return {
        "K1": (adi_fused.fused_douglas_march_batched, list(ins),
               lambda *a: adi_fused.fused_douglas_march_batched(*a, 12, 6, 3)),
        "K2": (adi_fused.fused_douglas_march, list(k2),
               lambda *a: adi_fused.fused_douglas_march(*a, 12, 6, 3)),
        "K3": (cn1d_tv_fused.fused_cn_march_1d_tv, list(k3),
               lambda *a: cn1d_tv_fused.fused_cn_march_1d_tv(*a, 16, 3)),
        "K4": (cn1d_fused.fused_cn_march_1d, list(k4),
               lambda *a: cn1d_fused.fused_cn_march_1d(*a, 16, 3)),
        "K5": (tridiag.thomas_batched, list(system[:4]), tridiag.thomas_batched),
        "K6": (lcp.projected_sor_batched, list(system),
               lambda *a: lcp.projected_sor_batched(*a)[0]),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["K1", "K2", "K3", "K4", "K5", "K6"])
def test_kernel_wrapper_refuses_autograd_on_the_card(key):
    """On the card, as on the CPU, a kernel wrapper given an input that
    requires grad raises and launches nothing; under torch.no_grad() it
    launches."""
    _need_cuda()
    wrapper, args, call = _guard_cases()[key]
    leaf = args[0].clone().requires_grad_()
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="no backward"):
        call(leaf, *args[1:])
    assert wrapper.launches == before
    with torch.no_grad():
        got = call(leaf, *args[1:])
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and not got.requires_grad


@pytest.mark.cuda
def test_tridiagonal_solve_keeps_gradient_on_the_card():
    """A float32 CUDA batch under grad goes to the differentiable thomas
    (no launch): its gradient equals the CPU's."""
    _need_cuda()
    lower, diag, upper, rhs, _ = _tridiagonal(6, 30, 23)
    leaf = rhs.clone().requires_grad_()
    before = tridiag.thomas_batched.launches
    g_card, = torch.autograd.grad(tridiag.tridiagonal_solve(lower, diag, upper, leaf).sum(), leaf)
    assert tridiag.thomas_batched.launches == before
    cpu = [a.cpu() for a in (lower, diag, upper)]
    leaf_cpu = rhs.cpu().requires_grad_()
    g_cpu, = torch.autograd.grad(tridiag.tridiagonal_solve(*cpu, leaf_cpu).sum(), leaf_cpu)
    np.testing.assert_allclose(g_card.cpu().numpy(), g_cpu.numpy(), **GATE)


@pytest.mark.cuda
def test_model_function_on_plain_numbers_runs_on_the_card():
    """With no tensor argument a model function takes the card."""
    _need_cuda()
    from pde_tpu_torch.models import black_scholes

    assert black_scholes.price(100.0, 100.0, 0.05, 0.0, 1.0, 0.2).device == \
        torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("method,counter", [("projection", "K5"), ("psor", "K6")])
@pytest.mark.parametrize("entry", ["solve", "solve_all_boundaries"])
def test_hjb_on_card_matches_cpu(entry, method, counter):
    """HJB by projection (each step one K5 launch on the problems' rows)
    and by PSOR (one K6 launch a step) on the card in float32: the
    boundaries within 0.05 of a cell of the CPU's float64 march (the
    agreement the CPU's float32 march shows), the value function within
    1e-4 of it, and the kernel's counter up by n_time."""
    _need_cuda()
    p = hjb.HJBParams(method=method, n_space=120, n_time=60, c_entry=0.002, c_exit=0.002)
    dx = (p.x_max - p.x_min) / (p.n_space - 1)
    wrapper = tridiag.thomas_batched if counter == "K5" else lcp.projected_sor_batched
    fn = getattr(hjb, entry)
    before = wrapper.launches
    card = fn(p, device="cuda")
    torch.cuda.synchronize()
    assert wrapper.launches == before + p.n_time
    cpu = fn(p, device="cpu", dtype=torch.float64)
    if entry == "solve":
        np.testing.assert_allclose(card.value_function, cpu.value_function, atol=1e-4)
        for a, b in ((card.lower_boundary, cpu.lower_boundary),
                     (card.upper_boundary, cpu.upper_boundary)):
            assert (a is None) == (b is None) and (a is None or abs(a - b) <= 0.05 * dx)
    else:
        assert np.max(np.abs(np.array(card) - np.array(cpu))) <= 0.05 * dx


@pytest.mark.cuda
def test_hjb_boundaries_batch_projection_on_card():
    """A book of 5 configs by projection: one K5 launch a step on (20, n),
    each config's boundaries within 0.05 of a cell of the CPU's float64
    march."""
    _need_cuda()
    kw = dict(theta=np.zeros(5), mu=np.linspace(2.0, 8.0, 5), sigma=np.linspace(0.05, 0.2, 5),
              r=0.05, c_entry=0.002, c_exit=0.002, T=1.0, n_space=96, n_time=32,
              method="projection")
    before = tridiag.thomas_batched.launches
    card = hjb.boundaries_batch(**kw, device="cuda")
    torch.cuda.synchronize()
    assert tridiag.thomas_batched.launches == before + kw["n_time"]
    cpu = hjb.boundaries_batch(**kw, device="cpu", dtype=torch.float64)
    args = (kw["mu"], kw["sigma"], kw["theta"])
    dx = (card[0][:, 1] - card[0][:, 0]).cpu().numpy()
    for b, (c, r) in enumerate(zip(hjb.extract_boundaries_batch(*card, *args),
                                   hjb.extract_boundaries_batch(*cpu, *args))):
        assert np.max(np.abs(np.array(c) - np.array(r))) <= 0.05 * dx[b]


@pytest.mark.cuda
@pytest.mark.parametrize("parallel", [False, True])
def test_ou_paths_on_card_match_cpu(parallel):
    """OU paths on the card, from the card's normals, against the CPU's
    path function on the same normals in float64: 1e-5 relative in float32
    (the step loop), and the log-depth scan likewise."""
    _need_cuda()
    from pde_tpu_torch.models import ou

    params = ou.OUParams(100.0, 5.0, 2.0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    fn = ou.simulate_parallel if parallel else ou.simulate
    card = fn(params, 100.0, 1.0, 252, gen, shape=(64,))
    assert card.device.type == "cuda" and card.dtype == torch.float32
    z = torch.randn((64, 252), generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda")
    cpu = ou._path(ou.OUParams(*(torch.tensor(v, dtype=torch.float64) for v in params)),
                   torch.tensor(100.0, dtype=torch.float64), 1.0 / 252, z.cpu().double())
    np.testing.assert_allclose(card.cpu().double().numpy(), cpu.numpy(), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["simulate", "simulate_parallel"])
def test_ou_simulate_on_plain_numbers_runs_on_the_card(fn):
    """Plain numbers and a card generator give a path on cuda:0; a
    generator on another device than the path's raises."""
    _need_cuda()
    from pde_tpu_torch.models import ou

    fn = getattr(ou, fn)
    plain = ou.OUParams(100.0, 5.0, 2.0)
    path = fn(plain, 100.0, 1.0, 16, torch.Generator(device="cuda").manual_seed(0))
    assert path.device == torch.device("cuda", 0) and path.shape == (17,)
    with pytest.raises(ValueError, match="generator is on cpu"):
        fn(plain, 100.0, 1.0, 16, torch.Generator())
    with pytest.raises(ValueError, match="generator is on cuda"):
        fn(plain, torch.tensor(100.0), 1.0, 16, torch.Generator(device="cuda"))


def _heston(dtype=torch.float64, device="cpu"):
    from pde_tpu_torch.models import heston

    return heston.HestonParams(*(torch.tensor(x, dtype=dtype, device=device)
                                 for x in (2.0, 0.04, 0.3, -0.7, 0.04)))


@pytest.mark.cuda
def test_greeks_ad_on_card_matches_cpu():
    """Exact Greeks by autograd in float64 on the card against the CPU."""
    _need_cuda()
    from pde_tpu_torch.models import heston

    K = np.array([80.0, 95.0, 100.0, 105.0, 125.0])
    T = np.array([0.25, 0.5, 1.0, 1.5, 2.0])
    calls = np.array([True, False, True, False, True])
    out = {}
    for dev in ("cuda", "cpu"):
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
        out[dev] = heston.greeks_ad(_heston(device=dev), t(K), t(T), t(100.0), 0.05, 0.02,
                                    torch.as_tensor(calls, device=dev))
    for k, v in out["cuda"].items():
        assert v.device.type == "cuda" and v.dtype == torch.float64, k
        np.testing.assert_allclose(v.cpu().numpy(), out["cpu"][k].numpy(), rtol=1e-10,
                                   atol=1e-10, err_msg=k)


@pytest.mark.cuda
def test_price_fft_complex64_on_card_matches_cpu_complex128():
    """The card's complex64 FFT (4096 x 0.25) against the CPU's complex128
    run on strikes 50-200: within 1e-3 (1e-5 of the spot)."""
    _need_cuda()
    from pde_tpu_torch.models import heston

    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device="cuda")  # noqa: E731
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    k_card, c_card = heston.price_fft(_heston(torch.float32, "cuda"), f32(1.0), f32(100.0),
                                      0.05, 0.02)
    k_cpu, c_cpu = heston.price_fft(_heston(), f64(1.0), f64(100.0), 0.05, 0.02)
    assert c_card.device.type == "cuda" and c_card.dtype == torch.float32
    band = (torch.exp(k_cpu) > 50.0) & (torch.exp(k_cpu) < 200.0)
    np.testing.assert_allclose(c_card.cpu().double()[band].numpy(), c_cpu[band].numpy(),
                               rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_calibrate_batch_on_card_meets_the_jax_tests_gates():
    """Two 16-quote surfaces in float32 on the card, at tests/test_parallel.py's
    budget (DE 30 x 8, LM 20): cost < 1e-3, v0 and theta within 0.01."""
    _need_cuda()
    from pde_tpu_torch.calibrate.heston import HestonCalibrator
    from pde_tpu_torch.models import heston

    U, n = 2, 16
    strikes = np.tile(np.linspace(90.0, 110.0, n), (U, 1))
    maturities = np.tile(np.repeat([0.5, 1.0], n // 2), (U, 1))
    prices = np.maximum(heston.price_options(
        _heston(), torch.as_tensor(strikes.ravel()), torch.as_tensor(maturities.ravel()),
        100.0, 0.05, 0.02).numpy().reshape(U, n), 0.01)
    cal = HestonCalibrator(global_maxiter=30, global_popsize=8, local_max_iter=20)
    out = cal.calibrate_batch(strikes, maturities, prices, np.full(U, 100.0), 0.05, 0.02)
    assert out["params"].device == torch.device("cuda", 0)
    params = out["params"].cpu().double().numpy()
    assert np.all(out["cost"].cpu().numpy() < 1e-3)
    np.testing.assert_allclose(params[:, 4], 0.04, atol=0.01)
    np.testing.assert_allclose(params[:, 1], 0.04, atol=0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["log_grid", "delta", "barrier_price",
                                  "implied_volatility_surface", "greeks_ad", "price_fft",
                                  "calibrate_batch", "parameter_sensitivities"])
def test_new_entry_points_on_plain_numbers_run_on_the_card(name):
    """Each entry point called with plain numbers and no device computes on
    cuda:0 (parameter_sensitivities returns numpy, as the reference does:
    its model prices must equal the card's pricer's)."""
    _need_cuda()
    from pde_tpu_torch.calibrate.heston import HestonCalibrator, parameter_sensitivities
    from pde_tpu_torch.core import grids
    from pde_tpu_torch.models import black_scholes, heston

    plain = heston.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04)
    calls = {
        "log_grid": lambda: grids.log_grid(50.0, 200.0, 5),
        "delta": lambda: black_scholes.delta(100.0, 100.0, 0.05, 0.0, 1.0, 0.2),
        "barrier_price": lambda: black_scholes.barrier_price(
            100.0, 100.0, 120.0, 0.05, 0.0, 1.0, 0.2),
        "implied_volatility_surface": lambda: heston.implied_volatility_surface(
            plain, np.array([90.0, 110.0]), np.array([0.5, 1.0]), 100.0),
        "greeks_ad": lambda: heston.greeks_ad(plain, 100.0, 1.0, 100.0)["gamma"],
        "price_fft": lambda: heston.price_fft(plain, 1.0, 100.0, n_fft=64)[1],
        "calibrate_batch": lambda: HestonCalibrator(
            global_maxiter=1, global_popsize=2, local_max_iter=1).calibrate_batch(
            np.full((2, 4), 100.0), np.full((2, 4), 1.0), np.full((2, 4), 10.0),
            np.full(2, 100.0), 0.05, 0.02)["params"],
    }
    if name == "parameter_sensitivities":
        out = parameter_sensitivities(plain, [90.0, 110.0], [1.0, 1.0], [True, True],
                                      [15.0, 5.0], 100.0, 0.05)
        assert np.all(np.isfinite(out["model_prices"]))
        assert out["model_prices"].dtype == np.float32
        return
    assert calls[name]().device == torch.device("cuda", 0)


# -- the Fourier-priced models (no kernel): float32 on the card against
#    float64 on the CPU, and plain numbers landing on cuda:0

_FOURIER_PARAMS = {
    "heston": (2.0, 0.04, 0.3, -0.7, 0.04),
    "bates": (2.0, 0.04, 0.3, -0.7, 0.04, 0.6, -0.08, 0.18),
    "svcj": (2.0, 0.04, 0.3, -0.7, 0.04, 0.5, -0.1, 0.15, 0.05, -0.5),
    "rough": (0.1, 2.0, 0.04, 0.3, -0.7, 0.04),
}


def _fourier(which, dtype=torch.float64, device="cpu"):
    from pde_tpu_torch.models import bates, heston, rough_heston, svcj

    cls = {"heston": heston.HestonParams, "bates": bates.BatesParams,
           "svcj": svcj.SVCJParams, "rough": rough_heston.RoughHestonParams}[which]
    return cls(*(torch.tensor(v, dtype=dtype, device=device)
                 for v in _FOURIER_PARAMS[which]))


def _fourier_calls(name):
    """(fn(params, t), params kind, atol, rtol): ``t`` makes a tensor of the
    call's dtype and device."""
    from pde_tpu_torch.models import (digital, forward_start, heston, multi_asset,
                                      rough_heston, term_heston, varswap, vix)

    K = np.linspace(80.0, 120.0, 9)
    T = np.array([0.1, 0.25, 0.5, 1.0, 1.5, 0.5, 0.25, 2.0, 1.0])
    return {
        "bates.price_carr_madan_gl": (lambda p, t: heston.price_carr_madan_gl(
            p, t(K), t(T), 100.0, 0.05, 0.02), "bates", 1e-5, 1e-4),
        "svcj.price_accurate": (lambda p, t: heston.price_accurate(
            p, t(K), t(T), 100.0, 0.05, 0.02), "svcj", 1e-5, 1e-4),
        "term_heston.price_term_heston": (lambda p, t: term_heston.price_term_heston(
            term_heston.make_term_params([0.0, 0.5, 2.0], t([2.0, 1.0]), [0.04, 0.06],
                                         [0.3, 0.5], [-0.7, -0.4], 0.04),
            t(K), t(1.2), 100.0, 0.05, 0.02), "heston", 1e-5, 1e-4),
        "forward_start.price_cliquet_strip": (
            lambda p, t: forward_start.price_cliquet_strip(p, t(1.0), n_periods=4),
            "heston", 1e-5, 1e-4),
        "digital.price": (lambda p, t: digital.price(p, t(K), t(T), 100.0, 0.05, 0.02,
                                                     kind="asset"), "bates", 1e-4, 1e-5),
        # the vol-swap row's 1e-6, with Bates' and with SVCJ's jump-QV hooks
        "varswap.fair_volatility_strike": (
            lambda p, t: varswap.fair_volatility_strike(p, t(0.5)), "bates", 0.0, 1e-6),
        "varswap.fair_volatility_strike(svcj)": (
            lambda p, t: varswap.fair_volatility_strike(p, t(0.5)), "svcj", 0.0, 1e-6),
        "varswap.volatility_convexity_approx": (
            lambda p, t: varswap.volatility_convexity_approx(p, t(0.5)), "bates", 0.0, 1e-5),
        "vix.vix_option": (lambda p, t: vix.vix_option(p, t(np.linspace(15.0, 30.0, 7)),
                                                       t(0.5), 0.02), "bates", 1e-4, 1e-4),
        "vix.vix_futures_term": (lambda p, t: vix.vix_futures_term(p, t([0.1, 0.5, 1.0])),
                                 "heston", 0.0, 1e-5),
        "rough_heston.price_rough": (lambda p, t: rough_heston.price_rough(
            p, t(np.tile(K, (2, 1))), t([0.1, 0.5]), 100.0, 0.05, 0.02, n_steps=32),
            "rough", 1e-4, 1e-4),
        "multi_asset.spread_price_quad": (lambda p, t: multi_asset.spread_price_quad(
            100.0, 96.0, t(np.linspace(-15.0, 25.0, 16)), 0.9, 0.25, 0.35,
            t(np.tile(np.linspace(-0.5, 0.9, 8), 2)), 0.03, 0.01, 0.02), None, 1e-5, 1e-4),
    }[name]


_FOURIER_NAMES = ["bates.price_carr_madan_gl", "svcj.price_accurate",
                  "term_heston.price_term_heston", "forward_start.price_cliquet_strip",
                  "digital.price", "varswap.fair_volatility_strike",
                  "varswap.fair_volatility_strike(svcj)",
                  "varswap.volatility_convexity_approx", "vix.vix_option",
                  "vix.vix_futures_term", "rough_heston.price_rough",
                  "multi_asset.spread_price_quad"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", _FOURIER_NAMES)
def test_fourier_model_float32_on_card_matches_cpu_float64(name):
    _need_cuda()
    fn, kind, atol, rtol = _fourier_calls(name)
    out = {}
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
        t = lambda a, dev=dev, dt=dt: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
        out[dev] = fn(_fourier(kind, dt, dev) if kind else None, t)
    assert out["cuda"].device.type == "cuda" and out["cuda"].dtype == torch.float32
    np.testing.assert_allclose(out["cuda"].cpu().double().numpy(), out["cpu"].numpy(),
                               atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bates", "digital", "forward_start", "term_heston",
                                  "varswap", "vix", "rough", "multi_asset",
                                  "BatesCalibrator", "RoughHestonCalibrator"])
def test_fourier_entry_points_on_plain_numbers_run_on_the_card(name):
    _need_cuda()
    from pde_tpu_torch.calibrate.bates import BatesCalibrator
    from pde_tpu_torch.calibrate.rough import RoughHestonCalibrator
    from pde_tpu_torch.models import (bates, digital, forward_start, multi_asset,
                                      rough_heston, term_heston, varswap, vix)

    plain = _FOURIER_PARAMS
    calls = {
        "bates": lambda: bates.price_accurate(bates.BatesParams(*plain["bates"]), 100.0,
                                              1.0, 100.0),
        "digital": lambda: digital.price(bates.BatesParams(*plain["bates"]), 100.0, 1.0,
                                         100.0),
        "forward_start": lambda: forward_start.price_forward_start(
            bates.BatesParams(*plain["bates"]).heston(), 1.0, 0.5, 1.0),
        "term_heston": lambda: term_heston.make_term_params(
            [0.0, 1.0], [2.0], [0.04], [0.3], [-0.7], 0.04).edges,
        "varswap": lambda: varswap.fair_variance_strike(bates.BatesParams(*plain["bates"]),
                                                        1.0),
        "vix": lambda: vix.vix_spot(bates.BatesParams(*plain["bates"])),
        "rough": lambda: rough_heston.price_rough(
            rough_heston.RoughHestonParams(*plain["rough"]), 100.0, 0.5, 100.0, n_steps=8),
        "multi_asset": lambda: multi_asset.rainbow_two_asset_price(
            100.0, 96.0, 100.0, 0.9, 0.25, 0.35, 0.5),
        "BatesCalibrator": lambda: torch.empty(0, device=BatesCalibrator().device),
        "RoughHestonCalibrator": lambda: RoughHestonCalibrator()._start(None, None),
    }
    assert calls[name]().device == torch.device("cuda", 0)


@pytest.mark.cuda
def test_rough_calibration_on_card_recovers_its_surface():
    """Float32 on the card at a small size: the fit recovers the generator
    (bench_full.py's gate rmse < 5e-3)."""
    _need_cuda()
    from pde_tpu_torch.calibrate.rough import RoughHestonCalibrator

    data = RoughHestonCalibrator.generate_synthetic_surface(maturities=(0.1, 0.5),
                                                            n_steps=24)
    res = RoughHestonCalibrator(n_steps=24, max_iter=20).calibrate(
        data["strikes"], data["maturities"], data["mid_prices"], data["S0"], data["r"],
        data["q"])
    assert res.rmse < 5e-3
    assert abs(res.params.hurst - 0.15) < 0.02


# -- the rates and credit desk (no kernel): float32 on the card against
#    float64 on the CPU, at bench_full.py:425-552's shapes where they are
#    cheap, and plain numbers landing on cuda:0

def _rates_curve(dtype, device):
    from pde_tpu_torch.models import rates

    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return rates.curve_from_zero_rates(t([0.5, 1.0, 2.0, 5.0, 10.0, 30.0]),
                                       t([0.030, 0.032, 0.035, 0.040, 0.042, 0.043]))


def _panel(model, n, dtype, device):
    from pde_tpu_torch.models import g2, rates

    curve = _rates_curve(dtype, device)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    ex = torch.linspace(0.5, 10.0, n, dtype=dtype, device=device)
    pay = ex[:, None] + torch.arange(1, 11, dtype=dtype, device=device) * 0.5
    par = rates.hw_swap_rate(curve, ex, pay)
    if model == "hw":
        return rates.hw_swaption(rates.HullWhiteParams(t(0.1), t(0.012), curve), par, ex, pay)
    p = g2.G2Params(*map(t, (0.5, 0.05, 0.01, 0.008, -0.6)), curve)
    return g2.g2_swaption(p, par, ex, pay, n_gh=64)


@pytest.mark.cuda
@pytest.mark.parametrize("model,n", [("hw", 256), ("g2", 128)])
def test_swaption_panel_float32_on_card_matches_cpu_float64(model, n):
    """The bench panels: within 1e-7 + 1e-4 |p| of float64 on the CPU."""
    _need_cuda()
    card = _panel(model, n, torch.float32, "cuda")
    assert card.device.type == "cuda" and card.dtype == torch.float32 and card.shape == (n,)
    np.testing.assert_allclose(card.cpu().double().numpy(),
                               _panel(model, n, torch.float64, "cpu").numpy(),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.cuda
def test_hw_caplet_fit_on_card_recovers_sigma():
    """bench_full.py:443-456 in float32 on the card: rmse <= 1e-4, sigma
    within 1%."""
    _need_cuda()
    from pde_tpu_torch.calibrate.rates import HullWhiteCalibrator
    from pde_tpu_torch.models import rates

    curve = _rates_curve(torch.float32, "cuda")
    starts = torch.arange(1, 17, dtype=torch.float32, device="cuda") * 0.5
    ends = starts + 0.5
    ks = curve.forward(starts, ends)
    quotes = rates.hw_caplet(rates.HullWhiteParams(0.1, 0.012, curve), ks, starts, ends)
    res = HullWhiteCalibrator(max_iter=60).calibrate_caplets(curve, starts, ends, ks, quotes)
    assert res.params.a.device == torch.device("cuda", 0)
    assert res.rmse <= 1e-4 and abs(float(res.params.sigma) / 0.012 - 1.0) <= 0.01


@pytest.mark.cuda
def test_g2_fit_on_card_reprices_its_panel():
    """bench_full.py:507-521 in float32 on the card at 25 LM iterations:
    rmse <= 1e-3."""
    _need_cuda()
    from pde_tpu_torch.calibrate.g2 import G2Calibrator
    from pde_tpu_torch.models import g2, rates

    curve = _rates_curve(torch.float32, "cuda")
    p = g2.G2Params(0.5, 0.05, 0.01, 0.008, -0.6, curve)
    exps = [1.0, 2.0, 3.0, 5.0]
    pts = [torch.arange(1, 7, dtype=torch.float32, device="cuda") * 0.5 + e for e in exps]
    ks = [float(rates.hw_swap_rate(curve, e, pt)) for e, pt in zip(exps, pts)]
    quotes = torch.stack([g2.g2_swaption(p, k, e, pt) for e, pt, k in zip(exps, pts, ks)])
    res = G2Calibrator(max_iter=25).calibrate_swaptions(curve, exps, pts, ks, quotes)
    assert res.params.rho.device == torch.device("cuda", 0)
    assert res.rmse <= 1e-3


@pytest.mark.cuda
def test_cds_bootstrap_on_card_matches_cpu_float64():
    """bench_full.py:527-538: hazards positive, pillars repriced within 5e-4,
    hazards within 1e-4 of float64 on the CPU."""
    _need_cuda()
    from pde_tpu_torch.models import credit

    pillars, spreads = [1.0, 3.0, 5.0, 7.0, 10.0], [0.008, 0.011, 0.013, 0.014, 0.015]
    curve = _rates_curve(torch.float32, "cuda")
    hc, hz = credit.bootstrap_hazard(curve, pillars, torch.tensor(spreads, device="cuda"))
    assert hz.device.type == "cuda" and bool((hz > 0).all())
    _, ref = credit.bootstrap_hazard(_rates_curve(torch.float64, "cpu"), pillars,
                                     torch.tensor(spreads, dtype=torch.float64))
    np.testing.assert_allclose(hz.cpu().double().numpy(), ref.numpy(), rtol=1e-4)
    np.testing.assert_allclose(credit.cds_par_spreads(curve, hc, pillars).cpu().numpy(),
                               spreads, rtol=5e-4)


@pytest.mark.cuda
def test_orchestrator_rates_and_credit_stages_succeed_on_the_card():
    _need_cuda()
    from pde_tpu_torch.calibrate.g2 import G2Calibrator
    from pde_tpu_torch.calibrate.orchestrator import (CalibrationConfig,
                                                      CalibrationOrchestrator,
                                                      CalibrationStatus)
    from pde_tpu_torch.calibrate.rates import HullWhiteCalibrator
    from pde_tpu_torch.models import rates

    curve = _rates_curve(torch.float32, "cuda")
    starts = torch.arange(1, 11, dtype=torch.float32, device="cuda") * 0.5
    ks = curve.forward(starts, starts + 0.5)
    quotes = rates.hw_caplet(rates.HullWhiteParams(0.12, 0.011, curve), ks, starts,
                             starts + 0.5)
    orch = CalibrationOrchestrator(
        config=CalibrationConfig(calibrate_heston=False, calibrate_sabr=False,
                                 calibrate_rates=True, calibrate_credit=True),
        rates_calibrator=HullWhiteCalibrator(max_iter=40), g2_calibrator=G2Calibrator())
    res = orch.run_daily_calibration(
        "USD", {"strike": []}, S0=100.0,
        rates_market={"curve": curve, "caplets": {"starts": starts, "ends": starts + 0.5,
                                                  "strikes": ks, "quotes": quotes}},
        credit_market={"curve": curve, "pillars": [1.0, 3.0, 5.0, 10.0],
                       "spreads": [0.008, 0.011, 0.013, 0.015]})
    assert res.status == CalibrationStatus.SUCCESS and res.errors == [], res.errors
    assert res.credit_result["hazard_curve"].survival.device == torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flat_curve", "curve_from_zero_rates", "vasicek_bond",
                                  "cir_bond", "bachelier_price", "flat_hazard",
                                  "HullWhiteCalibrator", "G2Calibrator",
                                  "CalibrationOrchestrator"])
def test_rates_entry_points_on_plain_numbers_run_on_the_card(name):
    _need_cuda()
    from pde_tpu_torch.calibrate.g2 import G2Calibrator
    from pde_tpu_torch.calibrate.orchestrator import CalibrationOrchestrator
    from pde_tpu_torch.calibrate.rates import HullWhiteCalibrator
    from pde_tpu_torch.models import credit, rates

    calls = {
        "flat_curve": lambda: rates.flat_curve(0.03).dfs,
        "curve_from_zero_rates": lambda: rates.curve_from_zero_rates([1.0, 2.0],
                                                                     [0.03, 0.04]).dfs,
        "vasicek_bond": lambda: rates.vasicek_bond(rates.VasicekParams(0.5, 0.04, 0.015, 0.03),
                                                   2.0),
        "cir_bond": lambda: rates.cir_bond(rates.CIRParams(0.5, 0.04, 0.1, 0.03), 2.0),
        "bachelier_price": lambda: rates.bachelier_price(0.03, 0.03, 0.0075, 1.0),
        "flat_hazard": lambda: credit.flat_hazard(0.02).survival,
        "HullWhiteCalibrator": lambda: torch.empty(0, device=HullWhiteCalibrator().device),
        "G2Calibrator": lambda: torch.empty(0, device=G2Calibrator().device),
        "CalibrationOrchestrator": lambda: torch.empty(
            0, device=CalibrationOrchestrator().device),
    }
    assert calls[name]().device == torch.device("cuda", 0)


def _mc_params(dtype, device):
    from pde_tpu_torch.models.heston import HestonParams

    return HestonParams(*(torch.tensor(v, dtype=dtype, device=device)
                          for v in (2.0, 0.04, 0.3, -0.7, 0.04)))


def _cpu_replay(seed):
    from pde_tpu_torch.models import heston_mc

    cpu = torch.device("cpu")
    return heston_mc._Replay(heston_mc._draws(torch.Generator().manual_seed(seed), cpu))


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["pseudo", "sobol"])
def test_qe_on_card_matches_cpu_on_the_same_draws(sampler):
    """One replay of a CPU generator's float64 draws: the card's float64
    paths at 1e-10 relative of the CPU's (libm rounding only), or 1e-12
    absolute for the barrier weights and variances near 0 (a weight takes
    the difference of the log-spot and the log-barrier, which cancels near
    the barrier: a weight of 4.7e-5 sat 2.9e-14 off on the H100); its
    float32 terminal state within twice the CPU's own float32 error."""
    _need_cuda()
    from pde_tpu_torch.models import heston_mc

    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    kw = dict(n_steps=16, n_paths=4096, rate=0.05, dividend=0.02, sampler=sampler,
              antithetic=sampler == "pseudo", barrier=125.0)
    replay = _cpu_replay(3)
    ref = heston_mc.simulate_qe(_mc_params(torch.float64, cpu), 100.0, 1.0, replay, **kw)
    card64 = heston_mc.simulate_qe(_mc_params(torch.float64, card), 100.0, 1.0, replay, **kw)
    assert card64.spot.device == card
    for got, want in zip(card64, ref):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-10, atol=1e-12)
    cpu32 = heston_mc.simulate_qe(_mc_params(torch.float32, cpu), 100.0, 1.0, replay, **kw)
    card32 = heston_mc.simulate_qe(_mc_params(torch.float32, card), 100.0, 1.0, replay, **kw)
    for field in ("spot", "variance"):
        want = getattr(ref, field)
        cpu_err = float((getattr(cpu32, field).double() - want).abs().max())
        card_err = float((getattr(card32, field).cpu().double() - want).abs().max())
        assert card_err <= 2.0 * cpu_err, (field, card_err, cpu_err)


@pytest.mark.cuda
def test_lsm_book_on_card():
    """The LSM book on the card: in float64 each entry equals the single
    contract's price on the same draws (1e-10) and the CPU's book (1e-10);
    in float32 the calls fall with strike and the puts rise."""
    _need_cuda()
    from pde_tpu_torch.solvers import lsm

    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    kw = dict(rate=0.05, n_steps=16, n_paths=4096)
    strikes = [85.0, 95.0, 105.0, 115.0]
    replay = _cpu_replay(4)
    ref, _ = lsm.price_american_lsm_batch(_mc_params(torch.float64, cpu), strikes, False, 1.0,
                                          100.0, replay, **kw)
    book, _ = lsm.price_american_lsm_batch(_mc_params(torch.float64, card), strikes, False,
                                           1.0, 100.0, replay, **kw)
    assert book.device == card
    np.testing.assert_allclose(book.cpu().numpy(), ref.numpy(), rtol=1e-10)
    for i, k in enumerate(strikes):
        single, _ = lsm.price_american_lsm(_mc_params(torch.float64, card), k, 1.0, 100.0,
                                           replay, **kw)
        np.testing.assert_allclose(float(book[i]), float(single), rtol=1e-10)
    p32 = _mc_params(torch.float32, card)
    g = torch.Generator(device=card).manual_seed(0)
    puts, _ = lsm.price_american_lsm_batch(p32, strikes, False, 1.0, 100.0, g, **kw)
    g = torch.Generator(device=card).manual_seed(0)
    calls, _ = lsm.price_american_lsm_batch(p32, strikes, True, 1.0, 100.0, g, **kw)
    assert bool((torch.diff(puts) > 0).all()) and bool((torch.diff(calls) < 0).all())


def _hw(dtype, device):
    from pde_tpu_torch.models import rates

    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    curve = rates.curve_from_zero_rates(t([0.5, 1.0, 2.0, 5.0, 10.0, 30.0]),
                                        t([0.030, 0.032, 0.035, 0.040, 0.042, 0.043]))
    return rates.HullWhiteParams(t(0.1), t(0.012), curve)


@pytest.mark.cuda
def test_bermudan_ladder_on_card_is_one_k5_launch_a_step():
    """bench_full.py:461-479's ladder (64 strikes, n_x 257, n_sub 16,
    schedule 1.0 to 6.0 by 0.5): in float32 on the card every one of the
    160 steps is one K5 launch on its lane route, and the prices sit within
    1e-7 + 1e-4 |p| of the CPU's float64 march, or within twice the CPU's
    own float32 error; in float64 the card takes the thomas route (no
    launch) and matches the CPU at 1e-10."""
    _need_cuda()
    from pde_tpu_torch.solvers import bermudan_hw

    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    sched = np.arange(1.0, 6.01, 0.5)
    ks = np.linspace(0.6, 1.4, 64) * 0.038

    def ladder(dtype, device):
        return bermudan_hw.bermudan_swaption_pde(
            _hw(dtype, device), torch.tensor(ks, dtype=dtype, device=device),
            torch.tensor(sched, dtype=dtype, device=device), n_x=257, n_sub=16)[0]

    k5 = tridiag.thomas_batched
    before = (k5.launches, k5.launches_smem)
    card32 = ladder(torch.float32, card)
    torch.cuda.synchronize()
    assert (k5.launches - before[0], k5.launches_smem - before[1]) == (160, 160)
    ref = ladder(torch.float64, cpu)
    cpu_err = (ladder(torch.float32, cpu).double() - ref).abs()
    err = (card32.cpu().double() - ref).abs()
    limit = 1e-7 + 1e-4 * ref.abs()
    assert bool((err <= limit).all()) or float(err.max()) <= 2.0 * float(cpu_err.max())
    before = k5.launches
    card64 = ladder(torch.float64, card)
    assert k5.launches == before
    np.testing.assert_allclose(card64.cpu().numpy(), ref.numpy(), rtol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bermudan_hw", "bermudan_g2", "cva_netting"])
def test_card_curve_with_a_cpu_generator_raises(name):
    _need_cuda()
    from pde_tpu_torch.models import credit, g2
    from pde_tpu_torch.solvers import bermudan_g2, bermudan_hw

    hw = _hw(torch.float32, torch.device("cuda", 0))
    gen = torch.Generator()
    calls = {
        "bermudan_hw": lambda: bermudan_hw.bermudan_swaption_mc(
            hw, 0.035, [1.0, 1.5, 2.0], gen, n_paths=8, n_outer=2, n_inner=2),
        "bermudan_g2": lambda: bermudan_g2.bermudan_swaption_g2_mc(
            g2.G2Params(0.5, 0.05, 0.01, 0.008, -0.6, hw.curve), 0.035, [1.0, 1.5, 2.0], gen,
            n_paths=8, n_outer=2, n_inner=2),
        "cva_netting": lambda: credit.cva_netting_hw_mc(
            hw, credit.flat_hazard(0.02), [credit.SwapTrade(0.035, 1.0, 1.0)], [0.5, 1.0], gen,
            n_paths=8),
    }
    with pytest.raises(ValueError, match="generator is on cpu"):
        calls[name]()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["basket", "local_vol", "lifted", "slv"])
def test_new_mc_entry_points_on_plain_numbers_run_on_the_card(name):
    _need_cuda()
    from pde_tpu_torch.models import heston, multi_asset, rough_heston, rough_heston_mc, slv

    g = torch.Generator(device="cuda").manual_seed(0)
    hp = heston.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04)
    calls = {
        "basket": lambda: multi_asset.price_basket_mc(
            g, [100.0, 95.0], [0.5, 0.5], [100.0], 1.0, [0.2, 0.3], [[1.0, 0.5], [0.5, 1.0]],
            n_paths=64)[0],
        "local_vol": lambda: local_vol.simulate_local_vol(
            lambda s, t: torch.full_like(s, 0.2), 100.0, 1.0, g, n_steps=4, n_paths=64).spot,
        "lifted": lambda: rough_heston_mc.simulate_lifted(
            rough_heston.RoughHestonParams(0.1, 2.0, 0.04, 0.3, -0.7, 0.04), 100.0, 1.0, g,
            n_steps=4, n_paths=64, n_factors=8).spot,
        "slv": lambda: slv.calibrate_leverage(hp, lambda s, t: torch.full_like(s, 0.2), 100.0,
                                              1.0, g, n_steps=4, n_paths=64, n_bins=5)[0].values,
    }
    out = calls[name]()
    assert out.device == torch.device("cuda", 0) and bool(torch.isfinite(out).all())

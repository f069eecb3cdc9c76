"""The port's Dupire local-vol module held against ``pde_tpu/models/local_vol.py``
(and the converged GL pricers of ``pde_tpu/models/heston.py`` it uses).

Everything runs in float64 in both packages.  The gates:
- 1e-10 on the GL prices: the same nodes and weights, summed in another
  order;
- 1e-8 on local vols: second derivatives by forward-mode AD through the
  complex characteristic function, in both packages, where round-off of
  the quadrature is amplified by 1/(K^2 d2C/dK2);
- exact equality for the NaN fill and the interpolator's bracket logic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pde_tpu.models import black_scholes as jbs
from pde_tpu.models import heston as jh
from pde_tpu.models import local_vol as jlv
from pde_tpu_torch import interop
from pde_tpu_torch.models import black_scholes as tbs
from pde_tpu_torch.models import heston as th
from pde_tpu_torch.models import local_vol as tlv

F64 = torch.float64
P = (2.0, 0.04, 0.3, -0.7, 0.04)
S0, R, Q = 100.0, 0.04, 0.01


def test_price_accurate_gl_matches_reference():
    K = np.array([60.0, 85.0, 100.0, 115.0, 170.0])
    T = np.array([0.05, 0.5, 1.0, 1.5, 2.0])
    jp, tp = jh.HestonParams(*P), th.HestonParams(*P)
    for call in (True, False):
        want = np.asarray(jh.price_accurate_gl(jp, K, T, S0, R, Q, is_call=call))
        got = th.price_accurate_gl(tp, torch.tensor(K), torch.tensor(T), S0, R, Q,
                                   is_call=call).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_price_accurate_gl_grouped_matches_reference():
    K = np.array([80.0, 100.0, 120.0, 90.0, 110.0])
    t_idx, unique_T = np.array([0, 0, 1, 1, 1]), np.array([0.5, 1.5])
    want = np.asarray(jh.price_accurate_gl_grouped(jh.HestonParams(*P), K, t_idx,
                                                   unique_T, S0, R, Q))
    got = th.price_accurate_gl_grouped(th.HestonParams(*P), torch.tensor(K),
                                       torch.tensor(t_idx), torch.tensor(unique_T),
                                       S0, R, Q).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    # and the grouped rule prices what the ungrouped one does
    ungrouped = th.price_accurate_gl(th.HestonParams(*P), torch.tensor(K),
                                     torch.tensor(unique_T[t_idx]), S0, R, Q).numpy()
    np.testing.assert_allclose(got, ungrouped, rtol=1e-12, atol=1e-12)


def _surface(rng):
    Ks = np.linspace(60.0, 150.0, 7)
    Ts = np.array([0.1, 0.5, 1.0, 2.0])
    grid = 0.2 + 0.05 * rng.random((4, 7))
    return Ks, Ts, grid


@pytest.mark.parametrize("where", ["nodes", "between", "beyond"])
def test_surface_interpolator_matches_reference(rng, where):
    Ks, Ts, grid = _surface(rng)
    jint = jlv.SurfaceInterpolator(Ks, Ts, grid)
    tint = tlv.SurfaceInterpolator(Ks, Ts, grid, device="cpu", dtype=F64)
    if where == "nodes":
        points = [(Ks, t) for t in Ts]
    elif where == "between":
        points = [(0.5 * (Ks[1:] + Ks[:-1]), 0.5 * (Ts[i] + Ts[i + 1])) for i in range(3)]
    else:
        points = [(np.array([20.0, 59.0, 151.0, 400.0]), t) for t in (0.0, 0.05, 2.5, 9.0)]
    for s, t in points:
        want = np.asarray(jint(s, t))
        got = tint(torch.tensor(s), t).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-15)
    if where == "nodes":  # exact on the nodes
        for i, t in enumerate(Ts):
            np.testing.assert_allclose(tint(torch.tensor(Ks), t).numpy(), grid[i],
                                       rtol=1e-14)
    # the interop twin built from the JAX object agrees too
    twin = interop.surface_interpolator(jint)
    s, t = points[0]
    np.testing.assert_array_equal(twin(torch.tensor(s), t).numpy(),
                                  tint(torch.tensor(s), t).numpy())


def test_surface_interpolator_device_follows_its_grid():
    Ks, Ts, grid = _surface(np.random.default_rng(0))
    on_grid = tlv.SurfaceInterpolator(torch.tensor(Ks), Ts, torch.tensor(grid))
    assert on_grid.vols.device.type == "cpu" and on_grid.vols.dtype == F64


@pytest.mark.parametrize("row", [
    [np.nan, np.nan, 0.3, 0.25, np.nan, 0.2, np.nan],
    [0.1, np.nan, np.nan, np.nan, 0.4],
    [np.nan, 0.5, np.nan],
    [0.2, 0.3, 0.4],
    [np.nan, np.nan, np.nan],
])
def test_fill_nan_nearest_matches_reference(row):
    row = np.array(row)
    want = np.asarray(jlv._fill_nan_nearest(jnp.asarray(row)))
    got = tlv._fill_nan_nearest(torch.tensor(row)).numpy()
    np.testing.assert_array_equal(got, want)
    # rows of a surface at once, as dupire_surface fills them
    both = tlv._fill_nan_nearest(torch.tensor(np.stack([row, row[::-1]]))).numpy()
    np.testing.assert_array_equal(both[0], want)
    np.testing.assert_array_equal(
        both[1], np.asarray(jlv._fill_nan_nearest(jnp.asarray(row[::-1].copy()))))


def test_local_vol_from_price_fn_matches_reference():
    """A Black-Scholes call surface with a strike- and time-dependent vol
    through both Dupire extractions."""
    K = np.array([70.0, 90.0, 100.0, 110.0, 140.0])
    T = np.array([0.25, 0.5, 1.0, 1.5, 2.0])

    def vol(xp, k, t):
        return 0.2 + 0.05 * xp.log(k / 100.0) ** 2 + 0.02 * t

    def jfn(k, t):
        return jbs.price(S0, k, R, Q, t, vol(jnp, k, t), True)

    def tfn(k, t):
        return tbs.price(S0, k, R, Q, t, vol(torch, k, t), True)

    want = np.asarray(jnp.vectorize(
        lambda k, t: jlv.local_vol_from_price_fn(jfn, k, t, R, Q))(K, T))
    got = tlv.local_vol_from_price_fn(tfn, torch.tensor(K), torch.tensor(T), R, Q).numpy()
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_local_vol_from_implied_fn_matches_reference():
    K = np.array([60.0, 80.0, 100.0, 120.0, 160.0])
    T = np.array([0.1, 0.5, 1.0, 1.5, 3.0])

    def iv(xp, k, t):
        y = xp.log(k / 100.0)
        return 0.2 - 0.1 * y + 0.15 * y * y + 0.01 * xp.sqrt(t)

    want = np.asarray(jnp.vectorize(lambda k, t: jlv.local_vol_from_implied_fn(
        lambda kk, tt_: iv(jnp, kk, tt_), k, t, S0, R, Q))(K, T))
    got = tlv.local_vol_from_implied_fn(lambda kk, tt_: iv(torch, kk, tt_),
                                        torch.tensor(K), torch.tensor(T), S0, R, Q).numpy()
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_dupire_surface_matches_reference():
    """6 strikes x 3 maturities over bench.py's strike range: at T = 0.05
    three wing points carry no information, come back NaN and are filled
    from the nearest informative strike.  (Wider grids put points whose
    K^2/2 d2C/dK2 is ~1e-7 just inside the informative region; there both
    packages' AD round-off is amplified to ~1e-6 relative, so the 1e-8
    gate is held on this range.)"""
    Ks = np.exp(np.linspace(np.log(60.0), np.log(170.0), 6))
    Ts = np.array([0.05, 0.5, 1.0])
    want = np.asarray(jlv.dupire_surface(jh.HestonParams(*P), jnp.asarray(Ks),
                                         jnp.asarray(Ts), S0, R, Q))
    got = tlv.dupire_surface(th.HestonParams(*P), torch.tensor(Ks), torch.tensor(Ts),
                             S0, R, Q, device="cpu", dtype=F64)
    assert got.shape == (3, 6) and got.dtype == F64
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-10)

"""Fused 1D theta-scheme march with TIME-DEPENDENT coefficients (twin of
``pde_tpu/ops/cn1d_tv_fused.py:fused_cn_march_1d_tv``).

The local-vol PDE's sigma(S, t) makes all three operator diagonals change
every step; the per-step rows are precomputed for every time level as one
band lattice, and the whole backward march of a book runs in ONE launch:
the explicit part at level k, a Thomas factorisation fused with the
forward sweep at level k+1, the back substitution, the Dirichlet rows and
the American floor.

* On a CUDA tensor, :func:`fused_cn_march_1d_tv` launches the CUDA kernel
  ``csrc/cn1d_tv_fused.cu`` or raises: one warp per option, each step's
  tridiagonal solve partitioned over the warp's lanes (a shuffle scan of
  the chunks' pivot maps, then of their affine sweeps), the band levels
  staged ahead into shared memory; lattices too long for a block's 227 KB
  (``n > 518``) run the first design, one thread per option.
* On a CPU tensor it runs :func:`_fused_cn_march_1d_tv_plain`, the same
  step order in tensor ops over the batch with Python loops over the rows.
* :func:`fused_cn_march_1d_tv_surface` is the same march for a book on a
  bilinear local-vol surface, with no lattice: the kernel's surface route
  builds each option's bands inside the march from the surface.  Its
  lookup and rows are :func:`strike_brackets`, :func:`surface_sigma` and
  :func:`operator_rows`, with which ``solvers/local_vol_pde`` builds the
  lattice too.  Its twin, :func:`_fused_cn_march_1d_tv_surface_plain`,
  builds the lattice level by level (:class:`_SurfaceLevels`) and marches
  with :func:`_fused_cn_march_1d_tv_plain`.

The layout is the reference's, batch last: ``pay (n, B)``,
``bands (n_time+1, 3n, B)``, ``sc (8, B)``, read in place.  The
reference's two variants (lattice resident in VMEM, or streamed a level
per grid step) are one design here: the kernel streams each level from
device memory, two levels ahead of the step that uses it.

On the H100 its bound is the band lattice's bytes (62 MB at 200x100,
B=256: ~19 us at 3.35 TB/s); what binds it is each option's serial
chain of dependent rows per step; the CUDA source's header says what the
design does about it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.profiling import span
from .build import load_library, refuse_autograd

__all__ = ["fused_cn_march_1d_tv", "fused_cn_march_1d_tv_surface", "operator_rows",
           "strike_brackets", "surface_route_fits", "surface_sigma"]

_SOURCE = "cn1d_tv_fused.cu"
_TILE = 8             # options (warps) per block of the warp route (csrc kTile)
_SMEM_MAX = 232448    # bytes of shared memory one block can have (227 KB)


def fused_cn_march_1d_tv(
    pay,          # (n, B) per-option payoff profile on its K-scaled grid
    bands,        # (n_time+1, 3n, B): [L_m; L_c; L_p] rows at level k, which
                  # is calendar time T - k*dt; step k reads levels k and k+1
    sc,           # (8, B): dt, r, q, K, is_call(0/1), american(0/1), s_min, s_max
    n_space: int,
    n_time: int,
    w: float = 0.5,   # theta-scheme weight: CN = 1/2, implicit Euler = 1
) -> torch.Tensor:
    """March the whole book backward ``n_time`` steps; returns V(t=0) as
    (n, B) float32.  ``launches`` counts the CUDA kernel's launches of
    either design, ``launches_smem`` those of the warp design."""
    refuse_autograd("fused_cn_march_1d_tv", pay, bands, sc)
    n, B = n_space, pay.shape[-1]
    for a, shape in ((pay, (n, B)), (bands, (n_time + 1, 3 * n, B)), (sc, (8, B))):
        if tuple(a.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(a.shape)}")
        if a.dtype != torch.float32 or a.device != pay.device:
            raise ValueError("all inputs must be float32 on one device")
        if not a.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    if n < 3 or n_time < 1:
        raise ValueError("the march needs n_space >= 3 and n_time >= 1")
    if pay.device.type == "cuda":
        return _launch(pay, bands, sc, n, n_time, w)
    if pay.device.type == "cpu":
        return _fused_cn_march_1d_tv_plain(pay, bands, sc, n, n_time, w)
    raise ValueError(f"no fused CN march for device {pay.device}")


fused_cn_march_1d_tv.launches = 0
fused_cn_march_1d_tv.launches_smem = 0


def _smem_bytes(n: int):
    """Shared memory of a warp-route block: a ring of three band levels of
    its options and five rows per option (V, rhs, c, 1/pivot, payoff); None
    when that exceeds what a block can have."""
    n_bytes = 4 * (3 * _TILE * 3 * n + _TILE * 5 * n)
    return n_bytes if n_bytes <= _SMEM_MAX else None


def _library():
    lib, _ = load_library(_SOURCE)
    fn = lib.pde_cn1d_tv_fused
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(pay, bands, sc, n, n_time, w):
    n_bytes = _smem_bytes(n)
    if n_bytes is not None:
        return _launch_warp(pay, bands, sc, n, n_time, w, n_bytes)
    return _launch_first(pay, bands, sc, n, n_time, w)


def _launch_first(pay, bands, sc, n, n_time, w):
    """The first design, for lattices too long for the warp route: one
    thread per option, the factors c and d in device-memory scratch."""
    fn = _library()
    B = pay.shape[-1]
    V, C, D = (torch.empty((n, B), dtype=torch.float32, device=pay.device)
               for _ in range(3))
    stream = torch.cuda.current_stream(pay.device).cuda_stream
    with span("pde_tpu_torch.ops.cn1d_tv_fused.launch"):
        err = fn(pay.data_ptr(), bands.data_ptr(), sc.data_ptr(), V.data_ptr(),
                 C.data_ptr(), D.data_ptr(), B, n, n_time, float(w), stream)
    if err != 0:
        raise RuntimeError(f"fused CN march launch failed: CUDA error {err}")
    fused_cn_march_1d_tv.launches += 1
    return V


def _launch_warp(pay, bands, sc, n, n_time, w, n_bytes):
    lib, _ = load_library(_SOURCE)
    fn = lib.pde_cn1d_tv_fused_warp
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B = pay.shape[-1]
    V = torch.empty((n, B), dtype=torch.float32, device=pay.device)
    stream = torch.cuda.current_stream(pay.device).cuda_stream
    with span("pde_tpu_torch.ops.cn1d_tv_fused.launch"):
        err = fn(pay.data_ptr(), bands.data_ptr(), sc.data_ptr(), V.data_ptr(), B, n, n_time,
                 float(w), n_bytes, stream)
    if err != 0:
        raise RuntimeError(f"fused CN march launch failed: CUDA error {err}")
    fused_cn_march_1d_tv.launches += 1
    fused_cn_march_1d_tv.launches_smem += 1
    return V


def _fused_cn_march_1d_tv_plain(pay, bands, sc, n, n_time, w):
    """The march in plain tensor ops, in the kernel's step order; ``bands[k]``
    is level k's rows (3n, B): a lattice, or :class:`_SurfaceLevels`."""
    dt, r, q, K, call_f, amer_f, s_lo, s_hi = sc
    wdt = w * dt
    ewdt = (1.0 - w) * dt
    c = torch.empty_like(pay)
    d = torch.empty_like(pay)
    V = pay.clone()
    for k in range(n_time):
        lo, ln = bands[k], bands[k + 1]
        Lmo, Lco, Lpo = lo[:n], lo[n:2 * n], lo[2 * n:]
        Lmn, Lcn, Lpn = ln[:n], ln[n:2 * n], ln[2 * n:]
        # explicit part on interior rows at level k
        lv = Lmo[1:-1] * V[:-2] + Lco[1:-1] * V[1:-1]
        lv = lv + Lpo[1:-1] * V[2:]
        rhs = V.clone()
        rhs[1:-1] = V[1:-1] + ewdt * lv
        # implicit operator at level k+1 (interior rows), Thomas
        # factorisation fused with the forward sweep; rows 0 and n-1 are
        # identity
        li = -wdt * Lmn
        di = 1.0 - wdt * Lcn
        ui = -wdt * Lpn
        c[0] = 0.0
        d[0] = rhs[0]
        for i in range(1, n - 1):
            piv = 1.0 / (di[i] - li[i] * c[i - 1])
            c[i] = ui[i] * piv
            d[i] = (rhs[i] - li[i] * d[i - 1]) * piv
        Vn = torch.empty_like(V)
        Vn[n - 1] = rhs[n - 1]
        for i in range(n - 2, 0, -1):
            Vn[i] = d[i] - c[i] * Vn[i + 1]
        # Dirichlet rows at tau (both discounts), then the American floor
        tau = dt * float(k + 1)
        dfr = torch.exp(-r * tau)
        dfq = torch.exp(-q * tau)
        Vn[0] = (1.0 - call_f) * (K * dfr - s_lo * dfq)
        Vn[n - 1] = call_f * (s_hi * dfq - K * dfr)
        V = Vn + amer_f * (torch.maximum(Vn, pay) - Vn)
    return V


def fused_cn_march_1d_tv_surface(
    pay,          # (n, B) per-option payoff profile on its K-scaled grid
    xq,           # (n, B) ln S at each option's nodes
    sc,           # (8, B): dt, r, q, K, is_call(0/1), american(0/1), s_min, s_max
    T,            # (B,) maturities: level k is calendar time T - k dt
    log_k,        # (n_k,) the surface's ln K knots, increasing
    t_knots,      # (n_t,) its maturity knots, increasing
    vols,         # (n_t, n_k) its local vols
    n_space: int,
    n_time: int,
    dx: float,    # the log-spot step the operator rows divide by
    r: float,
    q: float,
    w: float = 0.5,
) -> torch.Tensor:
    """March a book backward ``n_time`` steps on a local-vol surface, each
    level's operator rows built from the surface as
    ``solvers/local_vol_pde._band_lattice_batch`` builds them (strike bracket
    searchsorted right, weights clipped to [0, 1], flat beyond the pillars);
    returns V(t=0) as (n, B) float32.  ``launches`` counts the kernel's
    launches."""
    refuse_autograd("fused_cn_march_1d_tv_surface", pay, xq, sc, T, log_k, t_knots, vols)
    n, B = n_space, pay.shape[-1]
    n_k, n_t = log_k.shape[0], t_knots.shape[0]
    for a, shape in ((pay, (n, B)), (xq, (n, B)), (sc, (8, B)), (T, (B,)),
                     (log_k, (n_k,)), (t_knots, (n_t,)), (vols, (n_t, n_k))):
        if tuple(a.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(a.shape)}")
        if a.dtype != torch.float32 or a.device != pay.device:
            raise ValueError("all inputs must be float32 on one device")
        if not a.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    if n < 3 or n_time < 1:
        raise ValueError("the march needs n_space >= 3 and n_time >= 1")
    if n_k < 2 or n_t < 2:
        raise ValueError("the surface needs two knots or more on each axis")
    if pay.device.type == "cuda":
        if not surface_route_fits(n, n_k, n_t):
            raise ValueError(f"a grid of {n} rows on a {n_t} x {n_k} surface is past the "
                             "surface route (surface_route_fits)")
        return _launch_surface(pay, xq, sc, T, log_k, t_knots, vols, n, n_time, dx, r, q,
                               w, _surface_smem_bytes(n, n_k, n_t))
    if pay.device.type == "cpu":
        return _fused_cn_march_1d_tv_surface_plain(pay, xq, sc, T, log_k, t_knots, vols, n,
                                                   n_time, dx, r, q, w)
    raise ValueError(f"no fused CN march for device {pay.device}")


fused_cn_march_1d_tv_surface.launches = 0


def _surface_smem_bytes(n: int, n_k: int, n_t: int):
    """Shared memory of a surface-route block: the surface, then per
    option V, rhs, c, 1/pivot, the payoff, a, b and the strike weight (8n
    floats) and the strike bracket (n 16-bit words); None when that
    exceeds what a block can have."""
    n_bytes = 4 * (n_k + n_t + n_t * n_k + _TILE * (8 * n + (n + 1) // 2))
    return n_bytes if n_bytes <= _SMEM_MAX else None


def surface_route_fits(n_space: int, n_k: int, n_t: int) -> bool:
    """Whether a book of ``n_space`` rows on an ``n_t x n_k`` surface runs
    on the surface route: where the lattice route runs the same warp march
    (n <= 518; at n = 600 its implicit steps left the kernel-vs-twin gate),
    the block's shared memory holds the surface, and the brackets have two
    knots an axis."""
    return (n_k >= 2 and n_t >= 2 and _smem_bytes(n_space) is not None
            and _surface_smem_bytes(n_space, n_k, n_t) is not None)


def _launch_surface(pay, xq, sc, T, log_k, t_knots, vols, n, n_time, dx, r, q, w, n_bytes):
    lib, _ = load_library(_SOURCE)
    fn = lib.pde_cn1d_tv_fused_surface
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B = pay.shape[-1]
    V = torch.empty((n, B), dtype=torch.float32, device=pay.device)
    stream = torch.cuda.current_stream(pay.device).cuda_stream
    # the scalars as the card's torch rounds them in _band_lattice_batch: r - q
    # and dx^2, 2 dx in double, then float32 (as c_float rounds); a tensor
    # divided by a Python number is a product with the float reciprocal
    rq = float(r - q)
    inv_dx2 = float(np.float32(1.0) / np.float32(dx * dx))
    inv_2dx = float(np.float32(1.0) / np.float32(2.0 * dx))
    with span("pde_tpu_torch.ops.cn1d_tv_fused.launch"):
        err = fn(pay.data_ptr(), xq.data_ptr(), sc.data_ptr(), T.data_ptr(),
                 log_k.data_ptr(), t_knots.data_ptr(), vols.data_ptr(), V.data_ptr(), B, n,
                 n_time, log_k.shape[0], t_knots.shape[0], float(w), rq, inv_dx2, inv_2dx,
                 n_bytes, stream)
    if err != 0:
        raise RuntimeError(f"fused CN march launch failed: CUDA error {err}")
    fused_cn_march_1d_tv_surface.launches += 1
    return V


def operator_rows(sig, dx, r, q):
    """Per-node operator rows of the local-vol PDE in ln S, L = diffusion +
    advection - r I, from the local vol ``sig``: ``(L_m, L_c, L_p)``."""
    sigma2 = sig * sig
    a = 0.5 * sigma2 / (dx * dx)
    b = (r - q - 0.5 * sigma2) / (2.0 * dx)
    return a - b, -2.0 * a - r, a + b


def strike_brackets(log_k, x):
    """Each node's strike bracket and weight on the surface's ln K knots,
    as the surface route and the band lattice take them: ``ix`` is the
    count of knots <= x, minus one, clipped to [0, n_k - 2] (``searchsorted``
    right); ``wx`` is clipped to [0, 1], flat beyond the pillars.  ``x``
    (B, n) gives ``(ix, wx)`` (B, n)."""
    ix = torch.clamp(torch.searchsorted(log_k, x, right=True) - 1, 0, log_k.shape[0] - 2)
    wx = torch.clamp((x - log_k[ix]) / (log_k[ix + 1] - log_k[ix]), 0.0, 1.0)
    return ix, wx


def surface_sigma(t_knots, vols, ix, wx, T, dt, levels):
    """The local vol at every node of each option at ``levels`` ((L,)
    float), (B, L, n): level j is calendar time min(max(T - j dt, 0), T)
    for maturities ``T`` and steps ``dt`` (B,); its time bracket and weight
    as :func:`strike_brackets` takes a strike's; the vols interpolated in t,
    then in ln K at the nodes' brackets ``(ix, wx)``."""
    n_t = t_knots.shape[0]
    t = torch.minimum(torch.clamp_min(T[:, None] - dt[:, None] * levels, 0.0), T[:, None])
    it = torch.clamp(torch.searchsorted(t_knots, t, right=True) - 1, 0, n_t - 2)
    wt = torch.clamp((t - t_knots[it]) / (t_knots[it + 1] - t_knots[it]), 0.0, 1.0)
    vols_t = (1.0 - wt)[..., None] * vols[it] + wt[..., None] * vols[it + 1]  # (B, L, n_k)
    at = ix[:, None, :].expand(-1, levels.shape[0], -1)
    return ((1.0 - wx)[:, None, :] * torch.gather(vols_t, 2, at)
            + wx[:, None, :] * torch.gather(vols_t, 2, at + 1))


class _SurfaceLevels:
    """A book's band lattice level by level from the surface: ``[j]`` is
    level j's rows ``(3n, B)``, :func:`operator_rows` of
    :func:`surface_sigma` at level j, as ``solvers/local_vol_pde`` builds
    every level of the lattice.  The last level built is kept: the march
    reads each level twice, as the new level of one step and the old level
    of the next."""

    def __init__(self, xq, T, dt, log_k, t_knots, vols, dx, r, q):
        self.T, self.dt, self.tt, self.vols = T, dt, t_knots, vols
        self.dx, self.r, self.q = dx, r, q
        self.ix, self.wx = strike_brackets(log_k, xq.T.contiguous())   # (B, n)
        self._level = (None, None)

    def sigma(self, j: int) -> torch.Tensor:
        """The local vol at every node at level j, (n, B)."""
        level = torch.full((1,), float(j), dtype=self.T.dtype, device=self.T.device)
        return surface_sigma(self.tt, self.vols, self.ix, self.wx, self.T, self.dt,
                             level)[:, 0].T

    def __getitem__(self, j: int) -> torch.Tensor:
        if self._level[0] != j:
            self._level = (j, torch.cat(operator_rows(self.sigma(j), self.dx, self.r,
                                                      self.q)))
        return self._level[1]


def _fused_cn_march_1d_tv_surface_plain(pay, xq, sc, T, log_k, t_knots, vols, n, n_time,
                                        dx, r, q, w):
    """The surface route's march in plain tensor ops: each level's rows built
    from the surface when the march reaches it, marched in the kernel's
    step order by :func:`_fused_cn_march_1d_tv_plain`."""
    levels = _SurfaceLevels(xq, T, sc[0], log_k, t_knots, vols, dx, r, q)
    return _fused_cn_march_1d_tv_plain(pay, levels, sc, n, n_time, w)

"""Fused 1D theta-scheme march with constant coefficients — a whole option
BOOK in ONE launch (twin of ``pde_tpu/ops/cn1d_fused.py:fused_cn_march_1d``).

In log-spot coordinates on K-scaled grids dx is the same for every option,
so an option's operator is three scalars (L_m, L_c, L_p).  The implicit
matrix is factored once, before the march; each step runs the explicit
part, the factored sweep, the Dirichlet rows and the American floor.

* On a CUDA tensor, :func:`fused_cn_march_1d` launches the CUDA kernel
  ``csrc/cn1d_fused.cu`` or raises: one warp per option, its rows spread
  over the lanes and held in registers for the march, each step's sweeps
  affine shuffle scans whose multiplicative parts are composed once
  (:func:`_warp_plan`); lattices whose chunk exceeds the kernel's register
  chunk (``n > 512``) run the first design, one thread per option.
* On a CPU tensor it runs :func:`_fused_cn_march_1d_plain`, the same step
  order in tensor ops over the batch with Python loops over the rows.

The layout is the reference's, batch last: ``pay (n, B)``, ``sc (12, B)``.

On the H100 its bound is its arithmetic (~16 flops a node and step: ~2 us
at 200x100, B=512), but what binds it is each option's serial chain of
2(n-1) dependent rows per step; the CUDA source's header says what each
design does about it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library, refuse_autograd

__all__ = ["fused_cn_march_1d"]

_SOURCE = "cn1d_fused.cu"
_TILE = 4       # options (warps) a block of the warp route (csrc kTile)
_MAX_CH = 16    # rows a lane of the warp route can hold (csrc kMaxCh)


def fused_cn_march_1d(
    pay,          # (n, B) per-option payoff profile on its K-scaled grid
    sc,           # (12, B): dt, r, q, K, is_call(0/1), american(0/1),
                  #          L_m, L_c, L_p, s_min, s_max, 0
    n_space: int,
    n_time: int,
    w: float = 0.5,   # theta-scheme weight: CN = 1/2, implicit Euler = 1
) -> torch.Tensor:
    """March the whole book backward ``n_time`` steps; returns V(t=0) as
    (n, B) float32.  ``launches`` counts the CUDA kernel's launches of
    either design, ``launches_warp`` those of the warp route."""
    refuse_autograd("fused_cn_march_1d", pay, sc)
    n, B = n_space, pay.shape[-1]
    for a, shape in ((pay, (n, B)), (sc, (12, B))):
        if tuple(a.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(a.shape)}")
        if a.dtype != torch.float32 or a.device != pay.device:
            raise ValueError("all inputs must be float32 on one device")
        if not a.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    if n < 3 or n_time < 1:
        raise ValueError("the march needs n_space >= 3 and n_time >= 1")
    if pay.device.type == "cuda":
        return _launch(pay, sc, n, n_time, w)
    if pay.device.type == "cpu":
        return _fused_cn_march_1d_plain(pay, sc, n, n_time, w)
    raise ValueError(f"no fused CN march for device {pay.device}")


fused_cn_march_1d.launches = 0
fused_cn_march_1d.launches_warp = 0


def _warp_plan(n: int):
    """The warp route's layout for an n-point lattice: ``(ch, n_bytes)`` —
    the rows each lane holds (``ceil(n / 32)``) and the shared memory of a
    block (its options' payoff and result tile) — or None when a lane's
    chunk exceeds the kernel's register chunk (``n > 512``): the first
    design."""
    ch = -(-n // 32)
    return (ch, 4 * _TILE * n) if ch <= _MAX_CH else None


def _library():
    lib, _ = load_library(_SOURCE)
    fn = lib.pde_cn1d_fused
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(pay, sc, n, n_time, w):
    """One launch on the current stream, on the route :func:`_warp_plan`
    picks from n."""
    if _warp_plan(n) is not None:
        return _launch_warp(pay, sc, n, n_time, w)
    return _launch_first(pay, sc, n, n_time, w)


def _launch_first(pay, sc, n, n_time, w):
    """The first design: one thread per option, the factors and the forward
    sweep in device-memory scratch."""
    fn = _library()
    B = pay.shape[-1]
    V, C, INV, D = (torch.empty((n, B), dtype=torch.float32, device=pay.device)
                    for _ in range(4))
    stream = torch.cuda.current_stream(pay.device).cuda_stream
    err = fn(pay.data_ptr(), sc.data_ptr(), V.data_ptr(), C.data_ptr(),
             INV.data_ptr(), D.data_ptr(), B, n, n_time, float(w), stream)
    if err != 0:
        raise RuntimeError(f"fused CN march launch failed: CUDA error {err}")
    fused_cn_march_1d.launches += 1
    return V


@functools.lru_cache(maxsize=None)
def _warp_library():
    lib, _ = load_library(_SOURCE)
    fn = lib.pde_cn1d_fused_warp
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_warp(pay, sc, n, n_time, w):
    """The warp route: one warp per option, four options a block; reads
    ``pay`` and writes V in the (n, B) layout."""
    fn = _warp_library()
    B = pay.shape[-1]
    V = torch.empty((n, B), dtype=torch.float32, device=pay.device)
    stream = torch.cuda.current_stream(pay.device).cuda_stream
    err = fn(pay.data_ptr(), sc.data_ptr(), V.data_ptr(), B, n, n_time, float(w), stream)
    if err != 0:
        raise RuntimeError(f"fused CN march launch failed: CUDA error {err}")
    fused_cn_march_1d.launches += 1
    fused_cn_march_1d.launches_warp += 1
    return V


def _fused_cn_march_1d_plain(pay, sc, n, n_time, w):
    """The march in plain tensor ops, in the kernel's step order."""
    dt, r, q, K, call_f, amer_f, Lm, Lc, Lp, s_lo, s_hi = sc[:11]
    wdt = w * dt
    ewdt = (1.0 - w) * dt
    # implicit bands on interior rows; factor ONCE (rows 0 and n-1 identity)
    li = -wdt * Lm
    di = 1.0 - wdt * Lc
    ui = -wdt * Lp
    c = torch.zeros_like(pay)
    inv = torch.ones_like(pay)
    for i in range(1, n - 1):
        inv[i] = 1.0 / (di - li * c[i - 1])
        c[i] = ui * inv[i]
    d = torch.empty_like(pay)
    V = pay.clone()
    for k in range(n_time):
        lv = Lm * V[:-2] + Lc * V[1:-1]
        lv = lv + Lp * V[2:]
        rhs = V.clone()
        rhs[1:-1] = V[1:-1] + ewdt * lv
        d[0] = rhs[0]
        for i in range(1, n - 1):
            d[i] = (rhs[i] - li * d[i - 1]) * inv[i]
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

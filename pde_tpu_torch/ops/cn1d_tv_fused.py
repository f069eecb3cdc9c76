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

import torch

from ..utils.profiling import span
from .build import load_library, refuse_autograd

__all__ = ["fused_cn_march_1d_tv"]

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
    """The march in plain tensor ops, in the kernel's step order."""
    dt, r, q, K, call_f, amer_f, s_lo, s_hi = sc
    wdt = w * dt
    ewdt = (1.0 - w) * dt
    c = torch.empty_like(pay)
    d = torch.empty_like(pay)
    V = pay.clone()
    for k in range(n_time):
        Lmo, Lco, Lpo = bands[k, :n], bands[k, n:2 * n], bands[k, 2 * n:]
        Lmn, Lcn, Lpn = bands[k + 1, :n], bands[k + 1, n:2 * n], bands[k + 1, 2 * n:]
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

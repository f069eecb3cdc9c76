"""Fused Douglas ADI marches for Heston options (twin of
``pde_tpu/ops/adi_fused.py``).

The whole time loop runs in ONE kernel launch: the explicit A0
(mixed-derivative), A1 and A2 stencils, an implicit sweep along S and one
along v (both factored once, before the march), the Ikonen-Toivanen
multiplier update or the American projection, and the In 't Hout-Foulon
Dirichlet rows.

* :func:`fused_douglas_march_batched` (K1) marches a BOOK on K-scaled log
  grids.  A CUDA tensor launches ``csrc/adi_fused_batched.cu`` or raises; a
  CPU tensor runs :func:`_fused_douglas_march_batched_plain`, the same step
  order in tensor ops over (nS, nv, B).  On the card the march runs one
  512-thread block per option with its state in shared memory, each Thomas
  sweep spread over a group of lanes as a chunked affine scan
  (:func:`_smem_plan` sizes it); with ``pcr_s`` the S sweep is PCR on the
  same route, its level coefficients computed once before the march and
  streamed a level ahead into shared memory; with ``pcr_v`` the v sweep is
  PCR on the same route, its level coefficients kept in shared memory.
  Grids whose state exceeds a block's 227 KB run the first design, one
  128-thread block per option with its state in device memory.  The public
  layout is the reference's ``(…, B)`` (batch last); the CUDA wrapper
  permutes to option-major ``(B, nS, nv)`` and back.
* :func:`fused_douglas_march` (K2) marches ONE option on a general (nS, nv)
  grid with row-aligned bands.  A CUDA tensor launches ``csrc/adi_fused.cu``
  or raises: one 1024-thread block with its state in shared memory and
  lane-group scans (:func:`_smem_plan_single`), or, for grids too large
  for that, the first design, one 256-thread block with its state in
  device memory.  A CPU tensor runs :func:`_fused_douglas_march_plain`.
  Its step order is the reference kernel's own, not K1's:
  ``Y0 = V + dt (A0 V + A1 V + A2 V + lam)``, then ``Y0 - th dt A1 V`` into
  the S sweep.

The tests hold each plain twin against the reference's Pallas kernel, and
``chip_smoke.py`` holds each CUDA kernel against its twin on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils.profiling import span
from .build import load_library, refuse_autograd

__all__ = ["fused_douglas_march", "fused_douglas_march_batched"]

_SOURCE = "adi_fused_batched.cu"
_SOURCE_EXACT = "adi_fused_batched.cu@exact"   # the first design's build (build.VARIANTS)
_SOURCE_SINGLE = "adi_fused.cu"
_TH = 0.5  # Douglas parameter
_SMEM_THREADS = 512   # threads of K1's shared-memory block (csrc kSmemThreads)
_K2_THREADS = 1024    # threads of K2's shared-memory block (adi_fused.cu kSmemThreads)
_SMEM_MAX = 232448    # bytes of shared memory one block can have (227 KB)


def _levels(n: int) -> int:
    """PCR levels for an n-long sweep: strides 1, 2, 4, ... below n."""
    return max(1, math.ceil(math.log2(n)))


def fused_douglas_march_batched(
    pay,           # (nS, 1, B) per-option payoff profile on its own K-scaled grid
    sg,            # (nS, 1, B) per-option spot grid K_b * exp(x_i)
    a1b,           # (3, nv, B) explicit S-operator interior rows [lo, di, up]
    i1b,           # (3, nv, B) implicit S-system interior rows [lo, di, up]
    a2b,           # (3, nv, B) explicit v-operator bands, row-aligned, edges baked
    i2b,           # (3, nv, B) implicit v-system bands, row-aligned (identity at j=nv-1)
    mixb,          # (1, nv, B) mixed-derivative coefficient, zero at both j edges
    sc,            # (8, 1, B): dt, r, q, K, is_call(0/1), american(0/1), 0, 0
    n_spot: int,
    n_vol: int,
    n_time: int,
    use_it: bool = False,
    pcr_v: bool = False,
    pcr_s: bool = False,
) -> torch.Tensor:
    """Douglas ADI march for a whole option batch; returns V(t=0) as
    (nS, nv, B) float32.

    Per-option contract scalars ride ``sc``: a batch may mix strikes,
    maturities, rates, Heston parameters, calls with puts, and European
    with American options.  ``use_it`` treats flagged options with the
    Ikonen-Toivanen splitting (projection otherwise).  ``pcr_v``/``pcr_s``
    solve the v/S sweep by parallel cyclic reduction instead of Thomas:
    the level coefficients (alpha, beta per level) and the final 1/d are
    computed once, and each step reduces the right-hand side with two
    multiply-adds per level.  ``launches`` counts the CUDA kernel's
    launches of either design; ``launches_smem`` those of them that ran
    the shared-memory design, ``launches_pcr_v`` and ``launches_pcr_s``
    those that ran the PCR v or S sweep, ``launches_pcr_v_smem`` and
    ``launches_pcr_s_smem`` those that ran the PCR v or S sweep on the
    shared-memory design.  Under autograd it raises: the kernel has no
    backward (nor has the reference's ``pallas_call``).
    """
    args = (pay, sg, a1b, i1b, a2b, i2b, mixb, sc)
    refuse_autograd("fused_douglas_march_batched", *args)
    nS, nv, B = n_spot, n_vol, pay.shape[-1]
    shapes = ((nS, 1, B), (nS, 1, B), (3, nv, B), (3, nv, B), (3, nv, B),
              (3, nv, B), (1, nv, B), (8, 1, B))
    for a, shape in zip(args, shapes):
        if tuple(a.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(a.shape)}")
        if a.dtype != torch.float32 or a.device != pay.device:
            raise ValueError("all inputs must be float32 on one device")
    if nS < 3 or nv < 3 or n_time < 1:
        raise ValueError("the march needs nS >= 3, nv >= 3 and n_time >= 1")
    if pay.device.type == "cuda":
        plan = _route_plan(nS, nv, use_it, pcr_v, pcr_s)
        if plan is not None:
            return _launch_smem(*args, nS, nv, n_time, use_it, pcr_v, pcr_s, plan)
        return _launch(*args, nS, nv, n_time, use_it, pcr_v, pcr_s)
    if pay.device.type == "cpu":
        return _fused_douglas_march_batched_plain(*args, nS, nv, n_time, use_it,
                                                  pcr_v, pcr_s)
    raise ValueError(f"no fused ADI march for device {pay.device}")


fused_douglas_march_batched.launches = 0
fused_douglas_march_batched.launches_smem = 0
fused_douglas_march_batched.launches_pcr_v = 0
fused_douglas_march_batched.launches_pcr_s = 0
fused_douglas_march_batched.launches_pcr_v_smem = 0
fused_douglas_march_batched.launches_pcr_s_smem = 0


def _library():
    """The first design's launcher, from the build without FMA contraction:
    it rounds as the plain twin does."""
    lib, _ = load_library(_SOURCE_EXACT)
    fn = lib.pde_adi_fused_batched
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _lanes(lines: int, length: int, threads: int = _SMEM_THREADS) -> int:
    """Lanes per line of a sweep on a shared-memory route: a power of two
    up to 32, as many as keep ``lines`` x lanes within the block of
    ``threads`` and at least one row per lane."""
    g = 1
    while g < 32 and 2 * g * lines <= threads and 2 * g <= length:
        g *= 2
    return g


def _bank_degree(words) -> int:
    """The most distinct 4-byte words that one of the 32 shared-memory
    banks serves for one warp access (1: no conflict)."""
    per_bank: dict[int, int] = {}
    for w in set(words):
        per_bank[w % 32] = per_bank.get(w % 32, 0) + 1
    return max(per_bank.values())


def _stride(nS: int, nv: int, gs: int, gv: int) -> int:
    """The padded row stride of a shared-memory route: the least stride
    from nv to nv + 31 whose first warp meets the fewest bank conflicts,
    summed over the S sweep (lanes at rows lane*cs of columns j) and the v
    sweep (lanes at columns lane*cv of rows i)."""
    cs, cv = -(-nS // gs), -(-nv // gv)

    def conflicts(ps):
        s_words = [(t % gs) * cs * ps + t // gs for t in range(32)]
        v_words = [(t // gv) * ps + (t % gv) * cv for t in range(32)]
        return _bank_degree(s_words) + _bank_degree(v_words)

    return min(range(nv, nv + 32), key=lambda p: (conflicts(p), p))


@functools.lru_cache(maxsize=None)
def _smem_plan(nS: int, nv: int, use_it: bool, pcr_s: bool = False, pcr_v: bool = False):
    """The shared-memory route's layout for an (nS, nv) grid: ``(ps, gs,
    gv, n_bytes)`` — the padded row stride (:func:`_stride`), the lanes per
    S column and per v row, and the block's bytes of shared memory — or
    None when that exceeds what a block can have.  The block holds the
    fields on the padded grid and the bands, mix, the v factors, the payoff
    and the spot grid (15 nv + 2 nS floats).  With ``pcr_s`` the S sweep
    is PCR: the block also holds the ping-pong grid and a double buffer of
    level coefficients (:func:`_pcr_buffer`), and every column's lane group
    must fit the block at once.  With ``pcr_v`` the v sweep is PCR: its
    level coefficients (alpha and beta of each level, then 1/d) take the
    place of the two Thomas factors, 2 levels_v nv + nv floats for 2 nv; it
    ping-pongs through V's own row (or, with ``pcr_s``, the ping-pong
    grid), so it adds no field.  Cached: it depends on the shape only, and
    every launch asks for it."""
    gs, gv = _lanes(nv, nS), _lanes(nS, nv)
    ps = _stride(nS, nv, gs, gv)
    fields = 3 + int(use_it)           # V, R, 1/pivot (1/d with pcr_s), lambda
    extra = 0
    if pcr_s:
        if nv * gs > _SMEM_THREADS:
            return None
        fields += 1                    # the ping-pong grid
        extra = _pcr_buffer(nS, nv, ps, gs)
    if pcr_v:
        extra += (2 * _levels(nv) - 1) * nv
    n_bytes = 4 * (fields * nS * ps + extra + 15 * nv + 2 * nS)
    return (ps, gs, gv, n_bytes) if n_bytes <= _SMEM_MAX else None


def _pcr_buffer(nS: int, nv: int, ps: int, gs: int) -> int:
    """Floats of the PCR S sweep's coefficient double buffer (csrc
    ``pcr_buffer_floats``): two levels of alpha and beta for each S-sweep
    thread's chunk of rows, and room for the three bands the factorisation
    ping-pongs before the march."""
    cs = -(-nS // gs)
    return max(4 * cs * nv * gs, 3 * nS * ps)


def _route_plan(nS: int, nv: int, use_it: bool, pcr_v: bool, pcr_s: bool):
    """The plan of the shared-memory route that the flags and the grid take
    (:func:`_smem_plan`), or None for the first design: grids too large for
    a block."""
    return _smem_plan(nS, nv, use_it, pcr_s, pcr_v)


def _launch_smem(pay, sg, a1b, i1b, a2b, i2b, mixb, sc, nS, nv, nT, use_it, pcr_v, pcr_s,
                 plan):
    """The shared-memory route: permute to option-major, launch one block
    per option on the current stream, permute back.  Allocates V and, with
    ``pcr_s``, the table of S-sweep level coefficients (alpha and beta per
    level, in the order the march streams them: level, alpha/beta, row of
    the chunk, S-sweep thread)."""
    lib, _ = load_library(_SOURCE)
    fn = lib.pde_adi_fused_batched_smem
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ps, gs, gv, n_bytes = plan
    B = pay.shape[-1]
    ins = [a.permute(2, 0, 1).contiguous() for a in (pay, sg, a1b, i1b, a2b, i2b, mixb, sc)]
    V = torch.empty((B, nS, nv), dtype=torch.float32, device=pay.device)
    TAB = None
    if pcr_s:
        TAB = torch.empty(B * 2 * _levels(nS) * -(-nS // gs) * nv * gs, dtype=torch.float32,
                          device=pay.device)
    stream = torch.cuda.current_stream(pay.device).cuda_stream
    with span("pde_tpu_torch.ops.adi_fused.launch"):
        err = fn(*(t.data_ptr() for t in (*ins, V)), None if TAB is None else TAB.data_ptr(),
                 B, nS, nv, nT, ps, gs, gv, int(use_it), int(pcr_s), int(pcr_v), n_bytes,
                 stream)
    if err != 0:
        raise RuntimeError(f"fused ADI march launch failed: CUDA error {err}")
    fused_douglas_march_batched.launches += 1
    fused_douglas_march_batched.launches_smem += 1
    fused_douglas_march_batched.launches_pcr_v += int(pcr_v)
    fused_douglas_march_batched.launches_pcr_s += int(pcr_s)
    fused_douglas_march_batched.launches_pcr_v_smem += int(pcr_v)
    fused_douglas_march_batched.launches_pcr_s_smem += int(pcr_s)
    return V.permute(1, 2, 0)


def _launch(pay, sg, a1b, i1b, a2b, i2b, mixb, sc, nS, nv, nT, use_it, pcr_v,
            pcr_s):
    """The first design (grids too large for the shared-memory route; it
    takes every flag): permute to option-major, launch on the current
    stream, permute back.  The PCR variants take their level coefficients in scratch: for v,
    2 levels_v nv alphas and betas in place of the Thomas c2 (and 1/d in
    place of inv2); for S, 2 levels_S nS nv plus nS nv for 1/d; WORK holds
    the six band arrays the level recurrence reads and writes."""
    fn = _library()
    B = pay.shape[-1]
    major = lambda a: a.permute(2, 0, 1).contiguous()  # noqa: E731  (…, B) -> (B, …)
    ins = [major(a) for a in (pay, sg, a1b, i1b, a2b, i2b, mixb, sc)]
    opts = dict(dtype=torch.float32, device=pay.device)
    empty = lambda *shape: torch.empty((B,) + shape, **opts)  # noqa: E731
    V = empty(nS, nv)
    R, D, C1, INV1 = (empty(nS, nv) for _ in range(4))
    LAM = empty(nS, nv) if use_it else None
    C2 = empty(2 * _levels(nv) * nv if pcr_v else nv)
    INV2 = empty(nv)
    SAB = empty(2 * _levels(nS) * nS * nv) if pcr_s else None
    SINVD = empty(nS * nv) if pcr_s else None
    work = nS * nv if pcr_s else nv if pcr_v else 0
    WORK = empty(6 * work) if work else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    ptrs = [ptr(t) for t in (*ins, V, R, D, C1, INV1, LAM, C2, INV2, SAB, SINVD, WORK)]
    stream = torch.cuda.current_stream(pay.device).cuda_stream
    with span("pde_tpu_torch.ops.adi_fused.launch"):
        err = fn(*ptrs, B, nS, nv, nT, int(use_it), int(pcr_v), int(pcr_s), stream)
    if err != 0:
        raise RuntimeError(f"fused ADI march launch failed: CUDA error {err}")
    fused_douglas_march_batched.launches += 1
    fused_douglas_march_batched.launches_pcr_v += int(pcr_v)
    fused_douglas_march_batched.launches_pcr_s += int(pcr_s)
    return V.permute(1, 2, 0)


def _pcr_levels(lo, di, up, axis, n):
    """PCR level coefficients of a time-independent system along ``axis``
    (0: S, 1: v) of (nS, nv, B)-shaped bands, row-aligned (lo[0] = 0,
    up[n-1] = 0): [(alpha, beta)] per level and the final 1/d, exactly as
    the reference kernel forms them (adi_fused.py:396-419, :438-466)."""
    idx = torch.arange(n, device=di.device).reshape((n, 1, 1) if axis == 0 else (1, n, 1))
    levels = []
    for lev in range(_levels(n)):
        s = 1 << lev
        in_lo = (idx >= s).to(di.dtype)             # row i-s exists
        in_hi = (idx < n - s).to(di.dtype)          # row i+s exists
        d_dn = _shift(di, -s, axis) + (1.0 - in_lo)  # out-of-range rows: d = 1
        d_up = _shift(di, s, axis) + (1.0 - in_hi)
        alpha = -(lo * in_lo) / d_dn
        beta = -(up * in_hi) / d_up
        levels.append((alpha, beta))
        lo, up, di = (alpha * _shift(lo, -s, axis), beta * _shift(up, s, axis),
                      di + alpha * _shift(up, -s, axis) + beta * _shift(lo, s, axis))
    return levels, 1.0 / di


def _pcr_solve(rhs, levels, inv_d, axis):
    """Reduce a right-hand side with precomputed levels: two multiply-adds
    per level, then one multiply by 1/d."""
    for lev, (alpha, beta) in enumerate(levels):
        s = 1 << lev
        rhs = rhs + alpha * _shift(rhs, -s, axis) + beta * _shift(rhs, s, axis)
    return rhs * inv_d


def _shift(x, s, axis):
    """``x[i + s]`` along ``axis``; zero where that runs off the grid."""
    out = torch.zeros_like(x)
    src = x.narrow(axis, max(s, 0), x.shape[axis] - abs(s))
    out.narrow(axis, max(-s, 0), x.shape[axis] - abs(s)).copy_(src)
    return out


def _fused_douglas_march_batched_plain(pay, sg, a1b, i1b, a2b, i2b, mixb, sc,
                                       nS, nv, nT, use_it, pcr_v=False, pcr_s=False):
    """The march in plain tensor ops, in the kernel's step order."""
    B = pay.shape[-1]
    dt, r, q, K = sc[0:1], sc[1:2], sc[2:3], sc[3:4]      # (1, 1, B)
    call = sc[4:5] > 0.5
    amer = sc[5:6] > 0.5
    a1L, a1D, a1U = a1b[0:1], a1b[1:2], a1b[2:3]          # (1, nv, B)
    i1L = i1b[0]                                          # (nv, B)
    a2L, a2D, a2U = a2b[0:1], a2b[1:2], a2b[2:3]
    i2L, i2D, i2U = i2b[0], i2b[1], i2b[2]                # (nv, B)
    g = pay                                               # (nS, 1, B)
    zero = torch.zeros((), dtype=pay.dtype, device=pay.device)

    V = g.expand(nS, nv, B).clone()
    lam = torch.zeros_like(V) if use_it else None

    sh_i = lambda x, s: _shift(x, s, 0)  # noqa: E731  x[i+s], zero off the grid
    sh_j = lambda x, s: _shift(x, s, 1)  # noqa: E731  x[:, j+s]

    def interior(x):  # A1 and A0 act on interior rows only
        x[0] = 0.0
        x[nS - 1] = 0.0
        return x

    def apply_a1(V):
        return interior(a1D * V + a1L * sh_i(V, -1) + a1U * sh_i(V, 1))

    def apply_a2(V):
        return a2D * V + a2L * sh_j(V, -1) + a2U * sh_j(V, 1)

    def apply_a0(V):
        up, dn = sh_i(V, 1), sh_i(V, -1)
        Vxv = sh_j(up, 1) - sh_j(up, -1) - sh_j(dn, 1) + sh_j(dn, -1)
        return interior(mixb * Vxv)

    # both implicit operators are time-independent: factor ONCE.  S system:
    # rows 0 and nS-1 are identity (c = 0, inv = 1)
    if pcr_s:
        # full (nS, nv, B) level coefficients: the identity rows couple in,
        # so unlike the bands they are not i-independent across levels
        mi = torch.zeros((nS, 1, 1), dtype=pay.dtype, device=pay.device)
        mi[1:nS - 1] = 1.0
        s_levels = _pcr_levels(i1b[0:1] * mi, i1b[1:2] * mi + (1.0 - mi),
                               i1b[2:3] * mi, 0, nS)
    else:
        c1 = torch.zeros((nS, nv, B), dtype=pay.dtype, device=pay.device)
        inv1 = torch.ones_like(c1)
        for i in range(1, nS - 1):
            inv = 1.0 / (i1b[1] - i1L * c1[i - 1])
            c1[i] = i1b[2] * inv
            inv1[i] = inv
    # v system: (nv, B) coefficients
    if pcr_v:
        v_levels = _pcr_levels(i2b[0:1], i2b[1:2], i2b[2:3], 1, nv)
    else:
        c2 = torch.empty_like(i2D)
        inv2 = torch.empty_like(i2D)
        c2[0] = i2U[0] / i2D[0]
        inv2[0] = 1.0 / i2D[0]
        for j in range(1, nv):
            inv = 1.0 / (i2D[j] - i2L[j] * c2[j - 1])
            c2[j] = i2U[j] * inv
            inv2[j] = inv

    d = torch.empty_like(V)
    is_edge = torch.zeros((nS, nv, 1), dtype=torch.bool, device=pay.device)
    is_edge[0] = is_edge[nS - 1] = True
    is_edge[:, 0] = is_edge[:, nv - 1] = True

    for step in range(nT):
        # rhs1 = V + dt A0 V + (1-th) dt A1 V + dt A2 V (+ dt lam)
        acc = V + dt * apply_a0(V)
        acc = acc + ((1.0 - _TH) * dt) * apply_a1(V)
        acc = acc + dt * apply_a2(V)
        if use_it:
            acc = acc + dt * lam

        if pcr_s:
            Y = _pcr_solve(acc, *s_levels, 0)
        else:
            # implicit S sweep (Thomas along i; row 0 identity, row nS-1
            # identity: its lower band is masked off)
            d[0] = acc[0]
            for i in range(1, nS):
                li = i1L if i < nS - 1 else zero
                d[i] = (acc[i] - li * d[i - 1]) * inv1[i]
            Y = acc
            Y[nS - 1] = d[nS - 1]
            for i in range(nS - 2, -1, -1):
                Y[i] = d[i] - c1[i] * Y[i + 1]

        # rhs2 = Y1 - th dt A2 V
        R = Y - (_TH * dt) * apply_a2(V)

        if pcr_v:
            Vn = _pcr_solve(R, *v_levels, 1)
        else:
            # implicit v sweep (Thomas along j; the j = nv-1 identity row
            # and the j = 0 one-sided row are baked into i2)
            d[:, 0] = R[:, 0] * inv2[0]
            for j in range(1, nv):
                d[:, j] = (R[:, j] - i2L[j] * d[:, j - 1]) * inv2[j]
            Vn = R
            Vn[:, nv - 1] = d[:, nv - 1]
            for j in range(nv - 2, -1, -1):
                Vn[:, j] = d[:, j] - c2[j] * Vn[:, j + 1]

        if use_it:
            # Ikonen-Toivanen multiplier update on flagged options:
            # V_new - dt lam_new = Vn - dt lam, V_new >= g, lam_new >= 0
            W = Vn - dt * lam
            V_it = torch.maximum(g, W)
            lam = torch.where(amer, (V_it - W) / dt, lam)
            Vn = torch.where(amer, V_it, Vn)

        # In 't Hout-Foulon Dirichlet boundaries at tau, rows i = 0 and
        # i = nS-1, then column j = nv-1
        tau = dt * float(step + 1)
        dfr = torch.exp(-r * tau)
        dfq = torch.exp(-q * tau)
        Vn[0] = torch.where(call, zero, K * dfr - sg[0:1] * dfq)[0]
        Vn[nS - 1] = torch.where(call, sg[nS - 1:nS] * dfq - K * dfr, zero)[0]
        Vn[:, nv - 1] = torch.where(call, sg * dfq, K * dfr)[:, 0]

        # projection mode: clamp flagged options everywhere; IT mode: the
        # Dirichlet edges are European — floor flagged options there
        floor = amer & is_edge if use_it else amer
        V = torch.where(floor, torch.maximum(Vn, g), Vn)
    return V


def fused_douglas_march(
    payoff,        # (nS, nv) terminal condition
    a1_bands,      # (a1L, a1D, a1U): row-aligned (nS, nv) explicit S-operator
    i1_bands,      # (i1L, i1D, i1U): row-aligned (nS, nv) implicit S-system
    a2_bands,      # (a2L, a2D, a2U): (nv,) explicit v-operator bands
    i2_bands,      # (i2L, i2D, i2U): (nv,) implicit v-system bands
    mix_coef,      # (nv,) rho sigma v_j / (4 dx dv)
    s_grid,        # (nS,)
    scalars,       # (7,): dt, r, q, K, is_call(0/1), american(0/1), it_lcp(0/1)
    n_spot: int,
    n_vol: int,
    n_time: int,
) -> torch.Tensor:
    """The whole Douglas march of ONE option in one kernel (the reference's
    ``fused_douglas_march``, ``pde_tpu/ops/adi_fused.py:38``); returns
    V(t=0) as (nS, nv) float32.

    Boundary treatment, band conventions and step order are the reference
    kernel's: row-aligned bands (``band[i]`` multiplies the value shifted
    INTO row i, zero where the shift runs off the grid), A0 masked to the
    interior, the mixed coefficient per column; American exercise by
    projection, or by the Ikonen-Toivanen multiplier when the it_lcp flag
    is set.  Inputs of any float dtype are cast to float32.  A CUDA tensor
    launches ``csrc/adi_fused.cu`` or raises; a CPU tensor runs
    :func:`_fused_douglas_march_plain`.  ``launches`` counts the kernel's
    launches of either design, ``launches_smem`` those that ran the
    shared-memory design.
    """
    refuse_autograd("fused_douglas_march", payoff, a1_bands, i1_bands, a2_bands, i2_bands,
                    mix_coef, s_grid, scalars)
    nS, nv = n_spot, n_vol
    grid, vec, sg, sc = _stack_single(payoff, a1_bands, i1_bands, a2_bands, i2_bands,
                                      mix_coef, s_grid, scalars)
    for a, shape in ((grid, (7, nS, nv)), (vec, (7, nv)), (sg, (nS,)), (sc, (7,))):
        if tuple(a.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(a.shape)}")
        if a.device != grid.device:
            raise ValueError("all inputs must be on one device")
    if nS < 3 or nv < 3 or n_time < 1:
        raise ValueError("the march needs nS >= 3, nv >= 3 and n_time >= 1")
    if grid.device.type == "cuda":
        plan = _smem_plan_single(nS, nv)
        if plan is not None:
            return _launch_single_smem(grid, vec, sg, sc, nS, nv, n_time, plan)
        return _launch_single(grid, vec, sg, sc, nS, nv, n_time)
    if grid.device.type == "cpu":
        return _fused_douglas_march_plain(grid, vec, sg, sc, nS, nv, n_time)
    raise ValueError(f"no fused ADI march for device {grid.device}")


fused_douglas_march.launches = 0
fused_douglas_march.launches_smem = 0


@functools.lru_cache(maxsize=None)
def _smem_plan_single(nS: int, nv: int):
    """K2's shared-memory route for an (nS, nv) grid: ``(ps, gs, gv,
    bands_smem, n_bytes)`` — the padded row stride (:func:`_stride`), the
    lanes per S column and per v row of a 1024-thread block, whether the
    (nS, nv) bands and the payoff also sit in shared memory, and the
    block's bytes — or None when the state alone exceeds what a block can
    have.  The state is V, R, 1/pivot and lambda on the padded grid (lambda
    always: the it_lcp flag lies on the device) plus the v bands, mix, the
    v factors, row 0's S factor (10 nv) and the spot grid; the six band
    fields join it where they fit.  Cached per shape."""
    gs, gv = _lanes(nv, nS, _K2_THREADS), _lanes(nS, nv, _K2_THREADS)
    ps = _stride(nS, nv, gs, gv)
    state = 4 * (4 * nS * ps + 10 * nv + nS)
    if state > _SMEM_MAX:
        return None
    with_bands = state + 4 * 6 * nS * ps
    if with_bands <= _SMEM_MAX:
        return (ps, gs, gv, True, with_bands)
    return (ps, gs, gv, False, state)


def _launch_single_smem(grid, vec, sg, sc, nS, nv, nT, plan):
    """K2's shared-memory route: one block on the current stream.
    Allocates only V."""
    lib, _ = load_library(_SOURCE_SINGLE)
    fn = lib.pde_adi_fused_smem
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ps, gs, gv, bands_smem, n_bytes = plan
    V = torch.empty((nS, nv), dtype=torch.float32, device=grid.device)
    ins = [t.contiguous() for t in (grid, vec, sg, sc)]
    stream = torch.cuda.current_stream(grid.device).cuda_stream
    err = fn(*(t.data_ptr() for t in (*ins, V)), nS, nv, nT, ps, gs, gv, int(bands_smem),
             n_bytes, stream)
    if err != 0:
        raise RuntimeError(f"fused ADI march launch failed: CUDA error {err}")
    fused_douglas_march.launches += 1
    fused_douglas_march.launches_smem += 1
    return V


def _stack_single(payoff, a1_bands, i1_bands, a2_bands, i2_bands, mix_coef, s_grid,
                  scalars):
    """K2's public inputs as its kernel's four float32 arrays: G (7, nS, nv)
    = payoff, a1, i1; W (7, nv) = a2, i2, mix; sg (nS,); sc (7,)."""
    f32 = lambda a: torch.as_tensor(a).to(torch.float32)  # noqa: E731
    grid = torch.stack([f32(a) for a in (payoff, *a1_bands, *i1_bands)])
    vec = torch.stack([f32(a) for a in (*a2_bands, *i2_bands, mix_coef)])
    return grid, vec, f32(s_grid), f32(scalars)


def _launch_single(grid, vec, sg, sc, nS, nv, nT):
    """K2's first design (grids too large for the shared-memory route):
    one block on the current stream, its state in device-memory scratch."""
    lib, _ = load_library(_SOURCE_SINGLE)
    fn = lib.pde_adi_fused
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    opts = dict(dtype=torch.float32, device=grid.device)
    V = torch.empty((nS, nv), **opts)
    S = torch.empty((5, nS, nv), **opts)  # lam, rhs, d, c1, inv1
    S2 = torch.empty((2, nv), **opts)     # c2, inv2
    ins = [t.contiguous() for t in (grid, vec, sg, sc)]
    stream = torch.cuda.current_stream(grid.device).cuda_stream
    err = fn(*(t.data_ptr() for t in (*ins, V, S, S2)), nS, nv, nT, stream)
    if err != 0:
        raise RuntimeError(f"fused ADI march launch failed: CUDA error {err}")
    fused_douglas_march.launches += 1
    return V


def _fused_douglas_march_plain(grid, vec, sg, sc, nS, nv, nT):
    """K2's march in plain tensor ops over the (nS, nv) grid, in the
    reference kernel's step order, sweeps as Python loops over rows."""
    g, a1L, a1D, a1U, i1L, i1D, i1U = grid
    a2L, a2D, a2U, i2L, i2D, i2U, mix = vec
    dt, r, q, K = sc[0], sc[1], sc[2], sc[3]
    is_call, american, it_lcp = sc[4] > 0.5, sc[5] > 0.5, sc[6] > 0.5
    sh_i = lambda x, s: _shift(x, s, 0)  # noqa: E731  x[i+s], zero off the grid
    sh_j = lambda x, s: _shift(x, s, 1)  # noqa: E731  x[i, j+s]
    ii = torch.arange(nS, device=g.device)[:, None]
    jj = torch.arange(nv, device=g.device)[None, :]
    interior = (ii > 0) & (ii < nS - 1) & (jj > 0) & (jj < nv - 1)
    edge = (ii == 0) | (ii == nS - 1) | (jj == 0) | (jj == nv - 1)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)

    def apply_a1(V):  # the bands are zero where the shift runs off the grid
        return a1D * V + a1L * sh_i(V, -1) + a1U * sh_i(V, 1)

    def apply_a2(V):
        return V * a2D + sh_j(V, -1) * a2L + sh_j(V, 1) * a2U

    def apply_a0(V):
        Vxv = (sh_i(sh_j(V, 1), 1) - sh_i(sh_j(V, -1), 1)
               - sh_i(sh_j(V, 1), -1) + sh_i(sh_j(V, -1), -1))
        return torch.where(interior, mix * Vxv, zero)

    def thomas_columns(lo, di, up):
        """Factors of a time-independent system, as lists of rows."""
        c, inv = [up[0] / di[0]], [1.0 / di[0]]
        for k in range(1, lo.shape[0]):
            inv.append(1.0 / (di[k] - lo[k] * c[k - 1]))
            c.append(up[k] * inv[k])
        return c, inv

    # both implicit operators are time-independent: factor ONCE
    c1, inv1 = thomas_columns(i1L, i1D, i1U)     # rows of (nv,)
    c2, inv2 = thomas_columns(i2L, i2D, i2U)     # scalars per column j

    V = g.clone()
    lam = torch.zeros_like(g)
    for step in range(nT):
        Y0 = V + dt * (apply_a0(V) + apply_a1(V) + apply_a2(V)
                       + torch.where(it_lcp, lam, zero))

        # implicit S sweep
        t = Y0 - _TH * dt * apply_a1(V)
        d = [t[0] * inv1[0]]
        for i in range(1, nS):
            d.append((t[i] - i1L[i] * d[i - 1]) * inv1[i])
        y = [d[nS - 1]]
        for i in range(nS - 2, -1, -1):
            y.append(d[i] - c1[i] * y[-1])
        Y1 = torch.stack(y[::-1])

        # implicit v sweep
        t2 = Y1 - _TH * dt * apply_a2(V)
        d = [t2[:, 0] * inv2[0]]
        for j in range(1, nv):
            d.append((t2[:, j] - i2L[j] * d[j - 1]) * inv2[j])
        y = [d[nv - 1]]
        for j in range(nv - 2, -1, -1):
            y.append(d[j] - c2[j] * y[-1])
        Vn = torch.stack(y[::-1], 1)

        # Ikonen-Toivanen multiplier update: V_new - dt lam_new = Vn - dt lam,
        # V_new >= g, lam_new >= 0, lam_new (V_new - g) = 0
        W = Vn - dt * lam
        V_it = torch.maximum(g, W)
        lam = torch.where(it_lcp, (V_it - W) / dt, lam)
        Vn = torch.where(it_lcp, V_it, Vn)

        # In 't Hout-Foulon Dirichlet boundaries at tau
        tau = dt * float(step + 1)
        dfr = torch.exp(-r * tau)
        dfq = torch.exp(-q * tau)
        Vn = torch.where(ii == 0, torch.where(is_call, zero, K * dfr - sg[0] * dfq), Vn)
        Vn = torch.where(ii == nS - 1, torch.where(is_call, sg[nS - 1] * dfq - K * dfr,
                                                   zero), Vn)
        Vn = torch.where(jj == nv - 1, torch.where(is_call, sg[:, None] * dfq, K * dfr), Vn)
        # projection-mode American: clamp everywhere; it_lcp: the Dirichlet
        # rows are European, floor them at intrinsic
        Vn = torch.where(american & ~it_lcp, torch.maximum(Vn, g), Vn)
        V = torch.where(it_lcp & edge, torch.maximum(Vn, g), Vn)
    return V

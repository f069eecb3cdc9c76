"""Fused Douglas ADI march for a batch of Heston options (twin of
``pde_tpu/ops/adi_fused.py:fused_douglas_march_batched``).

The whole time loop of a book runs in ONE kernel launch: the explicit A0
(mixed-derivative), A1 and A2 stencils, a Thomas sweep along S and one along
v (both factored once, before the march), the Ikonen-Toivanen multiplier
update or the American projection, and the In 't Hout-Foulon Dirichlet rows.

* On a CUDA tensor, :func:`fused_douglas_march_batched` launches the CUDA
  kernel ``csrc/adi_fused_batched.cu`` (one thread block per option) or
  raises.
* On a CPU tensor it runs :func:`_fused_douglas_march_batched_plain`, the
  same step order in tensor ops over (nS, nv, B) with Python loops for the
  sweeps.  The tests hold it against the reference's Pallas kernel, and
  ``chip_smoke.py`` holds the CUDA kernel against it on the card.

The public layout is the reference's ``(…, B)`` (batch last); the CUDA
wrapper permutes to option-major ``(B, nS, nv)`` and back.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library

__all__ = ["fused_douglas_march_batched"]

_SOURCE = "adi_fused_batched.cu"
_TH = 0.5  # Douglas parameter


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
) -> torch.Tensor:
    """Douglas ADI march for a whole option batch; returns V(t=0) as
    (nS, nv, B) float32.

    Per-option contract scalars ride ``sc``: a batch may mix strikes,
    maturities, rates, Heston parameters, calls with puts, and European
    with American options.  ``use_it`` treats flagged options with the
    Ikonen-Toivanen splitting (projection otherwise).  ``launches`` counts
    the CUDA kernel's launches.  The reference's ``pcr_v``/``pcr_s`` sweep
    variants are not ported yet.
    """
    args = (pay, sg, a1b, i1b, a2b, i2b, mixb, sc)
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
        return _launch(*args, nS, nv, n_time, use_it)
    if pay.device.type == "cpu":
        return _fused_douglas_march_batched_plain(*args, nS, nv, n_time, use_it)
    raise ValueError(f"no fused ADI march for device {pay.device}")


fused_douglas_march_batched.launches = 0


def _library():
    lib, _ = load_library(_SOURCE)
    fn = lib.pde_adi_fused_batched
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(pay, sg, a1b, i1b, a2b, i2b, mixb, sc, nS, nv, nT, use_it):
    """Permute to option-major, launch on the current stream, permute back."""
    fn = _library()
    B = pay.shape[-1]
    major = lambda a: a.permute(2, 0, 1).contiguous()  # noqa: E731  (…, B) -> (B, …)
    ins = [major(a) for a in (pay, sg, a1b, i1b, a2b, i2b, mixb, sc)]
    opts = dict(dtype=torch.float32, device=pay.device)
    V = torch.empty((B, nS, nv), **opts)
    R, D, C1, INV1 = (torch.empty((B, nS, nv), **opts) for _ in range(4))
    LAM = torch.empty((B, nS, nv), **opts) if use_it else None
    C2, INV2 = (torch.empty((B, nv), **opts) for _ in range(2))
    ptrs = [t.data_ptr() for t in (*ins, V, R, D, C1, INV1)]
    ptrs += [LAM.data_ptr() if use_it else None, C2.data_ptr(), INV2.data_ptr()]
    stream = torch.cuda.current_stream(pay.device).cuda_stream
    err = fn(*ptrs, B, nS, nv, nT, int(use_it), stream)
    if err != 0:
        raise RuntimeError(f"fused ADI march launch failed: CUDA error {err}")
    fused_douglas_march_batched.launches += 1
    return V.permute(1, 2, 0)


def _fused_douglas_march_batched_plain(pay, sg, a1b, i1b, a2b, i2b, mixb, sc,
                                       nS, nv, nT, use_it):
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

    def sh_i(x, s):  # x[i+s]; zero where it runs off the grid
        out = torch.zeros_like(x)
        if s > 0:
            out[:-s] = x[s:]
        else:
            out[-s:] = x[:s]
        return out

    def sh_j(x, s):  # x[:, j+s]
        out = torch.zeros_like(x)
        if s > 0:
            out[:, :-s] = x[:, s:]
        else:
            out[:, -s:] = x[:, :s]
        return out

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
    c1 = torch.zeros((nS, nv, B), dtype=pay.dtype, device=pay.device)
    inv1 = torch.ones_like(c1)
    for i in range(1, nS - 1):
        inv = 1.0 / (i1b[1] - i1L * c1[i - 1])
        c1[i] = i1b[2] * inv
        inv1[i] = inv
    # v system: (nv, B) coefficients
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

        # implicit v sweep (Thomas along j; the j = nv-1 identity row and
        # the j = 0 one-sided row are baked into i2)
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

"""Bounded Levenberg-Marquardt on tensors (twin of ``pde_tpu/calibrate/lm.py``).

* Jacobians by forward-mode AD (``torch.func.jacfwd``: 5 tangents for
  Heston, exact).  The Heston residuals pass through complex sqrt, log,
  exp, division, ``.real``/``.imag``, cos and sin; forward-mode AD covers
  each of them, so no reverse pass is needed.
* Damped normal equations per iteration, lambda adapted by accept/reject
  with masked, fixed-trip-count control flow: no host read in the loop.
* Box bounds by projection, so the iterate stays feasible like scipy's TRF.
* Several starts run as one batch dimension (the reference vmaps ``polish``
  over the starts): ``x0`` of shape (S, n).  Per-start ``data`` (tensors
  with a leading S axis, mapped beside ``x``) lets S different problems —
  M smiles with their own strikes, vols, forward and maturity — fit in one
  call, as the reference's ``jax.vmap`` over ``_fit_smile`` does.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, NamedTuple, Optional, Sequence

import torch

__all__ = ["LMResult", "levenberg_marquardt"]


class LMResult(NamedTuple):
    x: torch.Tensor
    cost: torch.Tensor  # 0.5 * sum(residuals^2), scipy convention
    n_iter: torch.Tensor
    converged: torch.Tensor
    grad_norm: torch.Tensor


# PyTorch keeps forward-mode AD levels, and the TF32 flag set below, per
# process, not per thread: two threads inside ``jacfwd`` at once corrupt
# each other's level ("no level exists"), and one thread's restore of the
# flag can turn TF32 back on under another's solve.  So every region that
# runs ``jacfwd`` under full-fp32 matmuls (the LM's march, the Heston quote
# sensitivities) holds this one lock; callers on other threads (the
# orchestrator's concurrent ``run_all``) overlap everything else.
_MARCH = threading.RLock()


@contextlib.contextmanager
def _full_fp32_matmul():
    """J^T J in full float32, one region at a time (``_MARCH``): TF32 keeps
    ~3 decimal digits, which turns the normal equations of a 1e8-conditioned
    Jacobian into noise and stalls the march (the reference needed
    ``Precision.HIGHEST`` on the TPU for the same reason).  False is torch's
    default; it is set here, for the region's duration only, rather than
    relied on.  Run the region's ``jacfwd`` inside it too."""
    with _MARCH:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def levenberg_marquardt(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    max_iter: int = 50,
    lam0: float = 1e-3,
    ftol: float = 1e-10,
    gtol: float = 1e-10,
    xtol: float = 1e-10,
    data: Optional[Sequence[torch.Tensor]] = None,
) -> LMResult:
    """Minimize 0.5 ||residual_fn(x, *data)||^2 subject to lower <= x <= upper.

    ``residual_fn`` maps (n,) [and one slice of each ``data`` tensor] to
    (m,) and must be traceable by ``torch.func`` (no in-place writes to
    its inputs, no host reads).  ``x0`` is (n,) for one start or (S, n)
    for S starts solved together; each ``data`` tensor then has a leading
    S axis, and start s sees its slice s.  The result's leading dimension
    follows ``x0``.
    """
    single = x0.dim() == 1
    x = torch.clamp(x0.reshape(-1, x0.shape[-1]), lower, upper)
    S, n = x.shape
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    # the scipy-convention defaults (1e-10) are unreachable in float32, where
    # relative cost improvements bottom out near machine epsilon: floor the
    # tolerances at a small multiple of the working precision
    eps = float(torch.finfo(x.dtype).eps)
    ftol = max(ftol, 4.0 * eps)
    gtol = max(gtol, 4.0 * eps)
    xtol = max(xtol, 4.0 * eps)

    data = tuple(data or ())
    res_b = torch.func.vmap(residual_fn)
    jac_b = torch.func.vmap(torch.func.jacfwd(residual_fn, argnums=0))

    def normal_eqs(x):
        r = res_b(x, *data)                            # (S, m)
        J = jac_b(x, *data)                            # (S, m, n)
        JT = J.transpose(-1, -2)
        return 0.5 * torch.sum(r * r, dim=-1), JT @ J, (JT @ r[..., None])[..., 0]

    with _full_fp32_matmul():
        cost, JTJ, JTr = normal_eqs(x)
        lam = torch.full((S,), lam0, dtype=x.dtype, device=x.device)
        done = torch.zeros((S,), dtype=torch.bool, device=x.device)
        n_iter = torch.zeros((S,), dtype=torch.int64, device=x.device)

        for _ in range(max_iter):
            # Marquardt scaling: lam * diag(JTJ) keeps steps well-conditioned
            damp = lam[:, None] * torch.clamp_min(torch.diagonal(JTJ, dim1=-2, dim2=-1), 1e-12)
            A = JTJ + torch.diag_embed(damp) + 1e-14 * eye
            delta = -torch.linalg.solve(A, JTr)
            x_new = torch.clamp(x + delta, lower, upper)

            cost_new, JTJ_new, JTr_new = normal_eqs(x_new)
            accept = cost_new < cost

            rel_impr = (cost - cost_new) / torch.clamp_min(cost, 1e-300)
            # ftol fires only when the damping is back at (or below) trust
            # level: with lam inflated by rejected steps, an accepted step is
            # small because the STEP is small, not because the optimum is near
            trusted = lam <= lam0
            conv = accept & (rel_impr < ftol) & trusted
            conv = conv | (torch.amax(torch.abs(JTr), dim=-1) < gtol)
            # xtol (scipy TRF semantics): the step has shrunk to working
            # precision relative to x; a rejected step counts only when the
            # cost barely moved (the at-the-optimum signature)
            step_norm = torch.linalg.vector_norm(x_new - x, dim=-1)
            step_small = step_norm <= xtol * (xtol + torch.linalg.vector_norm(x, dim=-1))
            conv = conv | (step_small & (accept | (torch.abs(rel_impr) < ftol)))

            take = accept & ~done
            x = torch.where(take[:, None], x_new, x)
            cost = torch.where(take, cost_new, cost)
            JTJ = torch.where(take[:, None, None], JTJ_new, JTJ)
            JTr = torch.where(take[:, None], JTr_new, JTr)
            lam = torch.where(done, lam, torch.where(accept, lam / 3.0, lam * 2.0))
            n_iter = n_iter + (~done).long()
            done = done | conv

    out = LMResult(x=x, cost=cost, n_iter=n_iter, converged=done,
                   grad_norm=torch.amax(torch.abs(JTr), dim=-1))
    if single:
        out = LMResult(*(t[0] for t in out))
    return out

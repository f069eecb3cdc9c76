"""The G2++ Bermudan swaption sandwich (``pde_tpu_torch/solvers/
bermudan_g2.py``) held against ``pde_tpu`` (x64) on the CPU.

Gates, each with its reason:
- ``remaining_swap_value_g2``, the regression basis and one exact step
  (``_step_sampler``, on the reference's own normals): 1e-10 relative in
  float64;
- the covariance factor: the reference's ``1e-18 I`` jitter vanishes in
  float32 as in float64 here, and a covariance that is not positive
  definite gives a NaN factor below the diagonal, as
  ``jnp.linalg.cholesky`` returns it, where ``torch.linalg.cholesky``
  would raise;
- the sandwich on the reference's own draws (``jax_key_draws.JaxKey``:
  ``(reg, outer, inner)``, then ``(next, draw)`` chains, a ``(3,) +
  paths`` normal draw a step): 1e-10 relative in float64;
- the reference suite's checks (``tests/test_g2.py:193-220``) on the
  port's generator (Philox): the single-date collapse onto
  ``g2_swaption`` (4 s.e. + 2e-4) with the dual exact (upper = lower), and
  the full schedule's sandwich above the best European and ordered.
Sizes: at most 4096 paths; the reference compiles its nested
continuation loops whole, so the parity runs on three exercise dates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_key_draws import JaxKey

from pde_tpu.models import g2 as jg2
from pde_tpu.models import rates as jr
from pde_tpu.solvers import bermudan_g2 as jb
from pde_tpu_torch import interop
from pde_tpu_torch.models import g2 as tg2
from pde_tpu_torch.models import rates as tr
from pde_tpu_torch.solvers import bermudan_g2 as tb

F64 = torch.float64
REL = dict(rtol=1e-10, atol=0.0)
TIMES = np.array([0.5, 1.0, 2.0, 5.0, 10.0, 30.0])
ZEROS = np.array([0.030, 0.032, 0.035, 0.040, 0.042, 0.043])
DYN = (0.5, 0.05, 0.01, 0.008, -0.6)
SCHED = np.arange(1.0, 4.01, 0.5)


@pytest.fixture(scope="module")
def params():
    jp = jg2.G2Params(*map(jnp.asarray, DYN), jr.curve_from_zero_rates(TIMES, ZEROS))
    return jp, interop.g2_params(jp)


def _close(got, want, **gate):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()), np.asarray(want),
                               **(gate or REL))


def test_swap_value_basis_and_step_match_reference(params):
    jp, tp = params
    x = np.linspace(-0.04, 0.04, 9)
    y = np.linspace(0.02, -0.02, 9)
    for j in (0, 4):
        for payer in (True, False):
            _close(tb.remaining_swap_value_g2(tp, 0.035, torch.tensor(SCHED), j,
                                              torch.tensor(x), torch.tensor(y), payer),
                   jb.remaining_swap_value_g2(jp, 0.035, jnp.asarray(SCHED), j, x, y, payer))
    _close(tb._basis2(torch.tensor(x), torch.tensor(y)), jb._basis2(x, y))
    key = jax.random.PRNGKey(4)
    want = jb._step_sampler(jp, 1.0, 1.5, jnp.float64)(jnp.asarray(x), jnp.asarray(y),
                                                       jnp.zeros(9), key)
    got = tb._step_sampler(tp, torch.tensor(1.0, dtype=F64), torch.tensor(1.5, dtype=F64),
                           F64)(torch.tensor(x), torch.tensor(y), torch.zeros(9, dtype=F64),
                                JaxKey(key))
    for g, w in zip(got, want):
        _close(g, w)


def test_a_covariance_that_is_not_positive_definite_gives_nan(params, monkeypatch):
    _, tp = params
    real = tg2.g2_joint_increment_moments

    def singular(p, dt):
        means, cov = real(p, dt)
        return means, cov.new_tensor([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 1.0]])

    monkeypatch.setattr(tg2, "g2_joint_increment_moments", singular)
    step = tb._step_sampler(tp, torch.tensor(1.0, dtype=F64), torch.tensor(1.5, dtype=F64), F64)
    x = torch.zeros(4, dtype=F64)
    out = step(x, x, x, JaxKey(jax.random.PRNGKey(0)))
    # the whole lower triangle is NaN, the diagonal included, as in the reference
    assert all(bool(torch.isnan(o).all()) for o in out)


def test_sandwich_matches_reference(params):
    jp, tp = params
    key = jax.random.PRNGKey(2)
    sched = np.arange(1.0, 2.51, 0.5)
    kw = dict(n_paths=2048, n_outer=32, n_inner=8)
    want = jb.bermudan_swaption_g2_mc(jp, 0.034, jnp.asarray(sched), key, **kw)
    got = tb.bermudan_swaption_g2_mc(tp, 0.034, torch.tensor(sched), JaxKey(key), **kw)
    for g, w in zip(got, want):
        _close(g, w)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_single_date_collapse_and_sandwich_over_the_europeans(params):
    _, tp = params
    sched = torch.tensor(SCHED)
    K = float(tr.hw_swap_rate(tp.curve, 1.0, sched[1:]))
    euro = float(tg2.g2_swaption(tp, K, 1.0, sched[1:], payer=True))
    lo, sel, up, seu = (float(v) for v in tb.bermudan_swaption_g2_mc(
        tp, K, sched, _gen(0), exercise=(True,) + (False,) * 5, n_paths=1 << 12, n_outer=64,
        n_inner=8))
    assert abs(lo - euro) < 4 * sel + 2e-4
    assert abs(up - lo) < 1e-12
    lo, sel, up, seu = (float(v) for v in tb.bermudan_swaption_g2_mc(
        tp, K, sched, _gen(1), n_paths=1 << 12, n_outer=64, n_inner=8))
    euros = [float(tg2.g2_swaption(tp, K, float(sched[j]), sched[j + 1:]))
             for j in range(len(SCHED) - 1)]
    assert lo >= max(euros) - 4 * sel - 1e-4
    assert up >= lo - 1e-12
    assert up - lo < 0.3 * lo + 4 * (sel + seu)

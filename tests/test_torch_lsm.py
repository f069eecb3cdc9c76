"""The port's Longstaff-Schwartz solvers (``pde_tpu_torch/solvers/lsm.py``)
held against ``pde_tpu`` (x64) on the CPU.

Gates, each with its reason:
- ``lsm_backward_induction`` on the reference's own stored paths (JAX's
  ``simulate_qe_paths``, fed as numpy): the cashflow at 1e-10 relative in
  float64 (the regression sums and the 6x6 solve round in another order,
  ~1e-14; an exercise decision on a path within that of its fitted
  continuation would flip, and none is); the collected policy at 1e-10
  relative to each date's largest coefficient (the raw-space
  coefficients cancel, e.g. +648 against -569, so a solve's rounding is
  relative to the row, not to each entry: one entry sat 1.03e-10 off);
- ``price_american_lsm`` and ``price_american_lsm_batch`` on the
  reference's draws (``jax_key_draws.JaxKey``): 1e-10 relative;
- the batch against the single-contract pricer on one generator's paths:
  1e-12 relative, as the reference's own
  ``tests/test_lsm.py::TestLSMBatch::test_batch_matches_single_exactly``;
- ``axis_name``: the induction on the reference's stored paths with the
  path axis split over P = 2 and 4 gloo ranks equals the reference's
  single-device induction at 1e-9 absolute (its own sharded test's gate,
  ``tests/test_mc_sharded.py:34-57``), on every rank.
Sizes: at most 4096 paths x 16 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_key_draws import JaxKey

from pde_tpu.models import heston_mc as jmc
from pde_tpu.models.heston import HestonParams as JParams
from pde_tpu.solvers import lsm as jlsm
from pde_tpu_torch.models import heston_mc
from pde_tpu_torch.models.heston import HestonParams as TParams
from pde_tpu_torch.solvers import lsm as tlsm

F64 = torch.float64
FIELDS = (2.0, 0.04, 0.3, -0.7, 0.04)
JP, TP = JParams(*FIELDS), TParams(*FIELDS)
S0 = torch.tensor(100.0, dtype=F64)
KEY = jax.random.PRNGKey(11)
KW = dict(rate=0.05, n_steps=16, n_paths=4096)
REL = dict(rtol=1e-10, atol=0.0)


def _close(got, want, **gate):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()), np.asarray(want),
                               **(gate or REL))


@pytest.mark.parametrize("strike,is_call", [(100.0, False), (93.5, True)])
def test_backward_induction_and_policy_match(strike, is_call):
    s_path, v_path = jmc.simulate_qe_paths(JP, 100.0, 1.0, KEY, n_steps=16, n_paths=4096,
                                           rate=0.05, dividend=0.03)
    sign = 1.0 if is_call else -1.0
    disc = float(np.exp(-0.05 / 16))
    want_cf, (want_g, want_c) = jlsm.lsm_backward_induction(
        s_path, v_path, strike, sign, disc, collect_policy=True)
    got_cf, (got_g, got_c) = tlsm.lsm_backward_induction(
        torch.as_tensor(np.array(s_path)), torch.as_tensor(np.array(v_path)), strike,
        sign, disc, collect_policy=True)
    assert got_g.shape == (15, 6) and got_c.shape == (15,)
    _close(got_cf, want_cf)
    want_g, want_c = np.asarray(want_g), np.asarray(want_c)
    row = np.abs(want_g).max(axis=1)
    assert (np.abs(got_g.numpy() - want_g).max(axis=1) <= 1e-10 * row).all()
    assert (np.abs(got_c.numpy() - want_c) <= 1e-10 * np.maximum(row, np.abs(want_c))).all()
    plain = tlsm.lsm_backward_induction(torch.as_tensor(np.array(s_path)),
                                        torch.as_tensor(np.array(v_path)), strike, sign,
                                        disc)
    torch.testing.assert_close(plain, got_cf, rtol=0.0, atol=0.0)


@pytest.mark.parametrize("strike,kw", [
    (100.0, dict()),
    (130.0, dict(dividend=0.02)),
    (105.0, dict(is_call=True, dividend=0.04, antithetic=False)),
])
def test_price_american_lsm_matches(strike, kw):
    want = jlsm.price_american_lsm(JP, strike, 1.0, 100.0, KEY, **KW, **kw)
    got = tlsm.price_american_lsm(TP, strike, 1.0, S0, JaxKey(KEY), **KW, **kw)
    for g, w in zip(got, want):
        assert g.shape == ()
        _close(g, w)


def test_batch_matches_reference():
    strikes = [85.0, 97.3, 100.0, 110.0, 121.0]
    calls = [False, True, False, True, False]
    want = jlsm.price_american_lsm_batch(JP, jnp.array(strikes), jnp.array(calls), 1.0, 100.0,
                                         KEY, **KW, dividend=0.02)
    got = tlsm.price_american_lsm_batch(TP, strikes, calls, 1.0, S0, JaxKey(KEY), **KW,
                                        dividend=0.02)
    for g, w in zip(got, want):
        assert g.shape == (5,)
        _close(g, w)


def test_batch_matches_single_exactly():
    """One generator seed, one path set: the book's regression per strike
    is the single contract's, to 1e-12 (the reference's own gate)."""
    kw = dict(rate=0.05, n_steps=16, n_paths=4096)
    strikes = [90.0, 100.0, 110.0]
    prices, ses = tlsm.price_american_lsm_batch(TP, strikes, False, 1.0, S0,
                                                torch.Generator().manual_seed(3), **kw)
    for i, k in enumerate(strikes):
        p1, se1 = tlsm.price_american_lsm(TP, k, 1.0, S0, torch.Generator().manual_seed(3),
                                          **kw)
        np.testing.assert_allclose(float(prices[i]), float(p1), rtol=1e-12)
        np.testing.assert_allclose(float(ses[i]), float(se1), rtol=1e-12)
    # shared paths cannot break per-contract monotonicity
    assert bool((torch.diff(prices) > 0).all())


def test_put_dominates_intrinsic_and_european_on_generator_paths():
    """The port's own paths: the deep-ITM put is worth its intrinsic value
    (t_0 exercise), and the ATM put beats the European MC put (r > 0)."""
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    kw = dict(rate=0.05, n_steps=16, n_paths=4096)
    deep, _ = tlsm.price_american_lsm(TP, 130.0, 1.0, S0, g(), **kw)
    assert float(deep) >= 30.0 - 0.05
    amer, se = tlsm.price_american_lsm(TP, 100.0, 1.0, S0, g(), **kw)
    euro, se_e = heston_mc.price_european_mc(TP, 100.0, 1.0, S0, g(), is_call=False, **kw)
    assert float(amer) > float(euro) - 4 * float(se)


def test_axis_name_waits_for_parallel(tmp_path):
    """(Named when ``axis_name`` raised.)  The regression sums all-reduced
    over the ranks holding the paths: P = 2 (a (2, 2) mesh's columns) and
    P = 4 ranks of one spawned gloo group reproduce the single-device
    induction of the reference on the same paths."""
    import torch_dist_workers as W

    s_path, v_path = jmc.simulate_qe_paths(JP, 100.0, 1.0, jax.random.PRNGKey(7),
                                           n_steps=16, n_paths=4096, rate=0.05,
                                           antithetic=False)
    disc = jnp.exp(jnp.asarray(-0.05 * 1.0 / 16, s_path.dtype))
    want = np.asarray(jlsm.lsm_backward_induction(s_path, v_path, 100.0, -1.0, disc))
    args = (torch.tensor(np.asarray(s_path)), torch.tensor(np.asarray(v_path)), 100.0, -1.0,
            torch.tensor(float(disc), dtype=F64))
    run = W.run_ranks(4, [(f"p{P}", W.case_lsm_induction, (P, *args)) for P in (2, 4)],
                      tmp_path)
    one = tlsm.lsm_backward_induction(*args, collect_policy=True)[1]
    for P in (2, 4):
        got = W.same_on_every_rank(W.outputs(run, f"p{P}"))
        np.testing.assert_allclose(got["cash"], want, rtol=0, atol=1e-9)
        # the policy is the global one, the port's single-device fit's
        scale = np.abs(one[0].numpy()).max(axis=1, keepdims=True)
        np.testing.assert_allclose(got["gamma"] / scale, one[0].numpy() / scale, atol=1e-10)

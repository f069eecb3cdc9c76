"""The Monte Carlo names of the port's Bates and SVCJ models
(``pde_tpu_torch/models/{bates,svcj}.py``) held against ``pde_tpu`` (x64)
on the CPU.

The port runs on the reference's own draws (``jax_key_draws.JaxKey``: the
step keys, then ``(k_diff, k_n, k_j)`` per Bates step and ``(k_diff,
k_jump)``, ``(k_n, k_v, k_z)`` per SVCJ step, the Poisson counts, gamma
sums and normals as ``jax.random`` draws them).  Gates, each with its
reason:
- every simulator output (``simulate_qe``'s fields, ``simulate_qe_paths``,
  SVCJ's ``simulate_qe_qv``) and every pricer (European, path payoff,
  American by Longstaff-Schwartz on the jump paths): 1e-10 relative in
  float64, the same arithmetic on the same draws (the reductions sum in
  another order, ~1e-15);
- a ``torch.Generator``'s own jump paths (Philox Poisson and gamma draws):
  the compensated discounted spot is a martingale within 4 s.e.
Sizes: 4096 paths x 16 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_key_draws import JaxKey

from pde_tpu.models import bates as jbates
from pde_tpu.models import svcj as jsvcj
from pde_tpu_torch.models import bates as tbates
from pde_tpu_torch.models import svcj as tsvcj

F64 = torch.float64
S0 = torch.tensor(100.0, dtype=F64)
KEY = jax.random.PRNGKey(5)
KW = dict(n_steps=16, n_paths=4096, rate=0.05, dividend=0.02)
MODELS = {
    "bates": (jbates, tbates, jbates.BatesParams, tbates.BatesParams,
              (2.0, 0.04, 0.3, -0.7, 0.04, 0.6, -0.08, 0.18)),
    "svcj": (jsvcj, tsvcj, jsvcj.SVCJParams, tsvcj.SVCJParams,
             (2.0, 0.04, 0.3, -0.7, 0.04, 0.8, -0.05, 0.1, 0.05, -0.5)),
}
CALLS = {
    "simulate_qe": lambda m, p, k, s: m.simulate_qe(p, s, 1.0, k, **KW),
    "simulate_qe_no_antithetic": lambda m, p, k, s: m.simulate_qe(
        p, s, 1.0, k, antithetic=False, martingale_correction=False, **KW),
    "simulate_qe_paths": lambda m, p, k, s: m.simulate_qe_paths(p, s, 1.0, k, **KW),
    "price_european_mc": lambda m, p, k, s: m.price_european_mc(
        p, [90.0, 100.0, 110.0], 1.0, s, k, **KW),
    "price_path_payoff_mc": lambda m, p, k, s: m.price_path_payoff_mc(
        p, lambda paths: paths.s_max - paths.s_avg, s, 1.0, k, **KW),
    "price_american_mc": lambda m, p, k, s: m.price_american_mc(p, 100.0, 1.0, s, k, **KW),
}


def _cases():
    return [(model, call) for model in MODELS for call in CALLS] + [("svcj", "simulate_qe_qv")]


@pytest.mark.parametrize("model,call", _cases())
def test_matches_reference(model, call):
    jm, tm, JP, TP, fields = MODELS[model]
    fn = CALLS.get(call) or (lambda m, p, k, s: m.simulate_qe_qv(p, s, 1.0, k, **KW))
    want = fn(jm, JP(*fields), KEY, 100.0)
    got = fn(tm, TP(*fields), JaxKey(KEY), S0)
    pairs = [(g, w) for g, w in zip(got, want) if w is not None]
    assert pairs and all(g is None for g, w in zip(got, want) if w is None)
    for g, w in pairs:
        assert g.shape == jnp.shape(w) and g.dtype == F64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=0.0)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_generator_jump_paths_are_a_martingale(model):
    _, tm, _, TP, fields = MODELS[model]
    paths = tm.simulate_qe(TP(*fields), S0, 1.0, torch.Generator().manual_seed(2), **KW)
    x = np.exp(-(0.05 - 0.02)) * paths.spot.numpy()
    se = x.std() / np.sqrt(x.size)
    assert abs(x.mean() - 100.0) < 4 * se
    assert (paths.variance.numpy() >= 0).all()

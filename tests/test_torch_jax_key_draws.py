"""The test-side draw source ``tests/jax_key_draws.py``: what the port's
multi-rank pricers are fed.

``JaxKey(key).fold_in(i)`` answers with the draws of
``jax.random.fold_in(key, i)`` (the key of the reference's device i), and
``recorded`` keeps a simulation's draws as a replay that pickles without
any JAX object, so a spawned rank that never imports JAX replays them: the
QE paths on the unpickled replay equal the paths on the live key
bit for bit, and a draw the replay did not record raises.
"""

import pickle

import jax
import numpy as np
import pytest
import torch
from jax_key_draws import JaxKey, recorded

from pde_tpu_torch.models import heston_mc
from pde_tpu_torch.models.heston import HestonParams

F64 = torch.float64
TP = HestonParams(*(torch.tensor(v, dtype=F64) for v in (2.0, 0.04, 0.3, -0.7, 0.04)))


def test_fold_in_is_jax_s():
    key = jax.random.PRNGKey(5)
    for i in range(3):
        got = JaxKey(key).fold_in(i).normal((4,), F64, "cpu")
        want = np.asarray(jax.random.normal(jax.random.fold_in(key, i), (4,), jax.numpy.float64))
        np.testing.assert_array_equal(got.numpy(), want)


def _paths(source):
    return heston_mc.simulate_qe(TP, 100.0, 1.0, source, n_steps=4, n_paths=64, rate=0.05,
                                 device="cpu")


def test_recorded_replay_pickles_without_jax_and_replays_the_draws():
    key = JaxKey(jax.random.PRNGKey(9)).fold_in(1)
    replay = pickle.loads(pickle.dumps(recorded(key, _paths)))
    blob = pickle.dumps(replay)
    assert b"jax" not in blob
    np.testing.assert_array_equal(_paths(replay).spot.numpy(), _paths(key).spot.numpy())
    # a draw it did not record: the replay holds no source to draw from
    with pytest.raises(AttributeError):
        replay.split(4)[0].split(2)[0].split(2)

"""``pde_tpu_torch/parallel/mc.py`` on gloo ranks, held against
``pde_tpu.parallel.mc`` (x64) on a P-device mesh, on the reference's own
per-device draws.

The reference's device i draws from ``fold_in(key, i)``.  Here rank i is
given a replay of that key (``jax_key_draws.JaxKey(key).fold_in(i)``),
recorded in this process by running the port's simulation of the rank's
paths once (``jax_key_draws.recorded``): a tree of torch tensors that
pickles to the spawned rank, which never imports JAX.  (Recording here
costs the parent one simulation a rank at these sizes; a rank that drew
from JAX itself would pay JAX's import and its per-shape compiles in every
spawned process.)  The five pricers then run the same arithmetic on the
same draws as the reference's shard_map programs, and their outputs are
held at 1e-10 relative: the European and American prices and standard
errors, the SLV leverage rows and validation prices, the Hull-White and
G2++ Bermudan LSM values, and the netted CVA with its EE profile.  The
divisibility errors are the reference's own messages, and an unknown
parameter type raises ``TypeError`` as it does.  On an int seed (each rank
its own generator) the sharded European agrees with the single-device
pricer within 4 s.e., the Hull-White and G2++ Bermudans give a finite
price within 4 s.e. of their replayed one, and every rank returns the
same numbers.  One spawn of four ranks runs every case; P = 2 runs on the
two columns of a (2, 2) mesh.  Sizes: 2048 paths, 8 steps, four Bermudan exercise dates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_workers as W
from jax_key_draws import JaxKey, recorded

from pde_tpu.models import credit as jc
from pde_tpu.models import g2 as jg2
from pde_tpu.models import rates as jr
from pde_tpu.models.heston import HestonParams as JParams
from pde_tpu.parallel import mc as jmc
from pde_tpu.parallel import mesh as jmesh
from pde_tpu_torch import interop
from pde_tpu_torch.models import heston_mc, slv
from pde_tpu_torch.solvers import bermudan_g2 as tbg2
from pde_tpu_torch.solvers import bermudan_hw as tbhw

WORLD, PS = 4, (2, 4)
F64 = torch.float64
JP = JParams(2.0, 0.04, 0.3, -0.7, 0.04)
TP = interop.heston_params(JP)
N, STEPS = 2048, 8
HESTON_KW = dict(rate=0.05, n_steps=STEPS, n_paths=N)
SLV_KW = dict(rate=0.03, dividend=0.01, n_steps=STEPS, n_paths=N, n_bins=15)
SLV_STRIKES = [90.0, 100.0, 110.0]
KEYS = {"european": 11, "american": 12, "slv": 13, "hw": 14, "g2": 15, "cva": 16}


def _jax_vol(s, t):
    return 0.18 + 0.05 * (s / 100.0 - 1.0) ** 2 + 0.0 * t


@pytest.fixture(scope="module")
def desk():
    curve = jr.curve_from_zero_rates(jnp.array([1.0, 5.0, 10.0]),
                                     jnp.array([0.03, 0.04, 0.042]))
    hw = jr.HullWhiteParams(jnp.asarray(0.1), jnp.asarray(0.012), curve)
    g2p = jg2.G2Params(jnp.asarray(0.5), jnp.asarray(0.1), jnp.asarray(0.008),
                       jnp.asarray(0.006), jnp.asarray(-0.6), curve)
    sched = jnp.arange(1.0, 3.01, 0.5)  # four exercise dates: short compiles
    K = jr.hw_swap_rate(curve, 1.0, sched[1:])
    cva_sched = jnp.arange(0.5, 3.01, 0.5)
    trades = [jc.SwapTrade(jr.hw_swap_rate(curve, 0.5, cva_sched[1:]) * f,
                           jnp.asarray(s), jnp.asarray(n))
              for f, s, n in ((1.0, 1.0, 1.0), (1.1, -1.0, 0.5))]
    return dict(hw=hw, g2=g2p, sched=sched, K=K, cva_sched=cva_sched, trades=trades,
                hazard=jc.flat_hazard(0.02))


def _port_args(name, d):
    """The port's positional arguments of each pricer (before key, mesh)."""
    tw = lambda a: interop.tensor(np.asarray(a))  # noqa: E731
    return {
        "european": (TP, 100.0, 1.0, 100.0),
        "american": (TP, 100.0, 1.0, 100.0),
        "slv": (TP, W.skew_vol, 100.0, 0.75),
        "hw": (interop.hull_white_params(d["hw"]), tw(d["K"]), tw(d["sched"])),
        "g2": (interop.g2_params(d["g2"]), tw(d["K"]), tw(d["sched"])),
        "cva": (interop.hull_white_params(d["hw"]), interop.hazard_curve(d["hazard"]),
                [interop.swap_trade(t) for t in d["trades"]], tw(d["cva_sched"])),
    }[name]


FN = {"european": "price_european_mc_sharded", "american": "price_american_lsm_sharded",
      "slv": "calibrate_leverage_sharded", "hw": "bermudan_swaption_lsm_sharded",
      "g2": "bermudan_swaption_lsm_sharded", "cva": "cva_netting_sharded"}
KW = {"european": HESTON_KW, "american": dict(HESTON_KW, is_call=False),
      "slv": dict(SLV_KW, strikes=SLV_STRIKES), "hw": dict(n_paths=N), "g2": dict(n_paths=N),
      "cva": dict(n_paths=N)}


def _simulation(name, d, n_local):
    """The draws rank i's share of each pricer makes, as the port's own
    simulation of its ``n_local`` paths: run once on a replay to record
    them."""
    args = _port_args(name, d)
    if name == "european":
        return lambda rep: heston_mc.simulate_qe(TP, 100.0, 1.0, rep, n_steps=STEPS,
                                                 n_paths=n_local, rate=0.05, device="cpu")
    if name == "american":
        return lambda rep: heston_mc.simulate_qe_paths(TP, 100.0, 1.0, rep, n_steps=STEPS,
                                                       n_paths=n_local, rate=0.05, device="cpu")
    if name == "slv":
        return lambda rep: slv.calibrate_leverage(
            TP, W.skew_vol, 100.0, 0.75, rep, n_steps=STEPS, n_paths=n_local, n_bins=15,
            rate=0.03, dividend=0.01, device="cpu")
    if name in ("hw", "cva"):
        sched = args[2] if name == "hw" else args[3]
        m = sched.shape[0] - 1
        return lambda rep: tbhw._simulate_events(args[0], sched, tuple(range(m)), n_local,
                                                 rep, F64)
    steps = tbg2._event_steps(args[0], args[2], tuple(range(args[2].shape[0] - 1)), F64)
    return lambda rep: tbg2._simulate_events(steps, n_local, rep, F64, torch.device("cpu"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, desk):
    cases = []
    for P in PS:
        for name in FN:
            sources = [recorded(JaxKey(jax.random.PRNGKey(KEYS[name])).fold_in(i),
                                _simulation(name, desk, N // P)) for i in range(P)]
            cases.append((f"{name}_{P}", W.case_mc,
                          (P, FN[name], (*_port_args(name, desk), sources), KW[name])))
        cases += [
            (f"seeded_{P}", W.case_mc, (P, FN["european"], (TP, 100.0, 1.0, 100.0, 7),
                                        dict(HESTON_KW, n_paths=1 << 14))),
            (f"indivisible_{P}", W.case_mc, (P, FN["european"], (TP, 100.0, 1.0, 100.0, 7),
                                             dict(HESTON_KW, n_paths=1026))),
            (f"odd_{P}", W.case_mc, (P, FN["american"], (TP, 100.0, 1.0, 100.0, 7),
                                     dict(HESTON_KW, n_paths=P * 3))),
            (f"cva_indivisible_{P}", W.case_mc,
             (P, FN["cva"], (*_port_args("cva", desk), 7), dict(n_paths=P * 100 + 3))),
            (f"unknown_params_{P}", W.case_mc,
             (P, FN["hw"], (object(), *_port_args("hw", desk)[1:], 7), dict(n_paths=P * 64))),
        ]
        cases += [(f"seeded_{name}_{P}", W.case_mc,
                   (P, FN[name], (*_port_args(name, desk), 7), KW[name]))
                  for name in ("hw", "g2")]
    return W.run_ranks(WORLD, cases, tmp_path_factory.mktemp("ranks"))


def _jax_run(name, d, P):
    mesh = jmesh.make_mesh(P, axis_names=("paths",), shape=(P,))
    key = jax.random.PRNGKey(KEYS[name])
    if name == "european":
        return jmc.price_european_mc_sharded(JP, 100.0, 1.0, 100.0, key, mesh, **HESTON_KW)
    if name == "american":
        return jmc.price_american_lsm_sharded(JP, 100.0, 1.0, 100.0, key, mesh, is_call=False,
                                              **HESTON_KW)
    if name == "slv":
        lev, price, se = jmc.calibrate_leverage_sharded(
            JP, _jax_vol, 100.0, 0.75, key, mesh, strikes=jnp.asarray(SLV_STRIKES), **SLV_KW)
        return dict(values=lev.values, centers=lev.ln_s_centers, times=lev.times, price=price,
                    se=se)
    if name in ("hw", "g2"):
        return jmc.bermudan_swaption_lsm_sharded(d[name], d["K"], d["sched"], key, mesh,
                                                 n_paths=N)
    return jmc.cva_netting_sharded(d["hw"], d["hazard"], d["trades"], d["cva_sched"], key,
                                   mesh, n_paths=N)


def _out(ranks, name):
    return W.same_on_every_rank(W.outputs(ranks, name))


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("name", list(FN))
def test_sharded_pricer_equals_the_reference_on_its_draws(ranks, desk, name, P):
    got, want = _out(ranks, f"{name}_{P}"), _jax_run(name, desk, P)
    if isinstance(want, dict):
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-10, atol=1e-14)
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("P", PS)
def test_seeded_ranks_agree_with_one_device(ranks, P):
    price, se = _out(ranks, f"seeded_{P}")
    one, se1 = heston_mc.price_european_mc(
        TP, 100.0, 1.0, torch.tensor(100.0, dtype=F64),
        torch.Generator().manual_seed(3), **dict(HESTON_KW, n_paths=1 << 14))
    assert abs(float(price) - float(one)) < 4.0 * (float(se) + float(se1))


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("name", ["hw", "g2"])
def test_seeded_bermudans_agree_across_ranks(ranks, name, P):
    """On an int seed (each rank a ``torch.Generator`` of its own) both
    Bermudan branches run, every rank returns the same finite price, and it
    lies within 4 s.e. of the same estimator on the reference's draws."""
    price, se = (float(v) for v in _out(ranks, f"seeded_{name}_{P}"))
    ref, ref_se = (float(v) for v in _out(ranks, f"{name}_{P}"))
    assert np.isfinite(price) and np.isfinite(se) and se > 0.0
    assert abs(price - ref) < 4.0 * (se * se + ref_se * ref_se) ** 0.5


@pytest.mark.parametrize("P", PS)
def test_divisibility_errors_are_the_reference_s(ranks, desk, P):
    mesh = jmesh.make_mesh(P, axis_names=("paths",), shape=(P,))
    key = jax.random.PRNGKey(0)
    for case, call in (
            ("indivisible", lambda: jmc.price_european_mc_sharded(
                JP, 100.0, 1.0, 100.0, key, mesh, **dict(HESTON_KW, n_paths=1026))),
            ("odd", lambda: jmc.price_american_lsm_sharded(
                JP, 100.0, 1.0, 100.0, key, mesh, **dict(HESTON_KW, n_paths=P * 3))),
            ("cva_indivisible", lambda: jmc.cva_netting_sharded(
                desk["hw"], desk["hazard"], desk["trades"], desk["cva_sched"], key, mesh,
                n_paths=P * 100 + 3))):
        with pytest.raises(ValueError) as exc:
            call()
        assert _out(ranks, f"{case}_{P}") == f"ValueError: {exc.value}"


@pytest.mark.parametrize("P", PS)
def test_unknown_parameters_raise_type_error(ranks, P):
    assert _out(ranks, f"unknown_params_{P}").startswith(
        "TypeError: params must be HullWhiteParams or G2Params")


def test_a_replay_for_each_rank_is_checked():
    from pde_tpu_torch.parallel.mc import _rank_source

    class Mesh:
        mesh_dim_names = ("paths",)

        def size(self, i):
            return 2

        def get_local_rank(self, axis):
            return 1

    assert _rank_source(["a", "b"], Mesh(), "paths", "cpu") == "b"
    with pytest.raises(ValueError, match="3 draw sources for 2 ranks"):
        _rank_source(["a", "b", "c"], Mesh(), "paths", "cpu")
    with pytest.raises(TypeError, match="int seed"):
        _rank_source(torch.Generator(), Mesh(), "paths", "cpu")
    a = _rank_source(5, Mesh(), "paths", "cpu").initial_seed()
    assert a == _rank_source(5, Mesh(), "paths", "cpu").initial_seed()

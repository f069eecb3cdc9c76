"""Every generator gives the same inputs for the same seed, other inputs
for another, and the same shapes for every seed."""

import json

import numpy as np
import pytest
import torch
from conftest import ROOT

from perfbench import dupire, generate

MIXES = sorted(p.stem for p in (ROOT / "perfbench/traffic").glob("*.json"))
SEEDS = (0, 7, 2**31 + 12345, 2**40 + 3)


def small(spec):
    spec = dict(spec)
    if spec["layout"] == "grid":
        spec["underlyings"] = 3
    else:
        spec["options"] = 10
    return spec


@pytest.mark.parametrize("mix", MIXES)
def test_books_repeat_for_their_seed(mix):
    spec = small(json.loads((ROOT / f"perfbench/traffic/{mix}.json").read_text())["book"])
    for seed in SEEDS:
        a, b = generate.pool(spec, 2, seed, "cpu"), generate.pool(spec, 2, seed, "cpu")
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                assert torch.equal(x[k], y[k])
                assert x[k].shape == (generate.book_size(spec),)
                assert x[k].dtype == torch.float32 and torch.isfinite(x[k]).all()
    one, other = generate.pool(spec, 1, 1, "cpu")[0], generate.pool(spec, 1, 2, "cpu")[0]
    assert not torch.equal(one["K"], other["K"])


@pytest.mark.parametrize("mix", MIXES)
def test_books_lie_in_their_ranges(mix):
    spec = small(json.loads((ROOT / f"perfbench/traffic/{mix}.json").read_text())["book"])
    b = generate.pool(spec, 1, 99, "cpu")[0]
    assert set(b["is_call"].tolist()) == {0.0, 1.0}
    assert b["is_call"].mean() == pytest.approx(0.5, abs=0.1)
    if spec["layout"] == "grid":
        m = (b["K"] / b["S0"]).numpy()
        lo, hi = spec["moneyness"]["range"]
        assert m.min() == pytest.approx(lo, rel=1e-5) and m.max() == pytest.approx(hi, rel=1e-5)
        for k, (lo, hi) in spec["heston"].items():
            assert lo <= b[k].min() and b[k].max() <= hi
        assert len(set(b["T"].tolist())) == spec["maturity"]["n"]
    else:
        assert spec["strike"][0] <= b["K"].min() and b["K"].max() <= spec["strike"][1]
        assert spec["maturity"][0] <= b["T"].min() and b["T"].max() <= spec["maturity"][1]


def test_pool_books_differ():
    spec = small(json.loads((ROOT / "perfbench/traffic/cn_book.json").read_text())["book"])
    a, b = generate.pool(spec, 2, 5, "cpu")
    assert not torch.equal(a["K"], b["K"])


def test_dupire_surface_is_fixed_and_bounded():
    cfg = json.loads((ROOT / "perfbench/configs/dupire_lv.json").read_text())
    s = cfg["surface"]
    ks = np.exp(np.linspace(np.log(s["strike_range"][0]), np.log(s["strike_range"][1]),
                            s["n_strikes"]))
    ts = np.linspace(*s["maturity_range"], s["n_maturities"])
    args = (cfg["heston"], ks, ts, s["spot"], cfg["r"], cfg["q"], "cpu")
    a, b = dupire.local_vol_surface(*args), dupire.local_vol_surface(*args)
    assert torch.equal(a, b) and a.shape == (len(ts), len(ks))
    assert float(a.min()) >= 0.01 and float(a.max()) <= 4.0
    # near the money the Heston smile's local vol sits near sqrt(v0) = 0.2
    atm = a[:, np.argmin(np.abs(ks - s["spot"]))]
    assert ((atm > 0.1) & (atm < 0.3)).all()

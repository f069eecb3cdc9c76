"""A whole run on the CPU (the look for a card skipped) with the timed
path broken underneath: ``correct`` comes out false for each fault the
cells can have.  A one-chip pricing cell has no exchange between chips,
and the Fourier pricer no step to leave unchanged."""

import pytest
import torch

from pde_tpu_torch.models import heston
from pde_tpu_torch.solvers import heston_adi, local_vol_pde

SOLVERS = {"heston_sv.adi_book": (heston_adi, "solve_fused_batch"),
           "dupire_lv.cn_book": (local_vol_pde, "solve_fused_batch"),
           "heston_sv.cf_universe": (heston, "price_carr_madan_gl")}


def half_left_out(fn):
    """Only the first half of the book is priced; the rest reads zero."""
    def wrapped(*args, **kwargs):
        res = fn(*args, **kwargs)
        if isinstance(res, torch.Tensor):
            res = res.clone()
            res[res.shape[0] // 2:] = 0.0
            return res
        out = res._asdict()
        for k in ("price", "delta", "gamma", "vega", "theta"):
            if k in out:
                out[k] = out[k].clone()
                out[k][out[k].shape[0] // 2:] = 0.0
        return type(res)(**out)
    return wrapped


def one_answer_altered(fn):
    """The book's first price moves by 5% of its strike."""
    def wrapped(*args, **kwargs):
        res = fn(*args, **kwargs)
        if isinstance(res, torch.Tensor):
            res = res.clone()
            res[0] += 0.05 * args[1][0]
            return res
        price = res.price.clone()
        price[0] += 0.05 * kwargs.get("K", args[8] if len(args) > 8 else None)[0]
        return res._replace(price=price)
    return wrapped


@pytest.mark.parametrize("cell", sorted(SOLVERS))
def test_a_sound_run_is_correct(tiny_root, run_cell, cell):
    rc, res = run_cell(tiny_root, cell)
    assert rc == 0 and res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("fault", [half_left_out, one_answer_altered])
@pytest.mark.parametrize("cell", sorted(SOLVERS))
def test_a_broken_answer_is_not_correct(tiny_root, run_cell, monkeypatch, cell, fault):
    module, name = SOLVERS[cell]
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    rc, res = run_cell(tiny_root, cell)
    assert rc == 0 and res["correct"] is False


@pytest.mark.parametrize("cell", sorted(SOLVERS))
def test_the_control_in_the_program_s_place_is_not_correct(tiny_root, run_cell, monkeypatch,
                                                           cell):
    """The plain reference computed in bfloat16 prices the window's books."""
    from perfbench import manifest
    man = manifest.Manifest(tiny_root)
    entry = man.entry(man.traffic(man.cell(cell).traffic)["entry"])
    monkeypatch.setattr(entry.Cell, "price", lambda self, b: self.reference(b, torch.bfloat16))
    rc, res = run_cell(tiny_root, cell)
    assert rc == 0 and res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_a_march_that_leaves_its_state_unchanged_is_not_correct(tiny_root, run_cell,
                                                                monkeypatch):
    """K1's march returns the terminal condition it was given."""
    def unchanged(pay, sg, a1, i1, a2, i2, mix, sc, n_spot, n_vol, n_time, **_):
        return pay.expand(n_spot, n_vol, pay.shape[-1]).clone()
    monkeypatch.setattr(heston_adi, "fused_douglas_march_batched", unchanged)
    rc, res = run_cell(tiny_root, "heston_sv.adi_book")
    assert rc == 0 and res["correct"] is False


def test_a_cn_march_that_leaves_its_state_unchanged_is_not_correct(tiny_root, run_cell,
                                                                   monkeypatch):
    """K3's march returns the payoff it was given."""
    monkeypatch.setattr(local_vol_pde, "fused_cn_march_1d_tv",
                        lambda pay, bands, sc, **_: pay.clone())
    rc, res = run_cell(tiny_root, "dupire_lv.cn_book")
    assert rc == 0 and res["correct"] is False


def test_a_call_that_raises_in_the_window_is_not_correct(tiny_root, run_cell, monkeypatch):
    """The warm-up's calls (one a book of the pool, two here) succeed; every
    later call raises."""
    fn, seen = heston.price_carr_madan_gl, []

    def broken(*args, **kwargs):
        seen.append(1)
        if len(seen) > 2:
            raise RuntimeError("launch failed")
        return fn(*args, **kwargs)
    monkeypatch.setattr(heston, "price_carr_madan_gl", broken)
    rc, res = run_cell(tiny_root, "heston_sv.cf_universe")
    assert rc == 0 and res["correct"] is False and res["failed"] == res["attempted"] > 0


def test_a_set_up_that_raises_prints_no_result(tiny_root, run_cell, monkeypatch, capsys):
    def broken(*args, **kwargs):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(heston, "price_carr_madan_gl", broken)
    with pytest.raises(RuntimeError):
        run_cell(tiny_root, "heston_sv.cf_universe")
    assert capsys.readouterr().out == ""

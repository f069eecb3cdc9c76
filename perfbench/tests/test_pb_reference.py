"""The plain references against ``pde_tpu_torch`` at tiny sizes on the
CPU (the port's plain twins of its kernels run there), and the control:
the reference computed in bfloat16 in the program's place fails."""

import pytest

from perfbench import check, manifest

CELLS = ["heston_sv.adi_book", "dupire_lv.cn_book", "heston_sv.cf_universe"]


def build(root, cell, seed):
    man = manifest.Manifest(root)
    c = man.cell(cell)
    traffic = man.traffic(c.traffic)
    return man.entry(traffic["entry"]).build(man.config(c.config), traffic, seed, "cpu"), \
        man.limits(cell)


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_the_reference(tiny_root, cell):
    sut, limits = build(tiny_root, cell, 3)
    outs = {k: sut.call(k) for k in range(len(sut.pool))}
    numbers = sut.numbers(outs)
    assert set(numbers) == set(limits)
    # float32 against float64: far inside every limit
    for name, value in numbers.items():
        assert value <= limits[name] / 20, (name, value)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(tiny_root, cell):
    sut, limits = build(tiny_root, cell, 4)
    numbers = sut.control(range(len(sut.pool)))
    assert not check.judge(numbers, limits), numbers


def test_gaps_take_the_nearer_node_of_a_tie():
    import torch
    K = torch.tensor([100.0, 100.0])
    out = {"delta": torch.tensor([0.5, 0.7])}
    ref = {"delta": torch.tensor([0.5, 0.5], dtype=torch.float64),
           "alt_delta": torch.tensor([0.5, 0.7], dtype=torch.float64)}
    assert check.gaps(out, ref, K, ["delta"]) == {"delta": pytest.approx(0.0, abs=1e-7)}
    out = {"price": torch.tensor([float("nan"), 1.0])}
    ref = {"price": torch.tensor([1.0, 1.0], dtype=torch.float64)}
    assert check.gaps(out, ref, K, ["price"]) == {"price": float("inf")}

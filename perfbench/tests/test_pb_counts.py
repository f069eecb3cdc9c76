"""The kernels' operation and byte counts at the cells' shapes, against
values worked by hand, and their bounds on the H100's peaks."""

import pytest

from perfbench.counts import k1, k3
from perfbench.peaks import bound_s


def test_k1_at_the_adi_book():
    s = {"B": 4096, "nS": 100, "nv": 50, "nT": 100}
    # 4096 x 100 x 50 = 20,480,000 nodes; 32 a node and step over 100 steps,
    # 3 a node to factor the S systems
    assert k1.flops(s) == 65_536_000_000 + 61_440_000
    # 9 numbers an option in, the grid out, 4 bytes each
    assert k1.bytes_moved(s) == 4 * (9 * 4096 + 20_480_000) == 82_067_456
    t, binds = bound_s(k1.flops(s), k1.bytes_moved(s))
    assert binds == "flops" and t == pytest.approx(65_597_440_000 / 67e12)
    assert t == pytest.approx(0.979066e-3, rel=1e-6)


def test_k3_at_the_cn_book():
    s = {"B": 4096, "n": 200, "nT": 100}
    # 20 a node and step; 8 a node and level for the bands of 101 levels
    assert k3.flops(s) == 20 * 4096 * 200 * 100 + 8 * 4096 * 200 * 101 == 2_300_313_600
    # the vol lattice (101 levels x 200 nodes), T, K and the flag, V out
    assert k3.bytes_moved(s) == 4 * (101 * 200 * 4096 + 3 * 4096 + 200 * 4096) == 334_282_752
    t, binds = bound_s(k3.flops(s), k3.bytes_moved(s))
    assert binds == "bytes" and t == pytest.approx(99.7859e-6, rel=1e-5)


def test_counts_scale_with_the_book():
    s = {"B": 1, "nS": 100, "nv": 50, "nT": 100}
    assert k1.flops(dict(s, B=8)) == 8 * k1.flops(s)
    s = {"B": 1, "n": 200, "nT": 100}
    assert k3.bytes_moved(dict(s, B=8)) == 8 * k3.bytes_moved(s)

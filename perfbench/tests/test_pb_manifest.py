"""BENCHMARK.json against the contract's shape, and every file it names
found by name; a cell, a mix and a metric added as new files alone."""

import json
import math
import re

import pytest
from conftest import ROOT, edit_json

from perfbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert 1 <= len(c["source"]) <= 200 and c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_bounds_and_run_length():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    # 24 cells' full check: 2 + 14 x cells runs of run_seconds + 60, 180 s a
    # cell to compile, 1200 s spare, inside 43200 s
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51 and (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, math.floor(0.25 * len(CELLS)))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    man = manifest.Manifest(ROOT)
    c = man.cell(cell)
    config, traffic = man.config(c.config), man.traffic(c.traffic)
    assert config["dtype"] == "float32" and config["reduced"] == []
    entry = man.entry(traffic["entry"])
    assert callable(entry.build)
    limits = man.limits(cell)
    assert limits and all(v > 0 for v in limits.values())
    e2e = man.metrics(cell, traced=False)
    layer = man.metrics(cell, traced=True)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in e2e + layer:
        assert callable(man.reader(m["name"]).read)
    for m in layer:
        assert m["moves"] in names


def test_layers_spelled_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
        assert "\n" not in m["layer"] and "\t" not in m["layer"]
    roofs = [m for m in BENCH["per_layer"] if m["name"].endswith("_roofline")]
    assert roofs and all(m["unit"] == "%" and m["layer"] == "kernels" for m in roofs)


def test_a_cell_mix_and_metric_added_as_new_files(tiny_root, run_cell):
    """A new mix (data only), a new metric (one reader file) and a new cell
    (entries in BENCHMARK.json and its limits file) run with no file of the
    harness edited."""
    pb = tiny_root / "perfbench"
    mix = json.loads((pb / "traffic/adi_book.json").read_text())
    mix["book"]["moneyness"] = {"n": 4, "range": [0.9, 1.1]}
    (pb / "traffic/adi_short.json").write_text(json.dumps(mix))
    (pb / "limits/heston_sv.adi_short.json").write_text(
        (pb / "limits/heston_sv.adi_book.json").read_text())
    (pb / "metrics/calls_in_window.py").write_text(
        "def read(run):\n    return run.work_done / run.work_per_call\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "heston_sv.adi_short", "config": "heston_sv",
                               "traffic": "adi_short", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("heston_sv.adi_short")
    bench["end_to_end"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["heston_sv.adi_short"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res = run_cell(tiny_root, "heston_sv.adi_short")
    assert rc == 0 and res["correct"]
    assert set(res["metrics"]) == {"options_per_s", "book_p95_ms", "setup_s", "calls_in_window"}
    calls = res["metrics"]["calls_in_window"]["value"]
    assert res["attempted"] == calls * 2 * 4 * 8


def test_unknown_cell_raises(tiny_root):
    with pytest.raises(KeyError):
        manifest.Manifest(tiny_root).cell("no_such.cell")


def test_edit_json_merges_one_level(tmp_path):
    p = tmp_path / "x.json"
    p.write_text(json.dumps({"a": {"b": 1, "c": 2}, "d": 3}))
    edit_json(p, {"a": {"b": 5}, "d": 4})
    assert json.loads(p.read_text()) == {"a": {"b": 5, "c": 2}, "d": 4}

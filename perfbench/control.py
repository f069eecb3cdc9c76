#!/usr/bin/env python3
"""Readings that the limits of a cell are set from, in one process.

    python3 perfbench/control.py --workload <cell> --seeds <n>... --control-seeds <n>...

For each of ``--seeds`` it makes the cell's pool, runs a short window at
the cell's own load (``--seconds``) through the harness's timed call, and
compares the books drawn from the seed with the float64 reference, as a
run does: the program's readings.  For each of ``--control-seeds`` it puts
the reference computed in bfloat16 in the program's place on the same
books: the control's readings.  It prints one JSON line a seed, each
number beside the cell's limit and ``correct`` as a run judges it (a
control has to come out false), then the summary: for each number the
largest reading of the program (``lower``), the smallest of the control
(``upper``) and the limit.  Without a card it exits with code 2, as a
run does.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

from perfbench import check, manifest, run  # noqa: E402


def beside(numbers: dict, limits: dict) -> dict:
    return {n: {"value": v, "limit": limits.get(n)} for n, v in numbers.items()}


def readings(man, cell_name, seeds, control_seeds, seconds, device):
    import torch

    cell = man.cell(cell_name)
    config, traffic = man.config(cell.config), man.traffic(cell.traffic)
    entry = man.entry(traffic["entry"])
    limits = man.limits(cell_name)
    program, control = [], []
    for seed in seeds:
        t0 = time.perf_counter()
        sut = entry.build(config, traffic, seed, device)
        sut.warm()
        win = run.measure(sut, seconds)
        numbers = sut.check(win.kept)
        program.append(numbers)
        print(json.dumps({"side": "program", "seed": seed, "calls": win.calls,
                          "failed": win.failed, "correct": win.failed == 0
                          and check.judge(numbers, limits), "numbers": beside(numbers, limits),
                          "seconds": time.perf_counter() - t0}), flush=True)
        del sut, win
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for seed in control_seeds:
        t0 = time.perf_counter()
        sut = entry.build(config, traffic, seed, device)
        picks = check.sample(list(range(len(sut.pool))), traffic["check_books"], seed)
        numbers = sut.control(picks)
        control.append(numbers)
        print(json.dumps({"side": "control", "seed": seed,
                          "correct": check.judge(numbers, limits),
                          "numbers": beside(numbers, limits),
                          "seconds": time.perf_counter() - t0}), flush=True)
        del sut
        if device.type == "cuda":
            torch.cuda.empty_cache()
    names = (program or control)[0].keys()
    summary = {n: {"lower": max((p[n] for p in program), default=None),
                   "upper": min((c[n] for c in control), default=None),
                   "limit": limits.get(n)} for n in names}
    return program, control, summary


def main(argv=None, *, root=ROOT, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("perfbench: no CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    _, _, summary = readings(manifest.Manifest(root), args.workload, args.seeds,
                             args.control_seeds, args.seconds, torch.device(device))
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

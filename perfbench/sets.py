#!/usr/bin/env python3
"""Two sets of runs of one cell, for its bounds: each run a process of its
own, as the check makes them, the same seeds in both sets.

    python3 perfbench/sets.py --workload <cell> --seconds <s> --seeds <n>... [--out DIR]

Each run's standard output and error go to ``DIR/<cell>.<set>.<seed>.out``
and ``.err`` (``DIR`` defaults to ``build/perfbench-sets``).  The last line
printed is the summary: for each end-to-end metric and set, the median and
the spread (the distance between the quartiles, as
``statistics.quantiles(values, n=4)`` gives them, over the median), and
whether every run was correct.  A bound is about five times
the wider set's spread, and never under 1%.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path[0] = str(ROOT)

from perfbench.stats import spread  # noqa: E402


def one_run(cell, seed, seconds, out_dir: Path, tag: str) -> dict | None:
    stem = out_dir / f"{cell}.{tag}.{seed}"
    with open(f"{stem}.out", "w") as out, open(f"{stem}.err", "w") as err:
        rc = subprocess.run([sys.executable, str(ROOT / "perfbench/run.py"), "--workload", cell,
                             "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
                            cwd=ROOT, stdout=out, stderr=err).returncode
    lines = Path(f"{stem}.out").read_text().strip().splitlines()
    return json.loads(lines[-1]) if rc == 0 and lines else None


def summary(sets: dict) -> dict:
    """Median and spread of each metric in each set, from result lines."""
    out = {}
    for tag, results in sets.items():
        for name in results[0]["metrics"]:
            values = [r["metrics"][name]["value"] for r in results]
            out.setdefault(name, {})[tag] = {"median": statistics.median(values),
                                             "spread": spread(values), "values": values}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", type=Path, default=ROOT / "build" / "perfbench-sets")
    args = p.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    sets = {}
    for tag in "AB":
        sets[tag] = []
        for seed in args.seeds:
            res = one_run(args.workload, seed, args.seconds, args.out, tag)
            if res is None:
                print(f"perfbench: {args.workload} seed {seed} gave no result", file=sys.stderr)
                return 1
            sets[tag].append(res)
            print(json.dumps({"set": tag, "seed": seed, "correct": res["correct"],
                              "metrics": {k: v["value"] for k, v in res["metrics"].items()}}),
                  flush=True)
    correct = all(r["correct"] for rs in sets.values() for r in rs)
    print(json.dumps({"workload": args.workload, "seconds": args.seconds, "correct": correct,
                      "summary": summary(sets)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up imports the port, makes the cell's pool of books on the card from
the seed and prices every book once (which builds or loads the kernels);
then the window prices the pool's books in turn, one call after another,
for ``--seconds``.  Once the window has closed the run reads the peak of
the card's memory, checks that neither JAX nor the JAX package was
loaded, and compares a sample of the window's books, drawn from the
seed, with the plain reference; the check on loaded modules is made
again just before the result is printed.  With ``--trace 1`` the window runs under
``torch.profiler`` and the result carries the per-layer metrics, read
from its trace, in place of the end-to-end ones.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
Without a card (or with fewer than the cell asks for) the run exits with
code 2 and prints no result; with a forbidden module loaded, code 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the bytecode of every module the run imports (torch, scipy, sympy, the
# port) is cached at a fixed path inside the checkout, so that only the
# checkout's first run compiles it: an installation whose own bytecode
# cannot be written there recompiles some 1,800 sources in every process
PYCACHE = ROOT / "build" / "pycache"
if __name__ == "__main__":
    sys.pycache_prefix = str(PYCACHE)
    sys.dont_write_bytecode = False
    # one process with few threads: the thread pools of OpenMP and the
    # BLAS libraries start with one thread each, as the run sets torch to
    for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(_var, "1")
# the script's own folder comes first on sys.path: put the checkout's root
# there instead, so the harness is the package ``perfbench``
if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import check, guard, manifest, trace  # noqa: E402

T_IMPORTED = (time.perf_counter(), time.process_time())


@dataclass
class Window:
    start: float
    end: float
    calls: int
    failed: int
    kept: dict
    starts: list
    ends: list

    @property
    def latencies_ms(self) -> list[float]:
        """Each call's time, from the call to its results on the host."""
        return [1e3 * (b - a) for a, b in zip(self.starts, self.ends)]

    def fifths(self) -> list[int]:
        """Calls that ended in each fifth of the window (the last fifth
        holds the call that closed it)."""
        span = self.end - self.start
        counts = [0] * 5
        for t in self.ends:
            counts[min(4, int(5 * (t - self.start) / span))] += 1
        return counts


@dataclass
class Run:
    """What a metric's reader sees."""
    setup_s: float
    window_s: float
    work_done: int
    work_per_call: int
    shapes: dict
    kernel: str | None
    trace: "trace.TraceView | None"
    latencies_ms: list = field(default_factory=list)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(sut, seconds: float) -> Window:
    """Price the pool's books in turn until ``seconds`` have passed; keep
    each book's last results.  A call that raises counts as failed."""
    from torch.profiler import record_function

    kept, calls, failed, starts, ends = {}, 0, 0, [], []
    with record_function(trace.WINDOW):
        start = time.perf_counter()
        while True:
            k = calls % len(sut.pool)
            starts.append(time.perf_counter())
            try:
                with record_function(trace.CALL):
                    kept[k] = sut.call(k)
            except Exception:  # the window runs on; the run is not correct
                if not failed:
                    traceback.print_exc()
                failed += 1
                kept.pop(k, None)
            calls += 1
            end = time.perf_counter()
            ends.append(end)
            if end - start >= seconds:
                break
    return Window(start, end, calls, failed, kept, starts, ends)


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=60, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def refuse_forbidden() -> bool:
    """Name on standard error any loaded module of JAX or the JAX package."""
    found = guard.forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
    return bool(found)


def main(argv=None, *, root=ROOT, device=None) -> int:
    """One run; returns the exit code.  ``device`` set (a test's CPU) skips
    the look for a card."""
    args = parse(argv)
    man = manifest.Manifest(root)
    cell = man.cell(args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"perfbench: {cell.name} needs {cell.chips} CUDA card(s); found {n}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.init()
    torch.set_num_threads(1)
    t_card = (time.perf_counter(), time.process_time())

    config, traffic = man.config(cell.config), man.traffic(cell.traffic)
    limits = man.limits(cell.name)
    wanted = man.metrics(cell.name, traced=bool(args.trace))
    readers = {m["name"]: man.reader(m["name"]) for m in wanted}

    t_built = (time.perf_counter(), time.process_time())
    sut = man.entry(traffic["entry"]).build(config, traffic, args.seed, device)
    t_warm = (time.perf_counter(), time.process_time())
    sut.warm()
    if on_card:
        torch.cuda.synchronize(device)
    t_ready = (time.perf_counter(), time.process_time())
    setup_s = t_ready[0] - T_START
    print(f"perfbench: set-up {setup_s:.3f} s" + "".join(
        f", {name} {b[0] - a[0]:.3f} s ({b[1] - a[1]:.3f} s on the CPU)" for name, a, b in (
            ("imports", (T_START, 0.0), T_IMPORTED), ("the card", T_IMPORTED, t_card),
            ("reading the cell", t_card, t_built), ("port and inputs", t_built, t_warm),
            ("warm-up", t_warm, t_ready))), file=sys.stderr)

    if refuse_forbidden():
        return 3
    with trace.profiled(bool(args.trace)) as box:
        win = measure(sut, args.seconds)
    t_read = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if refuse_forbidden():
        return 3
    view = box[0] if box else None
    print(f"perfbench: window {win.end - win.start:.3f} s, {win.calls} calls, "
          f"{win.failed} failed; calls in each fifth {win.fifths()}", file=sys.stderr)

    if on_card:
        torch.cuda.empty_cache()
    numbers = sut.check(win.kept) if win.kept else {}
    correct = win.failed == 0 and bool(numbers) and check.judge(numbers, limits)

    run = Run(setup_s=setup_s, window_s=win.end - win.start,
              work_done=(win.calls - win.failed) * sut.work_per_call,
              work_per_call=sut.work_per_call, shapes=sut.shapes,
              kernel=sut.kernel, trace=view, latencies_ms=win.latencies_ms)
    metrics, notes = {}, {}
    t_metrics = time.perf_counter()
    for m in wanted:
        value = readers[m["name"]].read(run)
        if isinstance(value, dict):
            notes[m["name"]] = {k: v for k, v in value.items() if k != "value"}
            value = value["value"]
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if view is not None:
        print(f"perfbench: the trace read in {t_read - win.end:.1f} s, the metrics in "
              f"{time.perf_counter() - t_metrics:.1f} s", file=sys.stderr)

    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": cell.chips if on_card else 0, "memory_peak_bytes": peak,
           "power_limit_w": power_limit_w() if on_card else None}
    result = {"correct": correct, "attempted": win.calls * sut.work_per_call,
              "failed": win.failed * sut.work_per_call, "metrics": metrics, "device": dev}
    if view is not None:
        dev["busy_s"] = view.busy_us() * 1e-6
        dev["window_s"] = view.window_us * 1e-6
        result["breakdown"] = {"device_ops": view.top_device_ops(),
                               "idle_gaps": view.idle_gaps()}
    if notes:
        result["notes"] = notes
    result["checks"] = {name: {"value": v, "limit": limits.get(name)}
                        for name, v in numbers.items()}
    # what the reference and the metrics' readers loaded counts too
    if refuse_forbidden():
        return 3
    print(json.dumps(result), flush=True)
    for name, v in numbers.items():
        print(f"check {name} {v!r} limit {limits.get(name)!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

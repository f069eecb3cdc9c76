#!/usr/bin/env python3
"""K5's lane-group route built with and without FMA contraction, timed in
turns on one NVIDIA GPU.

``pde_tpu_torch/csrc/thomas_batched.cu`` is compiled twice with the flags of
``pde_tpu_torch/ops/build.py`` (``NVCC_FLAGS``), once with ``-fmad=false``
and once without, into ``build/pde_tpu_torch/fmad/``.  Both builds solve the
same seeded, diagonally dominant float32 systems at the shapes the port's
paths give K5 (the Heston scan's (50, 100) and (100, 50) sweeps, the
Black-Scholes projection's (1, 200)) and at the two bench shapes (512, 200)
and (51200, 50); each is held against the plain twin at the kernel gate
1e-5 + 1e-4 |plain|, and timed by the card's time alone (CUDA events around
200 launches behind a spin kernel) in the order with, without, without,
with.  One JSON line per shape, then the card's ``nvidia-smi`` name and
power limit.  Run from the repository root:

    python3 scripts/torch_k5_fmad.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def build(variant_flags, name):
    from pde_tpu_torch.ops import build as b

    out = b.BUILD_DIR / "fmad" / f"thomas_batched-{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([b._nvcc(), *b.NVCC_FLAGS, *variant_flags, "-o", str(out),
                           str(b.CSRC / "thomas_batched.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    fn = ctypes.CDLL(str(out)).pde_thomas_lanes
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def card_ms(torch, fn, reps=200):
    """Mean milliseconds of the card's time per launch (CUDA events, a spin
    kernel holding the stream while the host enqueues)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4 * reps * host_s * 2e9))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_k5_fmad: this script needs an NVIDIA GPU")
    from pde_tpu_torch.ops import tridiag

    libs = {"fmad_false": build(("-fmad=false",), "fmad_false"),
            "fmad_true": build((), "fmad_true")}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for B, n, shared in ((50, 100, False), (100, 50, True), (1, 200, True), (512, 200, False),
                         (51200, 50, True)):
        rows = 1 if shared else B
        rand = lambda m: torch.rand((rows, m), generator=gen, device=dev)  # noqa: E731
        system = (-rand(n - 1).expand(B, -1), (2.5 + rand(n)).expand(B, -1),
                  -rand(n - 1).expand(B, -1), torch.randn((B, n), generator=gen, device=dev))
        plain = tridiag._thomas_batched_plain(*system)
        g, ch, cp, n_bytes = tridiag._lane_plan(n)
        ops = [tridiag._batch_stride(a) for a in system]
        outs = {k: torch.empty((B, n), device=dev) for k in libs}

        def launch(key):
            err = libs[key](*(a.data_ptr() for a, _ in ops), outs[key].data_ptr(),
                            *(s for _, s in ops), B, n, g, ch, cp, n_bytes, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        ms = {k: [] for k in libs}
        for key in ("fmad_true", "fmad_false", "fmad_false", "fmad_true"):
            ms[key].append(card_ms(torch, lambda: launch(key)))
        over = {k: float(((outs[k] - plain).abs() / (1e-5 + 1e-4 * plain.abs())).max())
                for k in libs}
        print(json.dumps({"B": B, "n": n, "shared_bands": shared, "ms": ms,
                          "max_over_gate": over}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pde_tpu_torch``) on one NVIDIA GPU.

Drives the port's main paths once, at the sizes ``bench.py`` uses, and
checks every result:

1. device: the card's name and power limit;
2. build: every CUDA kernel of the paths, compiled from
   ``pde_tpu_torch/csrc`` (one ``nvcc`` per source, all started together),
   with each kernel's registers and spills, and the dynamic shared memory
   per block of the redesigned routes of K1 (Thomas and PCR sweeps), K2,
   K3, K4 and K5 at the bench shapes (K6's warp route has none);
3. kernel vs plain, each kernel against its plain PyTorch twin on the same
   inputs on the card, and both timed at the bench shape:
   - K1, the fused Douglas march (European, American projection, American
     Ikonen-Toivanen): its shared-memory route at 100x50 (B = 512, 130, 37
     and 1) and at 16x8 and 40x20 (B = 130, 37 and 1), its first design at
     100x50 (B = 512, 130 and 1) and on a grid too large for the other route
     (200x100, B = 37), each public call checked to have taken its route;
   - K1's PCR sweeps (European and Ikonen-Toivanen books): the S sweep on
     the shared-memory route (B = 512, 130, 37 and 1), the v sweep alone
     and with the S sweep on the shared-memory route (B = 512, 130, 37 and
     1 at 100x50, 40x20 and 16x8), each variant on the first design at
     100x50 (B = 512) and, through the public wrapper, on a grid too large
     for the other route (200x100, B = 37), each public call checked to
     have taken its route;
   - K2, the single-option fused march (European call, American put by
     projection and by Ikonen-Toivanen): its shared-memory route at 16x8,
     40x20, 100x50 and 160x50 (where the bands are read in place), its
     first design at 100x50 and on a grid too large for the other route
     (200x100), each public call checked to have taken its route;
   - K3, the time-varying CN march, on bands from the port's own lattice
     builder on the bench's Dupire surface: its warp route at n = 200, 3
     and 33 (so that a lane's chunk may hold one row or none; B = 256, 37,
     7 and 1), its first design at n = 200 (B = 256, 37 and 1) and on a
     lattice too long for the warp route (n = 520, B = 37), each public call
     checked to have taken its route; European and mixed American; w = 0.5
     and 1;
   - K4, the constant-coefficient CN march: its warp route at n = 200 (B =
     512, 130, 37, 7 and 1), at n = 3 and 33 (B = 37, 7 and 1) and at n =
     100, 300 and 512 (B = 37 and 1), its first design at n = 200 (B = 512,
     130 and 1) and on a lattice too long for the warp route (n = 520, B =
     37), each public call checked to have taken its route; European and
     mixed American; w = 0.5 and 1; the warp route also timed at one step;
   - K5, the batched Thomas solve: its lane-group route at the shapes of
     the scan paths ((50, 100), (100, 50) with bands shared by every
     system, (1, 200)), at a ragged batch (37, 100), on the Black-Scholes
     book's per-step system (512, 200) and the fused-ADI book's v sweep
     (51200, 50), each call checked to have taken its route, its first
     design timed beside it, ``torch.linalg.solve`` on the same systems as
     its yardstick, and one wrapper call profiled: it launches one kernel;
   - K6, the batched projected SOR, bit for bit, its residual equal to
     ``_residual``'s: on the Black-Scholes book's LCP (512, 200) at 60 and
     120 sweeps on both designs, its warp route on seeded LCPs at n = 2, 3,
     33 and 200 (B = 1, 7 and 37) and at n = 100, 150 and 256 (B = 1 and
     37) with and without a start, its first design at n = 300, 512 and
     600, each public call checked to have taken its route; both
     designs timed, and wrapper calls profiled: the kernel and at most one
     reduction a call;
4. headline calibration: bench.py's 108-quote surface through
   ``_calibrate_pipeline`` and ``HestonCalibrator.calibrate`` (DE 100/15,
   LM 60, seed 42), float32/complex64; then, with no kernel launched:
   ``price_fft`` (complex64 against the CPU's complex128), the 12 x 9
   ``implied_volatility_surface`` (float32 against the CPU's float64),
   ``greeks_ad`` (float64, against ``price_with_greeks``' stencils on the
   pricer it differentiates), bench_full.py's
   ``heston_pricing_grouped_options_per_sec`` (8192 options) and
   ``heston_batched_calibration_surfaces_per_sec`` (16 copies of the
   108-quote surface through ``HestonCalibrator.calibrate_batch``, every
   surface held to bench.py's gate, beside 16 sequential pipelines); and
   bench_full.py's Fourier-priced rows, one phase each, float32 against
   the port's float64 run on the CPU: the Bates and digital books on the
   8192-option grouped book, the 256-strike forward-start smile (and the
   card's complex64 ``log1p``), the 64-strike rough-Heston smile (at twice
   the CPU's own float32 error), the rough-Heston surface calibration
   (rmse < 5e-3), the 1024-quote variance strip and the vol-swap strike
   (1e-6 relative), and the 4096-quote spread and Stulz rainbow books; and
   bench_full.py's rates and credit rows: the 256-swaption Hull-White and
   128-swaption G2++ panels (one broadcast call each, within 1e-7 + 1e-4
   |p| of the port's float64 on the CPU, or twice the CPU's own float32
   error where that is larger), the 16-caplet Hull-White fit (rmse <=
   1e-4, sigma within 1%), the 4-swaption G2++ fit (rmse <= 1e-3), the
   5-pillar CDS bootstrap (hazards positive, repriced within 5e-4, within
   1e-4 of float64 on the CPU), and one daily orchestrator run with the
   rates, G2++ and credit stages, which must end in SUCCESS with no error;
   and bench_full.py's Heston Monte Carlo rows, float32: QE paths (2^17 x
   64; a martingale within 4 s.e., the call within 4 s.e. + 0.2% of
   ``price_accurate``, and the terminal state on a replay of a CPU
   generator's float64 draws within twice the CPU's own float32 error), the
   LSM put (2^16 x 64; within max(2%, 5 s.e.) of the IT-LCP put, above the
   European MC put), the 128-strike LSM book (calls fall with strike; on a
   replay, book against single at 4 strikes: float64 at 1e-10 on the card,
   float32 within twice the CPU's float32 tolerance or a quarter s.e.), the
   dual bound (12 dates; the sandwich and a gap under 4% + 4 s.e.), the
   16-strike pathwise Greeks (delta within 0.02 of ``greeks_ad``), a Sobol
   European (8 replicates, within 4 s.e. of ``price_accurate``) and a
   Bates American put by LSM (at least its European less 4 s.e.); and the
   rest of the Monte Carlo desk, float32: the 8-asset basket with two
   controls (2^20 paths x 16 strikes, within 4 s.e. of a plain float64 run
   on the CPU, the controls cutting the s.e.), the SLV particle
   calibration (65,536 x 48 steps, 31 bins; the leverage in its clamp, the
   martingale within 4 s.e.; the binning's one-hot product timed beside a
   float32 ``index_add_``), the Hull-White Bermudan MC sandwich (2^15,
   512 x 32; ordered within 4 s.e.), the four-swap netted CVA (2^16; within
   4 s.e. of float64 on the CPU), the lifted rough engine (European within
   4 s.e. + 1% of ``price_rough``, the American put by LSM at least its
   European less 4 s.e.), the G2++ Bermudan sandwich at its defaults, the
   spread and rainbow MC (within 4 s.e. of the quadrature and Stulz), and
   a European through ``lv_simulate_fn`` on bench.py's Dupire surface
   (within 4 s.e. + 1% of the local-vol PDE, float64 on the CPU);
5. fused-ADI book: 512 options at 100x50x100 through
   ``heston_adi.solve_fused_batch``, checked against the converged
   Carr-Madan price;
6. local-vol book: bench.py's row — a Dupire surface from Heston, 256
   options at 200x100 through ``local_vol_pde.solve_fused_batch``, checked
   against the ``route="scan"`` march on the same card;
7. Black-Scholes American book: 512 options at 200x100 through
   ``bs_pde.solve_fused_batch``, checked against the closed form and its
   own European book;
8. SABR smile: bench.py's 11-strike fit through
   ``SABRCalibrator.calibrate_single_maturity``, and one ``calibrate`` of a
   regular 5-maturity surface (the batched LM);
9. the Heston scan and single-option rows of bench_full.py (787-873):
   ``heston_adi.solve`` at 100x50x100 (K5), ``solve_fused`` (K2) held
   against it, the Ikonen-Toivanen American put through both, the mixed
   108-option surface through ``solve_batch`` (K5) and
   ``solve_fused_batch`` (K1), ``greeks_ad`` in float64 against central
   differences, and the 512-book with the PCR sweeps against the Thomas
   book;
10. ``bs_pde.solve`` for an American put at 200x100 by projection (K5),
    PSOR (K6) and Brennan-Schwartz; ``ops.tridiagonal_solve`` on a 2D
    float32 batch (K5); ``lcp.projected_sor_batched`` (K6);
11. the OU rows of bench_full.py (645-671): ``ou.simulate`` of 1024
    paths x 252 steps and ``ou.fit_mle`` over them (the mean fit against
    the same estimator on numpy float64 paths), and ``simulate_parallel``
    on one path of 10^6 steps: in float64 against ``simulate``'s step loop
    on the same normals, in float32 against its float64 self;
12. the HJB optimal-stopping solver: ``solve_all_boundaries`` at 200x200
    by projection (one K5 launch a step, exactly 200) and by PSOR (one K6
    launch a step, exactly 200), each within one cell of the reference
    engine's goldens and within 0.05 of a cell of its float64 march on
    the CPU; the reference engine's own band (``reference_compat``) by
    projection against all six goldens at 0.05 of a cell; Brennan-Schwartz
    at bench_full.py's 256x128 (no kernel) against PSOR;
    ``boundaries_batch`` for the 64-config book by Brennan-Schwartz and by
    projection (K5 on (256, 256)) against ``solve_all_boundaries`` on four
    of its configs; the five OU/HJB rows printed under bench_full.py's
    metric names;
13. the Hull-White Bermudan PDE ladder of bench_full.py (461-479): 64
    strikes as ONE march of (64, 257) systems, 160 steps, one K5 launch a
    step on its lane route with the bands shared (exactly 160), within
    1e-7 + 1e-4 |p| of float64 on the CPU (or twice the CPU's own float32
    error), the ATM price inside the MC sandwich +- 4 s.e.; timed outside
    the counted path (``hw_bermudan_pde_ladder_prices_per_sec``);
14. the jump-diffusion and barrier solvers of bench_full.py (765-782,
    878-885): the Merton call and Kou American put strips (128 strikes,
    512 x 128, two fixed-point passes: one K5 launch a pass on the (128,
    512) strip, exactly 256 each) and the Bates American put
    (Ikonen-Toivanen, 100 x 50 x 100: two K5 launches a step, exactly
    200), each within 1e-7 + 1e-4 |p| of float64 on the CPU (or twice the
    CPU's own float32 error), the Merton strip's float64 march within 3e-3
    rel + 5e-3 of the series, the Kou American above its European and the
    intrinsic, the Bates projection within 2e-2 of Ikonen-Toivanen and
    both above the European; the Heston up-and-out call at 200 x 60 x 200
    (400 launches) against float64 on the CPU, and the four barrier types
    in the Black-Scholes limit at 150 x 50 x 150 against Reiner-Rubinstein
    at 2e-2 (2N launches a knock-out, 4N a knock-in); the three rows timed
    outside the counted paths;
15. HJB's native backend: ``solve_all_boundaries(backend="native")`` on
    bench_full.py's 256x128 Brennan-Schwartz config runs on the C++ host
    twin, launches no kernel, lands within one cell of the card's march,
    and its median wall is printed beside the card's
    ``ou_freeboundary_psor_solve_s``;
16. the signal, sizing, VaR and serving layer (no kernel): bench_full.py's
    ``calibration_to_sizing_pipeline_s`` (945-979: the 108-quote fit, the
    vol-arbitrage signals and the vol-managed size, one warm run then the
    mean of 3; the fit at bench.py's gate, the card's float32 model IVs on
    the fitted parameters by the card gate against float64 on the CPU, the
    size equal to the sizer's numpy arithmetic), the pricing service
    (1074-1136: 20,000 requests from 32 clients through
    ``MicroBatchingServer``, buckets 8-2048, 2 ms wait, float32; every price
    by the card gate against the float64 pricer on the CPU, no error, every
    request answered, batches of more than one;
    ``pricing_service_requests_per_sec``, ``pricing_service_p99_latency_ms``,
    ``pricing_direct_batch_p99_latency_ms``; a 64-request Greeks batch in
    float64 within 1e-10 of the CPU's), and the risk rows: GARCH(1,1)'s
    likelihood and gradient (1e-10) and fit (1e-6) on 252 returns, EWMA
    over a (512, 252) universe (1e-12), Monte-Carlo VaR (10,000 x 8) on
    one replay of CPU normals (1e-10), each timed, float64 on the card
    against the CPU; then the backtests, validation statistics, linear
    algebra and options data (no kernel), float64 on the card against the
    CPU;
17. the command line, ``pde_tpu_torch.cli.main`` in this process at the
    CLI's own defaults: ``price --method cf|pde|digital|greeks`` (``pde``
    also ``--put --american``), ``varswap``, ``vix --strikes``, ``rates
    --bermudan --cap-vols``, ``credit``, ``pide`` (Merton; Kou ``--put
    --american``) and ``fwdstart``, each float32 on the card with every
    printed number held by the card gate against its float64 run on the
    CPU (the CPU's float32 run setting the gate); ``calibrate`` at
    bench.py's gate, ``fwdstart --mc-check`` within 4 s.e., ``scan`` and
    ``sector-portfolio`` (float64) and ``backtest`` equal to the CPU's
    output, ``status`` with every component initialised, ``portfolio`` and
    ``demo`` (rmse < 0.05); only ``price --method pde``, ``pide`` and
    ``rates --bermudan`` launch K5 (the Merton strip exactly as often as
    item 14's), and each subcommand's wall on a second call is printed
    (``cli_seconds``);
18. the parallel layer on a world-size-1 NCCL group made through the
    port's own ``initialize_distributed`` (a file store in a temporary
    directory) and ``make_mesh``, with one real ``all_reduce``:
    ``sharded_heston_solve`` at 100x50x100 and ``sharded_bs_solve`` (the
    American put by projection) at 200x50, float32, each by the card gate
    against the single-device port in float64 on the CPU and within 1e-7 +
    1e-4 |p| of the single-device port on the card, launching K5 exactly
    200 and 50 times (two sweeps a Heston step, one partitioned solve a
    Black-Scholes step); ``dist_tridiagonal_solve`` at (50, 100) against
    ``ops.tridiag.thomas`` (one launch); three ``sharded_calibration_step``s
    on the 108-quote surface against the single-device LM in float64 on
    the CPU; ``calibrate_batch(mesh=...)`` of 4 surfaces equal to the
    unmeshed fit, each at bench.py's gate; ``price_european_mc_sharded``
    and ``price_american_lsm_sharded`` within 4 s.e. of the single-device
    pricers; the sharded solves' walls beside the single-device port's
    (``parallel_rows``) and the phases' seconds (``parallel_seconds``);
    the group is destroyed after them, and on any failure;
19. the services facade: each of the four service steps (data ingestion,
    signals, calibration, execution) once on the card (float32) and once
    on the CPU (float64), each against a temporary sqlite file in a
    temporary working directory, with equal statuses and stored candidate
    signals; the ``HealthManager`` with the three synthetic probes (the
    calibration probe fitting on the card) all healthy; no kernel; their
    walls (``services_seconds``);
20. the collective audit (before the group of item 18 is destroyed):
    ``comm_audit.audit_table`` on the one-rank NCCL group, where every
    program of the six counts no collective and sends no byte (the
    collectives are skipped at one rank, as on the gloo ranks at P = 1 in
    the tests), its sharded solves launching K5 exactly 16 times;
21. the rest of the port: ``heston_adi_ref.solve_reference``, the C++
    reference's Heston scheme, in float64 on the card on the four golden
    cases of tests/test_golden_pde.py against
    tests/golden/reference_pde_values.json at 1e-10 (vega 1e-9), no
    kernel (``golden_pde``); the native host bindings against the port's
    card functions: ``native.thomas_solve`` against K5 at (50, 100) (one
    launch), ``native.heston_adi_solve`` against ``heston_adi.solve`` at
    100x50x100 in float32 (200 launches), each by the card gate, and
    ``native.ou_mle`` against ``ou.fit_mle`` in float64 on the card
    (``native_thomas``, ``native_heston_adi``, ``native_ou``); their walls
    (``rest_of_port_seconds``).

Before the paths, each of the six kernel wrappers is called on the card
with an input that requires grad: each must raise (the kernels have no
backward) and launch nothing, and run under ``torch.no_grad()``; the
fused-ADI book entry point must raise too, and ``tridiagonal_solve``
under grad must take the differentiable ``thomas``.

Each main path (4-21) runs with every kernel's launch count set to 0 just
before it and read just after; a path whose kernel never launched fails
(the rows of item 4 after the headline and those of item 16 must launch
none),
and so do the two Heston and local-vol books and the 108-option surface if
K1's or K3's redesigned route (``launches_smem``) never launched, the
Black-Scholes book if K4's warp route (``launches_warp``) did not,
``solve_fused`` and the Ikonen-Toivanen put if K2's did not, the scan
solves if K5's did not, PSOR ``bs_pde.solve`` and
``projected_sor_batched`` if K6's warp route did not, and each PCR book if
its sweeps' (``launches_pcr_v_smem``, ``launches_pcr_s_smem``) did not.
While they run, the first input set of each shape that each path hands K5
and K6 is kept; afterwards both kernels are held against their plain twins
on those very inputs, and timed at the shapes of the path whose launches
the kernel line reports (K5: ``heston_adi.solve``; K6: ``bs_pde.solve`` by
PSOR), and on lines of their own at the HJB paths' and the Bermudan ladder's
shapes.  Outside the
counted paths, the HJB rows are timed, and the 108-option surface and the
512-book run through K1's shared-memory route and its first design in
turns, and each route's options/s is printed.
Each phase prints one JSON line; then the kernel table (K5's and K6's rows
with their launches on the HJB paths, ``launches_hjb``; K5's with its
launches on the Bermudan ladder, ``launches_bermudan``, and its times and
bound at that shape, ``bermudan``; and likewise on the Merton PIDE strip,
``launches_pide`` and ``pide``; and its launches on the parallel and
rest-of-port paths, ``launches_parallel`` and ``launches_rest_of_port``),
the card's ``nvidia-smi`` name and power limit, and last ``{"ok": true,
"device": ...}``.
Any failure raises and exits non-zero before the last line.  Run from the
repository root with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --profile [ROW ...]`` instead builds the kernels and traces
one warm call of each book row, of the SABR fit, of ``heston_adi.solve``,
``solve_fused``, ``bs_pde.solve`` by PSOR, of the K5 and K6 calls, of the
OU and HJB rows, of the 8192-option grouped pricing, of the 16-surface
``calibrate_batch``, of the nine Fourier-priced rows, of the five rates
and credit rows, of the five Heston Monte Carlo rows, of the five rows
of the rest of the Monte Carlo desk, of the four jump-diffusion and
barrier rows, of the calibration-to-sizing pipeline, of one run of the
pricing service, of the universe's strategy optimization and the shuffled
Monte Carlo, of the command line's ``demo`` and ``price --method pde``, of
the sharded Heston march on the one-rank NCCL mesh and of one calibration
service pass under ``torch.profiler``: wall, the card's busy time and idle
share, and the kernels that took most of the device time.  Row
names after ``--profile`` (prefixes, e.g. ``rough``) trace those rows alone.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

S0, R, Q = 100.0, 0.05, 0.02
TRUE = dict(kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, v0=0.04)
GRID = dict(n_spot=100, n_vol=50, n_time=100)
BOOK_B = 512
BUDGET = dict(global_maxiter=100, global_popsize=15, local_max_iter=60)
# kernel vs plain: both float32 with the same step order; K1, K2 and K3
# keep FMA contraction (the others are built without it) and compose the
# values entering each lane's chunk of a sweep in another order; the error
# grows over the 100 steps
RTOL, ATOL = 1e-4, 1e-5
# the local-vol and Black-Scholes rows (bench.py:138-167, bench_full.py:847-863)
LV_R, LV_Q = 0.04, 0.01
LV_B, LV_GRID = 256, dict(n_space=200, n_time=100)
BS_R, BS_Q = 0.05, 0.01
BS_B, BS_GRID = 512, dict(n_space=200, n_time=100)
SABR_TRUTH = dict(alpha=0.25, beta=0.5, rho=-0.35, nu=0.45)
# bench_full.py:787-873: HestonPDEParams(q=0.02) at 100x50x100; the American
# put at r=0.08, q=0, S0=90; the 108-option surface (12 strikes x 9
# maturities, calls and puts alternating)
HESTON_PDE = dict(kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, v0=0.04, r=0.05,
                  q=0.02, T=1.0, K=100.0)
HESTON_TRUE_CALL = 9.05950689470441   # tests/test_solvers.py:140-149
# solve_fused against solve on the card: 5e-4 absolute on the price
# (tests/test_solvers.py:226-231); on the grid also 1e-5 relative, since at
# 100x50x100 the float32 march itself sits 4e-6 relative (1.05e-3 at a node
# of value 255) from the float64 one, both routes alike
FUSED_ATOL, FUSED_GRID_RTOL = 5e-4, 1e-5
PSOR_ITERS = (60, 120)
# bench_full.py:645-671: OU(theta=100, mu=5, sigma=2) from 100, 1024 paths
# of 252 daily steps; one path of 10^6 steps over 4 years (simulate_parallel)
OU = dict(theta=100.0, mu=5.0, sigma=2.0)
OU_PATHS, OU_STEPS, OU_LONG = 1024, 252, 1_000_000
# the float32 scan of that path against the float64 scan, relative: each
# float32 step rounds at the level of the path (ulp(100) ~7.6e-6), and over
# 10^6 steps those roundings drift; on these normals (seed 7) the float32
# step loop sat 2.68e-4 from float64 and the float32 scan 1.45e-4 (H100):
# the scan must stay within the loop's own drift
OU_LONG_F32_REL = 3e-4
# bench_full.py:887-922: the HJB rows' configuration and the 64-config book
HJB_BENCH = dict(theta=0.0, mu=5.0, sigma=0.1, r=0.05, c_entry=0.002, c_exit=0.002,
                 T=1.0, n_space=256, n_time=128)
HJB_B = 64
# the card's float32 HJB boundaries against float64 marches of the same
# problem: the CPU's float32 march sits within 0.05 of a cell of its
# float64 march (tests/test_torch_hjb.py); the value probes within 1e-5 of
# the goldens (values 0.03 and 0.2, the CPU's float32 march 6e-7 off)
HJB_CELLS, HJB_VALUE_ATOL = 0.05, 1e-5
# the Heston pricing and Greeks rows (no kernel): price_fft in complex64
# against the CPU's complex128 run on strikes 50-200 (the CPU's complex64
# run sits 4.8e-5 off); the 12 x 9 IV surface in float32 against the CPU's
# float64 (9e-7 on the CPU); greeks_ad against price_with_greeks' stencils
# on price_accurate, at the stencils' truncation error (O(bump^2), theta
# O(1/365))
FFT_ATOL, IV_F32_ATOL = 1e-3, 1e-5
FD_RTOL = dict(delta=1e-4, gamma=1e-4, rho=1e-4, vega=1e-4, theta=5e-3)
# bench_full.py:224-243 and 925-944: the 8192-option grouped book over 8
# maturities; U copies of the 108-quote surface calibrated as one batch
PRICING_N, CAL_U = 8192, 16
# the Fourier-priced rows (bench_full.py:245-347, 735-748), float32 on the
# card against the port's float64 run on the CPU: the Bates set, the rough
# Heston set and steps, the forward-start smile, the strip chain and the
# two-asset book; the digital book at 1e-5 absolute, the strip and the
# vol-swap strike at 1e-6 relative; the card's complex64 log1p (the
# forward-start hook) within 1e-6 of complex128 on small arguments
BATES = (2.0, 0.04, 0.3, -0.7, 0.04, 0.6, -0.08, 0.18)
ROUGH, ROUGH_STEPS = (0.1, 2.0, 0.04, 0.3, -0.7, 0.04), 192
FS_N, STRIP_N, TWO_ASSET_N = 256, 1024, 4096
DIGITAL_ATOL, STRIP_REL, VOLSWAP_REL, LOG1P_ATOL = 1e-5, 1e-6, 1e-6, 1e-6
# the rates and credit rows (bench_full.py:425-552), float32 on the card: the
# 6-pillar zero curve, HW(a 0.1, sigma 0.012), G2(0.5, 0.05, 0.01, 0.008,
# -0.6); 256 (HW) and 128 (G2) expiries in [0.5, 10] each into a 5-year
# semi-annual swap at its par strike; the panels within 1e-7 + 1e-4 |p| of
# the port's float64 on the CPU (or twice the CPU's own float32 error when
# that is larger); the CDS pillars and spreads; the bootstrap's repricing
# within 5e-4 relative, its hazards within 1e-4 relative of float64 on the
# CPU
RATES_TIMES = (0.5, 1.0, 2.0, 5.0, 10.0, 30.0)
RATES_ZEROS = (0.030, 0.032, 0.035, 0.040, 0.042, 0.043)
HW, G2 = (0.1, 0.012), (0.5, 0.05, 0.01, 0.008, -0.6)
HW_PANEL_N, G2_PANEL_N = 256, 128
PANEL_ATOL, PANEL_RTOL = 1e-7, 1e-4
CDS_PILLARS, CDS_SPREADS = (1.0, 3.0, 5.0, 7.0, 10.0), (0.008, 0.011, 0.013, 0.014, 0.015)
CDS_REPRICE_REL, CDS_HAZARD_REL = 5e-4, 1e-4
# the card's peaks (H100 SXM data sheet): float32 outside the tensor cores
# and HBM bandwidth; a kernel's bound is the larger of its operations over
# the one and its bytes over the other
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
KERNELS = {
    "K1": dict(name="fused_douglas_march_batched", route="cuda",
               source="pde_tpu_torch/csrc/adi_fused_batched.cu",
               replaces="pde_tpu/ops/adi_fused.py:250"),
    "K1-pcr_v": dict(name="fused_douglas_march_batched(pcr_v=True)", route="cuda",
                     source="pde_tpu_torch/csrc/adi_fused_batched.cu",
                     replaces="pde_tpu/ops/adi_fused.py:438"),
    "K1-pcr_s": dict(name="fused_douglas_march_batched(pcr_s=True)", route="cuda",
                     source="pde_tpu_torch/csrc/adi_fused_batched.cu",
                     replaces="pde_tpu/ops/adi_fused.py:396"),
    "K1-pcr_v+s": dict(name="fused_douglas_march_batched(pcr_v=True, pcr_s=True)",
                       route="cuda", source="pde_tpu_torch/csrc/adi_fused_batched.cu",
                       replaces="pde_tpu/ops/adi_fused.py:438"),
    "K2": dict(name="fused_douglas_march", route="cuda",
               source="pde_tpu_torch/csrc/adi_fused.cu",
               replaces="pde_tpu/ops/adi_fused.py:38"),
    "K3": dict(name="fused_cn_march_1d_tv", route="cuda",
               source="pde_tpu_torch/csrc/cn1d_tv_fused.cu",
               replaces="pde_tpu/ops/cn1d_tv_fused.py:59"),
    "K4": dict(name="fused_cn_march_1d", route="cuda",
               source="pde_tpu_torch/csrc/cn1d_fused.cu",
               replaces="pde_tpu/ops/cn1d_fused.py:36"),
    "K5": dict(name="thomas_batched", route="cuda",
               source="pde_tpu_torch/csrc/thomas_batched.cu",
               replaces="pde_tpu/ops/tridiag.py:182"),
    "K6": dict(name="projected_sor_batched", route="cuda",
               source="pde_tpu_torch/csrc/psor_batched.cu",
               replaces="pde_tpu/solvers/lcp.py:251"),
}


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def sync(torch, dev) -> None:
    """Wait for the card (a no-op for a CPU rehearsal of the phases)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(torch, fn, reps):
    """Mean milliseconds per call over ``reps`` calls after one warm-up,
    by CUDA events on the card."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(torch, fn, reps):
    """Mean milliseconds of the card's time per call over ``reps`` calls
    after one warm-up, by CUDA events, with a spin kernel holding the
    stream while the host enqueues the calls: a call whose host work
    outlasts its kernels is then timed by the card's work alone, not by
    the host's (which varies between machines)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # clock cycles at ~2 GHz, four times the host's enqueue time of the calls
    torch.cuda._sleep(int(4 * reps * host_s * 2e9))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes, n_flops):
    """The least time the card could take: (ms, what binds it)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(torch, dev, V, P, **what):
    """Kernel output ``V`` against its plain twin's ``P``: emit the errors,
    raise if any element is outside 1e-5 + 1e-4 |plain|; return max |diff|."""
    sync(torch, dev)
    err = (V - P).abs()
    limit = ATOL + RTOL * P.abs()
    max_abs = float(err.max())
    ok = bool((err <= limit).all()) and bool(torch.isfinite(V).all())
    emit(phase="kernel_vs_plain", **what, max_abs=max_abs,
         max_rel=float((err / P.abs().clamp_min(1e-30)).max()),
         max_over_bound=float((err / limit).max()), ok=ok)
    if not ok:
        raise AssertionError(f"kernel disagrees with plain on {what}")
    return max_abs


def book(torch, dev, B, american, grid):
    """Kernel inputs for a bench-like book, built by the port's own
    ``_march_inputs``: K in [85, 115], T in [0.25, 1.5], calls and puts
    alternating, ``american`` flags as given."""
    from pde_tpu_torch.solvers import heston_adi

    K = torch.linspace(85.0, 115.0, B)
    T = torch.linspace(0.25, 1.5, B)
    cf = (torch.arange(B) % 2).float()
    kappa, theta, sigma, rho, v0, r, q, T, K, cf, _, amer = \
        heston_adi._broadcast_batch(2.0, 0.04, 0.3, -0.7, 0.04, R, Q, T, K, cf,
                                    S0, american, dev)
    args, _ = heston_adi._march_inputs(
        kappa, theta, sigma, rho, r, q, T, K, cf, amer, grid["n_spot"],
        grid["n_vol"], grid["n_time"], 0.2, 5.0, 1.0)
    return args


def phase_kernel(torch, dev, grid=GRID, B=BOOK_B, plain_reps=3, kernel_reps=20):
    """The fused march against its plain twin on identical inputs: the
    shared-memory route at the bench grid and at ragged batches and grids,
    the first design where it ran before that route existed (the bench grid,
    B = 512, 130 and 1) and on a grid too large for that route (200x100).
    Both designs are timed at the bench shape."""
    from pde_tpu_torch.ops import adi_fused

    march = adi_fused.fused_douglas_march_batched
    plain = adi_fused._fused_douglas_march_batched_plain
    first = lambda *a, use_it=False: adi_fused._launch(*a, use_it, False, False)  # noqa: E731
    size = (grid["n_spot"], grid["n_vol"], grid["n_time"])
    cases = [(b, size) for b in (B, 130, 37, 1)]
    cases += [(b, (nS, nv, size[2])) for nS, nv in ((16, 8), (40, 20)) for b in (130, 37, 1)]
    worst = 0.0
    for b, sz in cases + [(37, (200, 100, size[2]))]:
        idx = torch.arange(b)
        mixed = (idx % 3 == 0).float()
        for name, amer, use_it in (("european", torch.zeros(b), False),
                                   ("american_projection", mixed, False),
                                   ("american_it", mixed, True)):
            smem = adi_fused._smem_plan(sz[0], sz[1], use_it) is not None
            args = book(torch, dev, b, amer, dict(zip(GRID, sz)))
            before = march.launches_smem
            V = march(*args, *sz, use_it=use_it)
            if (march.launches_smem > before) != smem:
                raise AssertionError(f"K1 at {sz} did not take the "
                                     f"{'shared-memory' if smem else 'first'} route")
            P = plain(*args, *sz, use_it)
            worst = max(worst, compare(torch, dev, V, P, kernel="K1", B=b, grid=list(sz),
                                       route="smem" if smem else "first", case=name))
            if smem and sz == size and b in (B, 130, 1):
                V = first(*args, *sz, use_it=use_it)
                worst = max(worst, compare(torch, dev, V, P, kernel="K1", B=b,
                                           grid=list(sz), route="first", case=name))

    args = book(torch, dev, B, torch.zeros(B), grid)
    before = march.launches_smem
    ms = kernel_ms(torch, lambda: march(*args, *size), kernel_reps)
    if march.launches_smem <= before:
        raise AssertionError("the kernel's shared-memory launch count did not move")
    first_ms = kernel_ms(torch, lambda: first(*args, *size), kernel_reps)
    plain_ms = time_ms(torch, lambda: plain(*args, *size, False), plain_reps)
    emit(phase="kernel_timing", kernel="K1", B=B, grid=list(size), kernel_ms=ms,
         first_design_ms=first_ms, plain_ms=plain_ms, kernel_options_per_s=B / ms * 1e3,
         plain_options_per_s=B / plain_ms * 1e3)
    # per node and step (csrc/adi_fused_batched.cu): explicit rhs 20, S sweep
    # 5, rhs2 7, v sweep 5, floor 1 = 38 flops
    nodes = size[0] * size[1] * B
    n_bytes = nbytes(*args) + nodes * 4
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound=bound(n_bytes, 38.0 * nodes * size[2]))


def lv_surface(torch, dev, n_strikes=24, n_maturities=6):
    """bench.py's Dupire surface: Heston (2.0, 0.04, 0.3, -0.7, 0.04), strikes
    exp(linspace(ln 60, ln 170)) x maturities linspace(0.05, 1.0), S0=100,
    r=0.04, q=0.01, float32 on ``dev``; as a SurfaceInterpolator."""
    import numpy as np

    from pde_tpu_torch.models import heston, local_vol

    ks = np.exp(np.linspace(np.log(60.0), np.log(170.0), n_strikes))
    ts = np.linspace(0.05, 1.0, n_maturities)
    t0 = time.perf_counter()
    surf = local_vol.dupire_surface(heston.HestonParams(**TRUE), ks, ts, 100.0,
                                    LV_R, LV_Q, device=dev, dtype=torch.float32)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    ok = bool(torch.isfinite(surf).all()) and float(surf.min()) >= 0.01 \
        and float(surf.max()) <= 4.0
    emit(phase="dupire_surface", shape=list(surf.shape), min=float(surf.min()),
         max=float(surf.max()), wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("the Dupire surface is not finite and in [0.01, 4]")
    return local_vol.SurfaceInterpolator(ks, ts, surf, device=dev)


def lv_book(torch, dev, B):
    """bench.py's local-vol book: K in [70, 140], T in [0.25, 1.5], calls
    and puts alternating."""
    return (torch.linspace(70.0, 140.0, B, device=dev),
            torch.linspace(0.25, 1.5, B, device=dev),
            (torch.arange(B, device=dev) % 2).float())


def phase_k3(torch, dev, interp, grid=LV_GRID, B=LV_B, plain_reps=1, kernel_reps=20):
    """K3 against its plain twin on bands from the port's lattice builder:
    the warp route at n = 200, 3 and 33, the first design at n = 200 (where
    it ran before the warp route existed) and on a lattice too long for
    that route (n = 520).  Both designs are timed at the bench shape."""
    from pde_tpu_torch.ops import cn1d_tv_fused
    from pde_tpu_torch.solvers import local_vol_pde

    march = cn1d_tv_fused.fused_cn_march_1d_tv
    plain = cn1d_tv_fused._fused_cn_march_1d_tv_plain
    n, nT = grid["n_space"], grid["n_time"]

    def inputs(b, amer, m=n):
        K, T, cf = lv_book(torch, dev, b)
        return local_vol_pde._march_inputs(interp, K, T, cf, amer, LV_R, LV_Q, m, nT,
                                           0.2, 5.0)[:3]

    worst = 0.0
    long_n = 520   # over the warp route's 518 rows: the first design
    for m, batches in ((n, (B, 37, 7, 1)), (3, (B, 37, 7, 1)), (33, (B, 37, 7, 1)),
                       (long_n, (37,))):
        warp = cn1d_tv_fused._smem_bytes(m) is not None
        for b in batches:
            mixed = (torch.arange(b, device=dev) % 3 == 0).float()
            for name, amer in (("european", torch.zeros(b, device=dev)),
                               ("american_mixed", mixed)):
                args = inputs(b, amer, m)
                for w in (0.5, 1.0):
                    before = (march.launches, march.launches_smem)
                    V = march(*args, m, nT, w)
                    if (march.launches - before[0], march.launches_smem - before[1]) \
                            != (1, int(warp)):
                        raise AssertionError(f"K3 at n={m} did not take the "
                                             f"{'warp' if warp else 'first'} route")
                    P = plain(*args, m, nT, w)
                    worst = max(worst, compare(torch, dev, V, P, kernel="K3", B=b, n=m,
                                               route="warp" if warp else "first",
                                               case=name, w=w))
                    # the first design where it ran before the warp route
                    # existed: the bench lattice, B = 256, 37 and 1
                    if m == n and b != 7:
                        V = cn1d_tv_fused._launch_first(*args, m, nT, w)
                        worst = max(worst, compare(torch, dev, V, P, kernel="K3", B=b, n=m,
                                                   route="first", case=name, w=w))

    args = inputs(B, torch.zeros(B, device=dev))
    before = march.launches_smem
    ms = kernel_ms(torch, lambda: march(*args, n, nT), kernel_reps)
    if march.launches_smem <= before:
        raise AssertionError("K3's warp-route launch count did not move")
    first_ms = kernel_ms(torch, lambda: cn1d_tv_fused._launch_first(*args, n, nT, 0.5),
                         kernel_reps)
    plain_ms = time_ms(torch, lambda: plain(*args, n, nT, 0.5), plain_reps)
    emit(phase="kernel_timing", kernel="K3", B=B, grid=[n, nT], kernel_ms=ms,
         first_design_ms=first_ms, plain_ms=plain_ms, kernel_options_per_s=B / ms * 1e3,
         plain_options_per_s=B / plain_ms * 1e3)
    # per node and step, as the twin counts them (csrc/cn1d_tv_fused.cu):
    # explicit stencil and rhs 7, implicit rows 4, pivot 3, c and d 4, back
    # substitution 2, floor 4 = 24
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound=bound(nbytes(*args) + n * B * 4, 24.0 * n * nT * B))


def bs_inputs(torch, dev, B, american, grid=BS_GRID):
    """K4's inputs for bench_full.py's book: sigma in [0.15, 0.45], T in
    [0.25, 1.5], K in [80, 120], calls and puts alternating."""
    from pde_tpu_torch.solvers import bs_pde

    full = lambda v: torch.full((B,), v, device=dev)  # noqa: E731
    return bs_pde._march_inputs(
        torch.linspace(0.15, 0.45, B, device=dev), full(BS_R), full(BS_Q),
        torch.linspace(0.25, 1.5, B, device=dev), torch.linspace(80.0, 120.0, B, device=dev),
        (torch.arange(B, device=dev) % 2).float(), american, grid["n_space"],
        grid["n_time"], 0.2, 5.0)[:2]


def phase_k4(torch, dev, grid=BS_GRID, B=BS_B, plain_reps=1, kernel_reps=20):
    """K4 against its plain twin on the bench book's inputs: the warp route
    at n = 200 (B = 512, 130, 37, 7 and 1), 3 and 33 (so that a lane's
    chunk may hold one row or none; B = 37, 7 and 1), and 100, 300 and 512
    (register chunks of 4, 16 and 16 slots a lane: at 300 a lane uses 10 of
    its 16, at 512 all; B = 37 and 1), the first design at n = 200 (B
    = 512, 130 and 1, where it ran before the warp route existed) and on a
    lattice too long for the warp route (n = 520, B = 37), each public call
    checked to have taken its route; European and mixed American; w = 0.5
    and 1.  Both designs timed at the bench shape; the warp route also at
    one step (its set-up's share of the march)."""
    from pde_tpu_torch.ops import cn1d_fused

    march = cn1d_fused.fused_cn_march_1d
    plain = cn1d_fused._fused_cn_march_1d_plain
    n, nT = grid["n_space"], grid["n_time"]
    worst = 0.0
    long_n = 520   # over the warp route's 512 rows: the first design
    for m, batches in ((n, (B, 130, 37, 7, 1)), (3, (37, 7, 1)), (33, (37, 7, 1)),
                       (100, (37, 1)), (300, (37, 1)), (512, (37, 1)), (long_n, (37,))):
        warp = cn1d_fused._warp_plan(m) is not None
        for b in batches:
            mixed = (torch.arange(b, device=dev) % 3 == 0).float()
            for name, amer in (("european", torch.zeros(b, device=dev)),
                               ("american_mixed", mixed)):
                args = bs_inputs(torch, dev, b, amer, dict(n_space=m, n_time=nT))
                for w in (0.5, 1.0):
                    before = (march.launches, march.launches_warp)
                    V = march(*args, m, nT, w)
                    if (march.launches - before[0], march.launches_warp - before[1]) \
                            != (1, int(warp)):
                        raise AssertionError(f"K4 at n={m} did not take the "
                                             f"{'warp' if warp else 'first'} route")
                    P = plain(*args, m, nT, w)
                    worst = max(worst, compare(torch, dev, V, P, kernel="K4", B=b, n=m,
                                               route="warp" if warp else "first",
                                               case=name, w=w))
                    if m == n and b in (B, 130, 1):
                        V = cn1d_fused._launch_first(*args, m, nT, w)
                        worst = max(worst, compare(torch, dev, V, P, kernel="K4", B=b, n=m,
                                                   route="first", case=name, w=w))

    args = bs_inputs(torch, dev, B, torch.ones(B, device=dev), grid)
    before = march.launches_warp
    ms = kernel_ms(torch, lambda: march(*args, n, nT), kernel_reps)
    if march.launches_warp <= before:
        raise AssertionError("K4's warp-route launch count did not move")
    first_ms = kernel_ms(torch, lambda: cn1d_fused._launch_first(*args, n, nT, 0.5),
                         kernel_reps)
    one_step_ms = kernel_ms(torch, lambda: cn1d_fused._launch_warp(*args, n, 1, 0.5),
                            kernel_reps)
    plain_ms = time_ms(torch, lambda: plain(*args, n, nT, 0.5), plain_reps)
    step_ms = (ms - one_step_ms) / (nT - 1)
    emit(phase="kernel_timing", kernel="K4", B=B, grid=[n, nT], kernel_ms=ms,
         first_design_ms=first_ms, one_step_ms=one_step_ms,
         set_up_share=(one_step_ms - step_ms) / ms,
         plain_ms=plain_ms,
         kernel_options_per_s=B / ms * 1e3, plain_options_per_s=B / plain_ms * 1e3)
    # per node and step (csrc/cn1d_fused.cu): explicit stencil and rhs 7,
    # factored forward sweep 3, back substitution 2, floor 4 = 16
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, first_design_ms=first_ms,
                bound=bound(nbytes(*args) + n * B * 4, 16.0 * n * nT * B))


def phase_calibration(torch, dev, dtype, budget=BUDGET, timed_runs=3):
    """bench.py's headline surface through the pipeline and the calibrator."""
    import numpy as np

    from pde_tpu_torch.calibrate.heston import (PARAM_ORDER, HestonCalibrator,
                                                _calibrate_pipeline)
    from pde_tpu_torch.models.heston import group_maturities

    data = HestonCalibrator.generate_synthetic_data(
        S0=S0, r=R, q=Q, **TRUE, strikes=np.linspace(85.0, 115.0, 12),
        maturities=np.linspace(0.25, 1.5, 9), device=dev, dtype=dtype)
    n = len(data["strike"])
    unique_T, t_idx = group_maturities(data["maturity"])
    cal = HestonCalibrator(seed=42, device=dev, dtype=dtype, **budget)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    bounds = [t([cal.bounds[k][i] for k in PARAM_ORDER]) for i in (0, 1)]
    args = (t(data["strike"]), torch.as_tensor(t_idx, dtype=torch.int64, device=dev),
            t(unique_T), torch.as_tensor(data["is_call"], device=dev),
            t(data["mid_price"]), torch.ones(n, dtype=dtype, device=dev),
            S0, R, Q, *bounds)

    def run():
        gen = torch.Generator(device=dev)
        gen.manual_seed(42)
        out = _calibrate_pipeline(*args, gen, torch.zeros(5, dtype=dtype, device=dev),
                                  False, **budget)
        sync(torch, dev)
        return out

    run()  # warm-up
    walls = []
    for _ in range(timed_runs):
        t0 = time.perf_counter()
        out = run()
        walls.append(time.perf_counter() - t0)
    lm_x = out[3].cpu().double().numpy()
    rel_rmse = float(np.sqrt(2.0 * float(out[4]) / n))
    ok = abs(lm_x[4] - TRUE["v0"]) < 0.02 and rel_rmse < 0.05  # bench.py:274
    emit(phase="calibration_pipeline", n_quotes=n, params=lm_x.tolist(),
         rel_rmse=rel_rmse, de_n_iter=int(out[2]), lm_n_iter=int(out[6]),
         wall_s=statistics.median(walls), wall_s_runs=walls, ok=ok)
    if not ok:
        raise AssertionError("the calibration pipeline missed the truth")

    t0 = time.perf_counter()
    res = cal.calibrate(data, S0=S0, r=R, q=Q)
    wall = time.perf_counter() - t0
    rel_rmse = float(np.sqrt(2.0 * res.convergence["local_cost"] / n))
    ok = abs(res.params.v0 - TRUE["v0"]) < 0.02 and rel_rmse < 0.05
    emit(phase="calibrator", params=[getattr(res.params, k) for k in PARAM_ORDER],
         rel_rmse=rel_rmse, rmse=res.rmse, success=res.success, wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("HestonCalibrator.calibrate missed the truth")


def fd_greeks(torch, dev, params, strike, maturity, is_call=True):
    """``price_with_greeks``' stencils and bumps (heston.cpp:169-218) on
    ``price_accurate`` in float64 on ``dev``: the pricer ``greeks_ad``
    differentiates (``price_with_greeks`` prices on the reference grid,
    whose ~2% bias at the money moves its delta by ~0.02)."""
    from pde_tpu_torch.models import heston

    t = lambda x: torch.tensor(x, dtype=torch.float64, device=dev)  # noqa: E731

    def p(s=S0, r=R, T=maturity, v0=TRUE["v0"]):
        return float(heston.price_accurate(params._replace(v0=t(v0)), t(strike), t(T),
                                           t(s), r, Q, is_call))

    es, er, et, ev = S0 * 1e-3, 1e-4, 1.0 / 365.0, 1e-3
    mid, up, dn = p(), p(s=S0 + es), p(s=S0 - es)
    return {"delta": (up - dn) / (2 * es), "gamma": (up - 2 * mid + dn) / es ** 2,
            "rho": (p(r=R + er) - p(r=R - er)) / (2 * er),
            "theta": (p(T=maturity - et) - mid) / et,
            "vega": (p(v0=TRUE["v0"] + ev) - p(v0=TRUE["v0"] - ev)) / (2 * ev)}


def pricing_book(torch, dev, dtype):
    """bench_full.py:224-243: 8192 strikes in [60, 140] over 8 maturities in
    [0.1, 2.0], grouped: (params, strikes, t_idx, unique_T)."""
    import numpy as np

    from pde_tpu_torch.models import heston

    mats = np.tile(np.linspace(0.1, 2.0, 8), PRICING_N // 8)
    unique_T, t_idx = heston.group_maturities(mats)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    return (heston.HestonParams(*(t(v) for v in TRUE.values())),
            t(np.linspace(60.0, 140.0, PRICING_N)),
            torch.as_tensor(t_idx, dtype=torch.int64, device=dev), t(unique_T))


def phase_heston_extras(torch, dev, reps=20):
    """The Heston FFT, IV surface, Greeks and grouped pricing on the card
    (no kernel: tensor ops and ``torch.fft.fft``), each held to its gate:
    ``price_fft`` (4096 x 0.25) in complex64 against the CPU's complex128
    run; the 12 x 9 ``implied_volatility_surface`` in float32 against the
    CPU's float64; ``greeks_ad`` in float64 against ``price_with_greeks``'
    stencils on ``price_accurate``, and ``price_with_greeks`` in float64 on
    the card against the CPU at 1e-8 relative; bench_full.py's
    ``heston_pricing_grouped_options_per_sec`` (8192 options, 8 maturities,
    float32) against the CPU's float64 prices."""
    import numpy as np

    from pde_tpu_torch.models import heston

    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")

    def params(dtype, device):
        return heston.HestonParams(*(torch.tensor(v, dtype=dtype, device=device)
                                     for v in TRUE.values()))

    def scalar(x, dtype, device):
        return torch.tensor(x, dtype=dtype, device=device)

    # the Carr-Madan FFT
    def fft(p, dt, d):
        return heston.price_fft(p, scalar(1.0, dt, d), scalar(S0, dt, d), R, Q)

    p32 = params(f32, dev)
    (k_card, c_card), fft_walls = timed_walls(torch, dev, lambda: fft(p32, f32, dev), reps)
    k_cpu, c_cpu = fft(params(f64, cpu), f64, cpu)
    band = (torch.exp(k_cpu) > 50.0) & (torch.exp(k_cpu) < 200.0)
    fft_err = float((c_card.cpu().double() - c_cpu)[band].abs().max())

    # the implied-vol surface, 12 maturities x 9 strikes
    Ks, Ts = np.linspace(85.0, 115.0, 9), np.linspace(0.25, 1.5, 12)
    surf = lambda p, dt, d: heston.implied_volatility_surface(  # noqa: E731
        p, torch.as_tensor(Ks, dtype=dt, device=d), torch.as_tensor(Ts, dtype=dt, device=d),
        S0, R, Q)
    iv_card, iv_walls = timed_walls(torch, dev, lambda: surf(p32, f32, dev), reps)
    iv_err = float((iv_card.cpu().double() - surf(params(f64, cpu), f64, cpu)).abs().max())

    # exact Greeks by autograd, float64 on the card, at the money
    p64 = params(f64, dev)
    ad, ad_walls = timed_walls(torch, dev, lambda: heston.greeks_ad(
        p64, scalar(100.0, f64, dev), scalar(1.0, f64, dev), scalar(S0, f64, dev), R, Q),
        reps)
    fd = fd_greeks(torch, dev, p64, 100.0, 1.0)
    fd_rel = {k: abs(float(ad[k]) - v) / abs(v) for k, v in fd.items()}
    pwg = {d: heston.price_with_greeks(params(f64, d), scalar(100.0, f64, d),
                                       scalar(1.0, f64, d), scalar(S0, f64, d), R, Q)
           for d in (dev, cpu)}
    pwg_rel = max(abs(float(pwg[dev][k]) - float(pwg[cpu][k])) / abs(float(pwg[cpu][k]))
                  for k in pwg[cpu])

    # bench_full.py's grouped pricing row
    book = pricing_book(torch, dev, f32)
    card = heston.price_carr_madan_grouped(*book, S0, R, Q)
    ref = heston.price_carr_madan_grouped(
        params(f64, cpu), book[1].cpu().double(), book[2].cpu(), book[3].cpu().double(),
        S0, R, Q)
    err = (card.cpu().double() - ref).abs()
    price_over_gate = float((err / (ATOL + RTOL * ref.abs())).max())
    per_call_ms = time_ms(torch, lambda: heston.price_carr_madan_grouped(*book, S0, R, Q),
                          reps)

    ok = (fft_err <= FFT_ATOL and iv_err <= IV_F32_ATOL and bool(torch.isfinite(c_card).all())
          and all(fd_rel[k] <= FD_RTOL[k] for k in fd_rel) and pwg_rel <= 1e-8
          and price_over_gate <= 1.0 and bool(torch.isfinite(card).all()))
    emit(phase="heston_extras",
         price_fft=dict(n_fft=4096, eta=0.25, dtype="complex64", max_abs_vs_cpu_c128=fft_err,
                        gate=FFT_ATOL, strikes=[50.0, 200.0],
                        wall_ms=1e3 * statistics.median(fft_walls)),
         iv_surface=dict(shape=list(iv_card.shape), dtype="float32",
                         max_abs_vs_cpu_f64=iv_err, gate=IV_F32_ATOL,
                         wall_ms=1e3 * statistics.median(iv_walls)),
         greeks_ad=dict(dtype="float64", ad={k: float(v) for k, v in ad.items()},
                        fd_on_price_accurate=fd, rel_err=fd_rel, gate=FD_RTOL,
                        price_with_greeks={k: float(v) for k, v in pwg[dev].items()},
                        price_with_greeks_card_vs_cpu_rel=pwg_rel,
                        price_with_greeks_gate=1e-8,
                        wall_ms=1e3 * statistics.median(ad_walls)),
         pricing_grouped=dict(options=PRICING_N, maturities=8, dtype="float32",
                              max_over_gate_vs_cpu_f64=price_over_gate,
                              gate=f"{ATOL} + {RTOL} |price|", per_call_ms=per_call_ms),
         heston_pricing_grouped_options_per_sec=PRICING_N / (per_call_ms * 1e-3), ok=ok)
    if not ok:
        raise AssertionError("a Heston extra missed its gate")


def calibrate_batch_book(torch, dev, dtype):
    """bench_full.py:925-944: U copies of the 108-quote surface (12 strikes
    in [85, 115] x 9 maturities in [0.25, 1.5], priced from TRUE)."""
    import numpy as np

    from pde_tpu_torch.calibrate.heston import HestonCalibrator

    data = HestonCalibrator.generate_synthetic_data(
        S0=S0, r=R, q=Q, **TRUE, strikes=np.linspace(85.0, 115.0, 12),
        maturities=np.linspace(0.25, 1.5, 9), device=dev, dtype=dtype)
    tile = lambda a: np.tile(np.asarray(a), (CAL_U, 1))  # noqa: E731
    return (tile(data["strike"]), tile(data["maturity"]), tile(data["mid_price"]),
            np.full(CAL_U, S0))


def phase_calibrate_batch(torch, dev, budget=BUDGET, timed_runs=3):
    """bench_full.py's ``heston_batched_calibration_surfaces_per_sec``: U =
    16 copies of the 108-quote surface through
    ``HestonCalibrator.calibrate_batch`` (DE 100/15, LM 60, float32), the
    median of ``timed_runs`` warm calls, every surface held to bench.py:274's
    gate (|v0 - 0.04| < 0.02, rel_rmse < 0.05); then the same U surfaces as
    U sequential ``_calibrate_pipeline`` calls, timed once, for the wall
    the batch replaces."""
    import numpy as np

    from pde_tpu_torch.calibrate.heston import (PARAM_ORDER, HestonCalibrator,
                                                _calibrate_pipeline)
    from pde_tpu_torch.models.heston import group_maturities

    f32 = torch.float32
    strikes, maturities, prices, spots = calibrate_batch_book(torch, dev, f32)
    n = strikes.shape[1]
    cal = HestonCalibrator(seed=42, device=dev, dtype=f32, **budget)
    out, walls = timed_walls(torch, dev, lambda: cal.calibrate_batch(
        strikes, maturities, prices, spots, R, Q), timed_runs)
    params = out["params"].cpu().double().numpy()
    rel_rmse = np.sqrt(2.0 * out["cost"].cpu().double().numpy() / n)
    ok = bool(np.all(np.abs(params[:, 4] - TRUE["v0"]) < 0.02) and np.all(rel_rmse < 0.05))

    t = lambda a: torch.as_tensor(a, dtype=f32, device=dev)  # noqa: E731
    unique_T, t_idx = group_maturities(maturities[0])
    bounds = [t([cal.bounds[k][i] for k in PARAM_ORDER]) for i in (0, 1)]
    args = (t(strikes[0]), torch.as_tensor(t_idx, dtype=torch.int64, device=dev), t(unique_T),
            torch.ones(n, dtype=torch.bool, device=dev), t(prices[0]),
            torch.ones(n, dtype=f32, device=dev), S0, R, Q, *bounds)
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)
    sync(torch, dev)
    t0 = time.perf_counter()
    seq = [_calibrate_pipeline(*args, gen, torch.zeros(5, dtype=f32, device=dev), False,
                               **budget) for _ in range(CAL_U)]
    sync(torch, dev)
    seq_wall = time.perf_counter() - t0
    seq_v0 = [float(o[3][4]) for o in seq]
    ok = ok and all(abs(v - TRUE["v0"]) < 0.02 for v in seq_v0)

    wall = statistics.median(walls)
    emit(phase="calibrate_batch", surfaces=CAL_U, n_quotes=n, dtype="float32",
         heston_batched_calibration_surfaces_per_sec=CAL_U / wall, wall_s=wall,
         wall_s_runs=walls, v0=params[:, 4].tolist(), rel_rmse=rel_rmse.tolist(),
         gate="|v0 - 0.04| < 0.02 and rel_rmse < 0.05 on every surface",
         de_generations=out["de_n_iter"].tolist(),
         de_generations_max=int(out["de_n_iter"].max()),
         lm_iterations=out["lm_n_iter"].tolist(),
         sequential_pipelines_wall_s=seq_wall,
         sequential_surfaces_per_sec=CAL_U / seq_wall,
         sequential_de_generations=[int(o[2]) for o in seq],
         sequential_lm_iterations=[int(o[6]) for o in seq], sequential_v0=seq_v0, ok=ok)
    if not ok:
        raise AssertionError("a surface of the batched calibration missed bench.py's gate")


def fourier_params(torch, dev, dtype, which):
    """bench_full.py's parameter sets as tensors of ``dtype`` on ``dev``:
    Heston TRUE, Bates (:316), rough Heston (:250)."""
    from pde_tpu_torch.models import bates, heston, rough_heston

    cls, values = {"heston": (heston.HestonParams, TRUE.values()),
                   "bates": (bates.BatesParams, BATES),
                   "rough": (rough_heston.RoughHestonParams, ROUGH)}[which]
    return cls(*(torch.tensor(v, dtype=dtype, device=dev) for v in values))


def pricing_row(torch, dev, row, n, fn, ref, reps, also_ok=True, **extra):
    """Time ``fn`` on the card (float32), hold it against the CPU's float64
    ``ref`` at 1e-5 + 1e-4 |p| (and ``also_ok``) and emit the row: ``n``
    options a call."""
    card = fn()
    err = (card.cpu().double() - ref.cpu().double()).abs()
    over = float((err / (ATOL + RTOL * ref.cpu().double().abs())).max())
    per_call_ms = time_ms(torch, fn, reps)
    ok = over <= 1.0 and bool(torch.isfinite(card).all()) and also_ok
    emit(phase=row, dtype="float32", n=n, per_call_ms=per_call_ms,
         max_over_gate_vs_cpu_f64=over, gate=f"{ATOL} + {RTOL} |price|",
         **{row: n / (per_call_ms * 1e-3)}, **extra, ok=ok)
    if not ok:
        raise AssertionError(f"{row} missed its gate")


def phase_bates_pricing(torch, dev, reps=50):
    """bench_full.py:305-311: ``price_carr_madan_gl_grouped`` on the Bates
    set over the 8192-option grouped book of the Heston row."""
    from pde_tpu_torch.models import bates

    cpu = torch.device("cpu")
    _, K, t_idx, uT = pricing_book(torch, dev, torch.float32)
    p32 = fourier_params(torch, dev, torch.float32, "bates")
    ref = bates.price_carr_madan_gl_grouped(
        fourier_params(torch, cpu, torch.float64, "bates"), K.cpu().double(), t_idx.cpu(),
        uT.cpu().double(), S0, R, Q)
    pricing_row(torch, dev, "bates_pricing_grouped_options_per_sec", PRICING_N,
                lambda: bates.price_carr_madan_gl_grouped(p32, K, t_idx, uT, S0, R, Q),
                ref, reps)


def phase_digital_pricing(torch, dev, reps=50):
    """bench_full.py:313-321: ``digital.price_grouped`` (cash calls) on the
    Heston set over the same book; 1e-5 absolute, every price in
    [0, e^{-rT}]."""
    from pde_tpu_torch.models import digital

    cpu = torch.device("cpu")
    _, K, t_idx, uT = pricing_book(torch, dev, torch.float32)
    p32 = fourier_params(torch, dev, torch.float32, "heston")
    fn = lambda: digital.price_grouped(p32, K, t_idx, uT, S0, R, Q)  # noqa: E731
    ref = digital.price_grouped(fourier_params(torch, cpu, torch.float64, "heston"),
                                K.cpu().double(), t_idx.cpu(), uT.cpu().double(), S0, R, Q)
    card = fn().cpu().double()
    disc = torch.exp(-R * uT[t_idx].cpu().double())
    in_range = bool((card >= 0.0).all() and (card <= disc * (1.0 + 2.0 ** -23)).all())
    err = float((card - ref).abs().max())
    per_call_ms = time_ms(torch, fn, reps)
    ok = err <= DIGITAL_ATOL and in_range and bool(torch.isfinite(card).all())
    emit(phase="digital_pricing", dtype="float32", n=PRICING_N, per_call_ms=per_call_ms,
         max_abs_vs_cpu_f64=err, gate=DIGITAL_ATOL, prices_in_0_disc=in_range,
         digital_pricing_grouped_options_per_sec=PRICING_N / (per_call_ms * 1e-3), ok=ok)
    if not ok:
        raise AssertionError("digital_pricing_grouped_options_per_sec missed its gate")


def phase_forward_start(torch, dev, reps=20):
    """bench_full.py:735-748: ``price_forward_start`` on 256 relative
    strikes in [0.7, 1.3], fixing 0.5, maturity 1.0."""
    from pde_tpu_torch.models import forward_start

    cpu = torch.device("cpu")
    k = lambda d, dt: torch.linspace(0.7, 1.3, FS_N, dtype=dt, device=d)  # noqa: E731
    p32, k32 = fourier_params(torch, dev, torch.float32, "heston"), k(dev, torch.float32)
    ref = forward_start.price_forward_start(
        fourier_params(torch, cpu, torch.float64, "heston"), k(cpu, torch.float64), 0.5, 1.0,
        rate=R, dividend=Q)
    # the hook's complex log1p (sigma -> 0 needs its absolute accuracy near 0)
    z = torch.tensor([1e-7 + 2e-7j, -3e-5 + 1e-6j, 0.01 - 0.02j, 0.3 - 0.2j],
                     dtype=torch.complex128)
    log1p_err = float((torch.log1p(z.to(torch.complex64).to(dev)).cpu().to(torch.complex128)
                       - torch.log1p(z)).abs().max())
    pricing_row(torch, dev, "forward_start_analytic_smile256_options_per_sec", FS_N,
                lambda: forward_start.price_forward_start(p32, k32, 0.5, 1.0, rate=R,
                                                          dividend=Q),
                ref, reps, also_ok=log1p_err <= LOG1P_ATOL,
                log1p_complex64_max_abs_vs_cpu_c128=log1p_err)


def rough_smile(torch, d, dtype, params=None):
    """bench_full.py:245-255's smile on ``d`` in ``dtype``."""
    from pde_tpu_torch.models import rough_heston

    if params is None:
        params = fourier_params(torch, d, dtype, "rough")
    return rough_heston.price_rough(
        params, torch.linspace(80.0, 120.0, 64, dtype=dtype, device=d),
        torch.tensor(0.25, dtype=dtype, device=d), S0, R, Q, n_steps=ROUGH_STEPS)


def phase_rough_smile(torch, dev, reps=10):
    """bench_full.py:245-255: ``price_rough`` on 64 strikes in [80, 120],
    T = 0.25, 192 steps, float32; held at twice the CPU's own float32
    error against its float64 run, measured here."""
    cpu = torch.device("cpu")
    ref = rough_smile(torch, cpu, torch.float64)
    cpu_err = float((rough_smile(torch, cpu, torch.float32).double() - ref).abs().max())
    p32 = fourier_params(torch, dev, torch.float32, "rough")
    card, walls = timed_walls(torch, dev, lambda: rough_smile(torch, dev, torch.float32, p32),
                              reps)
    err = float((card.cpu().double() - ref).abs().max())
    ok = err <= 2.0 * cpu_err and bool(torch.isfinite(card).all())
    per = statistics.mean(walls)
    emit(phase="rough_smile", dtype="float32", n_steps=ROUGH_STEPS, strikes=64,
         max_abs_vs_cpu_f64=err, cpu_f32_max_abs_vs_cpu_f64=cpu_err, gate="2 x cpu f32 error",
         wall_s_runs=walls, rough_heston_smile64_price_s=per, ok=ok)
    if not ok:
        raise AssertionError("rough_heston_smile64_price_s missed its gate")


def phase_rough_calibration(torch, dev, timed_runs=1):
    """bench_full.py:257-281: ``RoughHestonCalibrator(n_steps=96,
    max_iter=40)`` on ``generate_synthetic_surface(n_steps=96)`` (3
    maturities x 9 strikes), float32: one warm call, then one timed call;
    bench_full.py's own gate rmse < 5e-3."""
    from pde_tpu_torch.calibrate.rough import RoughHestonCalibrator

    data = RoughHestonCalibrator.generate_synthetic_surface(n_steps=96, device=dev,
                                                            dtype=torch.float32)
    cal = RoughHestonCalibrator(n_steps=96, max_iter=40, device=dev, dtype=torch.float32)
    res, walls = timed_walls(torch, dev, lambda: cal.calibrate(
        data["strikes"], data["maturities"], data["mid_prices"], data["S0"], data["r"],
        data["q"]), timed_runs)
    ok = res.rmse < 5e-3
    REPEATS_CUT["phase_rough_calibration"] = (statistics.mean(walls), 3 - timed_runs)
    emit(phase="rough_calibration", dtype="float32", n_steps=96, max_iter=40,
         rmse=res.rmse, gate="rmse < 5e-3", n_iter=res.n_iter, converged=res.converged,
         params=list(res.params), true_params=list(data["true_params"]), wall_s_runs=walls,
         rough_heston_surface_calibration_s=statistics.mean(walls), ok=ok)
    if not ok:
        raise AssertionError("rough_heston_surface_calibration_s missed its gate")


def strip_chain(torch, d, dtype):
    """bench_full.py:305-311: 1024 OTM strikes in [0.3F, 3F], T = 0.5,
    priced by ``price_carr_madan`` (puts below F, calls above)."""
    import numpy as np

    from pde_tpu_torch.models import heston

    fwd = S0 * float(np.exp(0.02 * 0.5))
    ks = torch.as_tensor(np.linspace(0.3 * fwd, 3.0 * fwd, STRIP_N), dtype=dtype, device=d)
    q = heston.price_carr_madan(fourier_params(torch, d, dtype, "heston"), ks,
                                torch.tensor(0.5, dtype=dtype, device=d), S0, 0.03, 0.01,
                                is_call=ks > fwd)
    return ks, q, fwd


def phase_varswap_strip(torch, dev, reps=50):
    """bench_full.py:305-317: ``strip_variance`` on the 1024-quote chain,
    float32, held at 1e-6 relative against float64 on the CPU of the same
    quotes (the row times the strip, not the pricing of its quotes; the
    float32 chain's own distance from the float64 chain is printed)."""
    from pde_tpu_torch.models import varswap

    cpu = torch.device("cpu")
    ks, q, fwd = strip_chain(torch, dev, torch.float32)
    fn = lambda: varswap.strip_variance(ks, q, fwd, 0.5, 0.03)  # noqa: E731
    card = float(fn())
    ref = float(varswap.strip_variance(ks.cpu().double(), q.cpu().double(), fwd, 0.5, 0.03))
    ref_chain = float(varswap.strip_variance(*strip_chain(torch, cpu, torch.float64), 0.5,
                                             0.03))
    rel = abs(card - ref) / abs(ref)
    per_call_ms = time_ms(torch, fn, reps)
    ok = rel <= STRIP_REL
    emit(phase="varswap_strip", dtype="float32", n=STRIP_N, strip_variance=card,
         rel_vs_cpu_f64_same_quotes=rel, gate=STRIP_REL,
         rel_vs_cpu_f64_chain=abs(card - ref_chain) / abs(ref_chain),
         per_call_ms=per_call_ms, varswap_strip_evals_per_sec=1.0 / (per_call_ms * 1e-3),
         ok=ok)
    if not ok:
        raise AssertionError("varswap_strip_evals_per_sec missed its gate")


def phase_volswap(torch, dev, reps=50):
    """bench_full.py:318-320: ``fair_volatility_strike`` on the Bates set at
    T = 0.5 (128 nodes), float32, held at 1e-6 relative against float64 on
    the CPU."""
    from pde_tpu_torch.models import varswap

    cpu = torch.device("cpu")
    p32 = fourier_params(torch, dev, torch.float32, "bates")
    T32 = torch.tensor(0.5, dtype=torch.float32, device=dev)
    fn = lambda: varswap.fair_volatility_strike(p32, T32)  # noqa: E731
    card = float(fn())
    ref = float(varswap.fair_volatility_strike(
        fourier_params(torch, cpu, torch.float64, "bates"), torch.tensor(0.5, dtype=torch.float64)))
    rel = abs(card - ref) / abs(ref)
    per_call_ms = time_ms(torch, fn, reps)
    ok = rel <= VOLSWAP_REL
    emit(phase="volswap", dtype="float32", strike=card, rel_vs_cpu_f64=rel, gate=VOLSWAP_REL,
         per_call_ms=per_call_ms, volswap_exact_strike_s=per_call_ms * 1e-3, ok=ok)
    if not ok:
        raise AssertionError("volswap_exact_strike_s missed its gate")


def two_asset_book(torch, d, dtype):
    """bench_full.py:322-347: 4096 strikes in [-15, 25] against 8
    correlations in [-0.5, 0.9], tiled."""
    import numpy as np

    t = lambda a: torch.as_tensor(a, dtype=dtype, device=d)  # noqa: E731
    return (t(np.linspace(-15.0, 25.0, TWO_ASSET_N)),
            t(np.tile(np.linspace(-0.5, 0.9, 8), TWO_ASSET_N // 8)))


TWO_ASSET = dict(spot1=100.0, spot2=96.0, maturity=0.9, vol1=0.25, vol2=0.35, rate=0.03,
                 div1=0.01, div2=0.02)


def phase_spread_quad(torch, dev, reps=50):
    """bench_full.py:322-339: ``spread_price_quad`` (128 nodes) over the
    4096 (K, rho) quotes in one call."""
    from pde_tpu_torch.models import multi_asset

    ks, rho = two_asset_book(torch, dev, torch.float32)
    ks64, rho64 = two_asset_book(torch, torch.device("cpu"), torch.float64)
    pricing_row(torch, dev, "spread_quad_prices_per_sec", TWO_ASSET_N,
                lambda: multi_asset.spread_price_quad(strike=ks, rho=rho, **TWO_ASSET),
                multi_asset.spread_price_quad(strike=ks64, rho=rho64, **TWO_ASSET), reps)


def phase_rainbow(torch, dev, reps=50):
    """bench_full.py:341-347: ``rainbow_two_asset_price(kind="call_on_min")``
    over the same 4096 quotes, strikes |K| + 80, in one call."""
    from pde_tpu_torch.models import multi_asset

    ks, rho = two_asset_book(torch, dev, torch.float32)
    ks64, rho64 = two_asset_book(torch, torch.device("cpu"), torch.float64)
    pricing_row(torch, dev, "rainbow_stulz_prices_per_sec", TWO_ASSET_N,
                lambda: multi_asset.rainbow_two_asset_price(
                    strike=ks.abs() + 80.0, rho=rho, kind="call_on_min", **TWO_ASSET),
                multi_asset.rainbow_two_asset_price(
                    strike=ks64.abs() + 80.0, rho=rho64, kind="call_on_min", **TWO_ASSET),
                reps)


FOURIER_PHASES = (phase_bates_pricing, phase_digital_pricing, phase_forward_start,
                  phase_rough_smile, phase_rough_calibration, phase_varswap_strip,
                  phase_volswap, phase_spread_quad, phase_rainbow)


def rates_curve(torch, d, dtype):
    """bench_full.py:425-428's zero curve on ``d`` in ``dtype``."""
    from pde_tpu_torch.models import rates

    t = lambda a: torch.tensor(a, dtype=dtype, device=d)  # noqa: E731
    return rates.curve_from_zero_rates(t(RATES_TIMES), t(RATES_ZEROS))


def swaption_panel(torch, d, dtype, model, n, **kw):
    """bench_full.py:431-441 (HW) and 493-505 (G2): ``n`` expiries in [0.5,
    10], each into 10 semi-annual pay dates at its par strike, priced as one
    broadcast panel (expiries (n,), pay dates (n, 10)); the par strikes are
    part of the timed call, as in the bench."""
    from pde_tpu_torch.models import g2, rates

    curve = rates_curve(torch, d, dtype)
    t = lambda a: torch.tensor(a, dtype=dtype, device=d)  # noqa: E731
    ex = torch.linspace(0.5, 10.0, n, dtype=dtype, device=d)
    pay = ex[:, None] + torch.arange(1, 11, dtype=dtype, device=d) * 0.5
    if model == "hw":
        p = rates.HullWhiteParams(*map(t, HW), curve)
        return lambda: rates.hw_swaption(p, rates.hw_swap_rate(curve, ex, pay), ex, pay)
    p = g2.G2Params(*map(t, G2), curve)
    return lambda: g2.g2_swaption(p, rates.hw_swap_rate(curve, ex, pay), ex, pay, **kw)


def card_gate(card, ref, cpu32):
    """float32 on the card against float64 on the CPU (``ref``), by the gate
    the CPU's own float32 run (``cpu32``) meets: within PANEL_ATOL +
    PANEL_RTOL |p| where that run is, else within twice that run's largest
    error.  Returns the fields to print and whether it held."""
    ref = ref.double()
    limit = PANEL_ATOL + PANEL_RTOL * ref.abs()
    err = (card.detach().cpu().double() - ref).abs()
    cpu_err = (cpu32.detach().double() - ref).abs()
    fields = dict(max_abs_vs_cpu_f64=float(err.max()), max_over_limit=float((err / limit).max()),
                  cpu_f32_max_abs_vs_cpu_f64=float(cpu_err.max()))
    if bool((cpu_err <= limit).all()):
        return dict(fields, gate=f"{PANEL_ATOL} + {PANEL_RTOL} |p|"), bool((err <= limit).all())
    return (dict(fields, gate="2 x cpu f32 error"),
            float(err.max()) <= 2.0 * float(cpu_err.max()))


def panel_phase(torch, dev, row, model, n, reps, **kw):
    """Time the panel on the card (median of ``reps`` warm calls) and hold
    it against the port's float64 run on the CPU by :func:`card_gate`."""
    cpu = torch.device("cpu")
    ref = swaption_panel(torch, cpu, torch.float64, model, n, **kw)()
    cpu32 = swaption_panel(torch, cpu, torch.float32, model, n, **kw)()
    card, walls = timed_walls(torch, dev, swaption_panel(torch, dev, torch.float32, model, n,
                                                         **kw), reps)
    fields, ok = card_gate(card, ref, cpu32)
    ok = ok and bool(torch.isfinite(card).all()) and bool((card > 0).all())
    per = statistics.median(walls)
    emit(phase=row, dtype="float32", n=n, **fields, median_call_s=per, **{row: n / per}, ok=ok)
    if not ok:
        raise AssertionError(f"{row} missed its gate")


def phase_hw_swaption_panel(torch, dev, reps=50):
    """bench_full.py:431-441: 256 Jamshidian swaptions, median of 50."""
    panel_phase(torch, dev, "hw_swaption_panel_prices_per_sec", "hw", HW_PANEL_N, reps)


def phase_g2_swaption_panel(torch, dev, reps=20):
    """bench_full.py:493-505: 128 G2++ swaptions at 64 Gauss-Hermite
    nodes, median of 20."""
    panel_phase(torch, dev, "g2_swaption_panel_prices_per_sec", "g2", G2_PANEL_N, reps,
                n_gh=64)


def hw_caplet_desk(torch, d, dtype):
    """bench_full.py:443-456: 16 ATM caplets, starts 0.5-8.0, each 0.5 long,
    quoted by HW(0.1, 0.012)."""
    from pde_tpu_torch.models import rates

    curve = rates_curve(torch, d, dtype)
    starts = torch.arange(1, 17, dtype=dtype, device=d) * 0.5
    ends = starts + 0.5
    ks = curve.forward(starts, ends)
    hw = rates.HullWhiteParams(*(torch.tensor(v, dtype=dtype, device=d) for v in HW), curve)
    return curve, starts, ends, ks, rates.hw_caplet(hw, ks, starts, ends)


def phase_hw_caplet_calibration(torch, dev, timed_runs=5):
    """bench_full.py:443-456: ``HullWhiteCalibrator(max_iter=60)`` on the
    16-caplet strip, one warm fit, then the mean of 5; rmse <= 1e-4 and
    sigma within 1% of 0.012."""
    from pde_tpu_torch.calibrate.rates import HullWhiteCalibrator

    desk = hw_caplet_desk(torch, dev, torch.float32)
    cal = HullWhiteCalibrator(max_iter=60, device=dev, dtype=torch.float32)
    res, walls = timed_walls(torch, dev, lambda: cal.calibrate_caplets(*desk), timed_runs)
    a, sigma = float(res.params.a), float(res.params.sigma)
    ok = res.rmse <= 1e-4 and abs(sigma / HW[1] - 1.0) <= 0.01
    emit(phase="hw_caplet_calibration", dtype="float32", n_caplets=16, max_iter=60,
         rmse=res.rmse, max_rel_error=res.max_rel_error, a=a, sigma=sigma,
         converged=res.converged, n_iter=res.n_iter, gate="rmse <= 1e-4, sigma within 1%",
         wall_s_runs=walls, hw_caplet_calibration_wall_s=statistics.mean(walls), ok=ok)
    if not ok:
        raise AssertionError("hw_caplet_calibration_wall_s missed its gate")


def g2_swaption_desk(torch, d, dtype, truth=G2, n_gh=64):
    """bench_full.py:507-517 (and tests/test_calibrate.py:440-452 with its
    own truth): 4 swaptions, expiries 1, 2, 3, 5, each paying e + 0.5 ...
    e + 3, at their par strikes, quoted by G2 ``truth``."""
    import numpy as np

    from pde_tpu_torch.models import g2, rates

    curve = rates_curve(torch, d, dtype)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=d)  # noqa: E731
    exps = [1.0, 2.0, 3.0, 5.0]
    pts = [t(np.arange(e + 0.5, e + 3.01, 0.5)) for e in exps]
    ks = [float(rates.hw_swap_rate(curve, e, pt)) for e, pt in zip(exps, pts)]
    p = g2.G2Params(*map(t, truth), curve)
    quotes = torch.stack([g2.g2_swaption(p, k, e, pt, n_gh=n_gh)
                          for e, pt, k in zip(exps, pts, ks)])
    return curve, exps, pts, ks, quotes


def phase_g2_swaption_calibration(torch, dev, timed_runs=1):
    """bench_full.py:507-521: ``G2Calibrator(max_iter=60)`` on the 4-swaption
    panel, one timed fit; rmse <= 1e-3 (the five parameters are
    under-identified by 4 quotes, tests/test_g2.py:164-167), after one warm
    fit as every row."""
    from pde_tpu_torch.calibrate.g2 import G2Calibrator

    desk = g2_swaption_desk(torch, dev, torch.float32)
    cal = G2Calibrator(max_iter=60, device=dev, dtype=torch.float32)
    res, walls = timed_walls(torch, dev, lambda: cal.calibrate_swaptions(*desk), timed_runs)
    ok = res.rmse <= 1e-3
    REPEATS_CUT["phase_g2_swaption_calibration"] = (statistics.mean(walls), 3 - timed_runs)
    emit(phase="g2_swaption_calibration", dtype="float32", n_swaptions=4, max_iter=60,
         rmse=res.rmse, max_rel_error=res.max_rel_error,
         params=[float(v) for v in res.params[:5]], converged=res.converged,
         n_iter=res.n_iter, gate="rmse <= 1e-3", wall_s_runs=walls,
         g2_swaption_calibration_wall_s=statistics.mean(walls), ok=ok)
    if not ok:
        raise AssertionError("g2_swaption_calibration_wall_s missed its gate")


def cds_bootstrap(torch, d, dtype):
    from pde_tpu_torch.models import credit

    curve = rates_curve(torch, d, dtype)
    spreads = torch.tensor(CDS_SPREADS, dtype=dtype, device=d)
    return curve, lambda: credit.bootstrap_hazard(curve, CDS_PILLARS, spreads)


def phase_cds_bootstrap(torch, dev, timed_runs=3):
    """bench_full.py:527-538: the 5-pillar hazard bootstrap, one warm call,
    then the mean of 3: every hazard positive, the pillars repriced within
    5e-4 relative, the hazards within 1e-4 relative of float64 on the CPU."""
    from pde_tpu_torch.models import credit

    curve, fn = cds_bootstrap(torch, dev, torch.float32)
    (hc, hazards), walls = timed_walls(torch, dev, fn, timed_runs)
    ref = cds_bootstrap(torch, torch.device("cpu"), torch.float64)[1]()[1]
    reprice = credit.cds_par_spreads(curve, hc, CDS_PILLARS).cpu().double()
    hz = hazards.cpu().double()
    reprice_rel = float((reprice / torch.tensor(CDS_SPREADS, dtype=torch.float64) - 1).abs().max())
    hazard_rel = float((hz / ref - 1.0).abs().max())
    ok = (bool((hz > 0).all()) and reprice_rel <= CDS_REPRICE_REL
          and hazard_rel <= CDS_HAZARD_REL)
    emit(phase="cds_bootstrap", dtype="float32", pillars=list(CDS_PILLARS),
         hazards=hz.tolist(), reprice_max_rel=reprice_rel, hazards_max_rel_vs_cpu_f64=hazard_rel,
         gate=f"hazards > 0, reprice {CDS_REPRICE_REL}, hazards {CDS_HAZARD_REL} of f64",
         wall_s_runs=walls, cds_bootstrap_5pillar_wall_s=statistics.mean(walls), ok=ok)
    if not ok:
        raise AssertionError("cds_bootstrap_5pillar_wall_s missed its gate")


def phase_orchestrator_rates(torch, dev):
    """``CalibrationOrchestrator.run_daily_calibration`` on the card with
    the rates, G2 and credit stages, on the desks of
    tests/test_calibrate.py:418-482 (HW(0.12, 0.011) caplets 0.5-5.0, the
    4-swaption G2 panel, 4 CDS pillars) with that test's calibrators
    (HW 40, G2 25 LM iterations), float32: SUCCESS with no error, every
    stage's result present."""
    from pde_tpu_torch.calibrate.g2 import G2Calibrator
    from pde_tpu_torch.calibrate.orchestrator import (CalibrationConfig,
                                                      CalibrationOrchestrator,
                                                      CalibrationStatus)
    from pde_tpu_torch.calibrate.rates import HullWhiteCalibrator
    from pde_tpu_torch.models import rates

    f32 = torch.float32
    curve = rates_curve(torch, dev, f32)
    starts = torch.arange(1, 11, dtype=f32, device=dev) * 0.5
    ends = starts + 0.5
    ks = curve.forward(starts, ends)
    hw = rates.HullWhiteParams(torch.tensor(0.12, device=dev), torch.tensor(0.011, device=dev),
                               curve)
    _, exps, pts, g2_ks, g2_quotes = g2_swaption_desk(torch, dev, f32,
                                                      truth=(0.5, 0.05, 0.011, 0.0085, -0.55))
    rates_market = {"curve": curve,
                    "caplets": {"starts": starts, "ends": ends, "strikes": ks,
                                "quotes": rates.hw_caplet(hw, ks, starts, ends)},
                    "swaptions": {"expiries": exps, "pay_times": pts, "strikes": g2_ks,
                                  "quotes": g2_quotes}}
    credit_market = {"curve": curve, "pillars": [1.0, 3.0, 5.0, 10.0],
                     "spreads": [0.008, 0.011, 0.013, 0.015], "recovery": 0.4}
    orch = CalibrationOrchestrator(
        config=CalibrationConfig(calibrate_heston=False, calibrate_sabr=False,
                                 calibrate_rates=True, calibrate_g2=True,
                                 calibrate_credit=True),
        rates_calibrator=HullWhiteCalibrator(max_iter=40, device=dev, dtype=f32),
        g2_calibrator=G2Calibrator(max_iter=25, device=dev, dtype=f32), device=dev, dtype=f32)
    res = orch.run_daily_calibration("USD", {"strike": []}, S0=100.0,
                                     rates_market=rates_market, credit_market=credit_market)
    ok = (res.status == CalibrationStatus.SUCCESS and res.errors == []
          and None not in (res.rates_result, res.g2_result, res.credit_result))
    emit(phase="orchestrator_rates", dtype="float32", status=str(res.status.value),
         errors=res.errors, run_time_s=res.run_time,
         hw=dict(a=float(res.rates_result.params.a), sigma=float(res.rates_result.params.sigma),
                 max_rel_error=res.rates_result.max_rel_error) if res.rates_result else None,
         g2_max_rel_error=res.g2_result.max_rel_error if res.g2_result else None,
         credit_max_roundtrip_error=(res.credit_result or {}).get("max_roundtrip_error"),
         ok=ok)
    if not ok:
        raise AssertionError(f"the daily orchestrator run was {res.status.value}: {res.errors}")


RATES_PHASES = (phase_hw_swaption_panel, phase_hw_caplet_calibration, phase_g2_swaption_panel,
                phase_g2_swaption_calibration, phase_cds_bootstrap, phase_orchestrator_rates)


# the Heston Monte Carlo rows (bench_full.py:673-759), float32 on the card,
# Heston TRUE from S0 = 100 to T = 1: QE paths x steps, the LSM path count,
# the 128-strike LSM book, the dual bound's dates and path counts, the
# 16-strike Greeks; every MC gate at MC_Z standard errors
MC_PATHS, MC_STEPS, LSM_PATHS, LSM_BOOK = 1 << 17, 64, 1 << 16, 128
DUAL = dict(n_steps=12, n_reg_paths=1 << 15, n_outer=1024, n_inner=64)
MC_Z, QE_CALL_REL, LSM_ADI_REL, GREEKS_DELTA_ATOL = 4.0, 2e-3, 0.02, 0.02
LSM_BOOK_PICKS = (0, 43, 86, 127)


def cpu_replay(torch, seed):
    """A replay of a CPU generator's draws: made once, in the dtype and on
    the device of the first run that asks, then handed to every later run
    (moved to its dtype and device)."""
    from pde_tpu_torch.models import heston_mc

    cpu = torch.device("cpu")
    return heston_mc._Replay(heston_mc._draws(torch.Generator().manual_seed(seed), cpu))


def phase_heston_mc_qe(torch, dev, reps=20):
    """bench_full.py:680-688: ``simulate_qe`` of 2^17 paths x 64 steps (r
    0.05, q 0.02), median of 20 warm calls.  The discounted spot is a
    martingale within 4 s.e.; the call from the paths is within 4 s.e. +
    0.2% of ``price_accurate``; and on one replay of a CPU generator's
    float64 draws, the card's terminal state sits within twice the CPU's
    own float32 error of the CPU's float64 run."""
    from pde_tpu_torch.models import heston, heston_mc

    cpu = torch.device("cpu")
    kw = dict(n_steps=MC_STEPS, n_paths=MC_PATHS, rate=R, dividend=Q)
    p32 = fourier_params(torch, dev, torch.float32, "heston")
    gen = torch.Generator(device=dev).manual_seed(0)
    paths, walls = timed_walls(torch, dev, lambda: heston_mc.simulate_qe(
        p32, S0, 1.0, gen, **kw), reps)
    spot = paths.spot.double()
    disc = float(torch.exp(torch.tensor(-R, dtype=torch.float64)))
    mean, se = (float(x) for x in heston_mc._mc_estimate(disc * spot, MC_PATHS, True))
    fwd = S0 * float(torch.exp(torch.tensor(-Q, dtype=torch.float64)))
    call, call_se = (float(x) for x in heston_mc._mc_estimate(
        disc * (spot - S0).clamp_min(0.0), MC_PATHS, True))
    exact = float(heston.price_accurate(fourier_params(torch, cpu, torch.float64, "heston"),
                                        torch.tensor(S0, dtype=torch.float64), 1.0, S0, R, Q))
    replay = cpu_replay(torch, 1)
    ref, cpu32 = (heston_mc.simulate_qe(fourier_params(torch, cpu, dt, "heston"), S0, 1.0,
                                        replay, **kw) for dt in (torch.float64, torch.float32))
    card = heston_mc.simulate_qe(p32, S0, 1.0, replay, **kw)
    errs = {f: (float((getattr(card, f).cpu().double() - getattr(ref, f)).abs().max()),
                float((getattr(cpu32, f).double() - getattr(ref, f)).abs().max()))
            for f in ("spot", "variance")}
    ok = (abs(mean - fwd) <= MC_Z * se
          and abs(call - exact) <= MC_Z * call_se + QE_CALL_REL * exact
          and all(e <= 2.0 * c for e, c in errs.values())
          and bool(torch.isfinite(spot).all()))
    per = statistics.median(walls)
    emit(phase="heston_mc_qe", dtype="float32", n_paths=MC_PATHS, n_steps=MC_STEPS,
         discounted_mean_spot=mean, forward=fwd, martingale_se=se, call=call, call_se=call_se,
         call_price_accurate=exact,
         terminal_max_abs_vs_cpu_f64={f: e for f, (e, _) in errs.items()},
         cpu_f32_max_abs_vs_cpu_f64={f: c for f, (_, c) in errs.items()},
         gate=f"martingale {MC_Z} se; call {MC_Z} se + {QE_CALL_REL}; 2 x cpu f32 error",
         wall_s_runs=walls, median_call_s=per,
         heston_mc_qe_pathsteps_per_sec=MC_PATHS * MC_STEPS / per, ok=ok)
    if not ok:
        raise AssertionError("heston_mc_qe_pathsteps_per_sec missed its gate")


def adi_american_put(torch):
    """tests/test_lsm.py:25-43: the port's IT-LCP American put (K 100, r
    0.05, q 0, T 1) at the reference's default 100x50x100 grid, float64 on
    the CPU (the scan route launches no kernel there)."""
    from pde_tpu_torch.solvers import heston_adi

    hp = heston_adi.HestonPDEParams(**TRUE, r=R, q=0.0, T=1.0, K=100.0, is_call=False,
                                    american=True, american_method="it_lcp")
    return float(heston_adi.solve(hp, S0, device="cpu", dtype=torch.float64).price)


def phase_lsm_american(torch, dev, reps=10):
    """bench_full.py:690-701: ``price_american_lsm`` of the ATM put (r 0.05)
    on 2^16 paths x 64 steps, median of 10 warm calls: within max(2%, 5 s.e.)
    of the IT-LCP put, and above the European MC put on its own paths less
    4 s.e."""
    from pde_tpu_torch.models import heston_mc
    from pde_tpu_torch.solvers import lsm

    kw = dict(rate=R, n_steps=MC_STEPS, n_paths=LSM_PATHS)
    p32 = fourier_params(torch, dev, torch.float32, "heston")
    gen = torch.Generator(device=dev).manual_seed(2)
    (price, se), walls = timed_walls(torch, dev, lambda: lsm.price_american_lsm(
        p32, 100.0, 1.0, S0, gen, is_call=False, **kw), reps)
    price, se = float(price), float(se)
    euro, euro_se = (float(x) for x in heston_mc.price_european_mc(
        p32, 100.0, 1.0, S0, gen, is_call=False, **kw))
    adi = adi_american_put(torch)
    ok = (abs(price - adi) <= max(LSM_ADI_REL * adi, 5.0 * se)
          and price >= euro - MC_Z * (se * se + euro_se * euro_se) ** 0.5)
    per = statistics.median(walls)
    emit(phase="lsm_american", dtype="float32", n_paths=LSM_PATHS, n_steps=MC_STEPS,
         price=price, stderr=se, adi_it_lcp_f64=adi, european_mc=euro, european_se=euro_se,
         gate=f"|lsm - adi| <= max({LSM_ADI_REL} adi, 5 se); lsm >= european - {MC_Z} se",
         wall_s_runs=walls, heston_american_lsm_solve_s=per, ok=ok)
    if not ok:
        raise AssertionError("heston_american_lsm_solve_s missed its gate")


def lsm_book(torch, d, dtype):
    k = torch.linspace(70.0, 130.0, LSM_BOOK, dtype=dtype, device=d)
    return k, torch.arange(LSM_BOOK, device=d) % 2 == 0


def phase_lsm_batch(torch, dev, reps=5):
    """bench_full.py:703-717: ``price_american_lsm_batch`` on 128 strikes in
    [70, 130], calls at even indices, 2^16 paths x 64 steps, median of 5
    warm calls; call prices fall with strike.  On one replay of a CPU
    generator's draws, the book's entries at 4 strikes against
    ``price_american_lsm`` on the card: in float64 at 1e-10 relative (the
    CPU's float64 shows ~1e-14), in float32 within twice the float32
    tolerance the CPU shows on those draws (the largest float32 move, from
    float64, of the CPU's book and single prices at the 4 strikes), or a
    quarter of the entry's standard error where that is larger: float32
    moves an LSM price only by flipping exercise decisions at near ties, a
    noise of at most 0.17 s.e., and up to 1.98 times the CPU's tolerance,
    in 14 seeds on the CPU (``scripts/torch_lsm_f32_noise.py``)."""
    from pde_tpu_torch.solvers import lsm

    cpu = torch.device("cpu")
    kw = dict(rate=R, n_steps=MC_STEPS, n_paths=LSM_PATHS)
    p32 = fourier_params(torch, dev, torch.float32, "heston")
    gen = torch.Generator(device=dev).manual_seed(3)
    k, calls = lsm_book(torch, dev, torch.float32)
    (prices, _), walls = timed_walls(torch, dev, lambda: lsm.price_american_lsm_batch(
        p32, k, calls, 1.0, S0, gen, **kw), reps)
    falls = bool((torch.diff(prices[calls].cpu()) < 0).all())

    replay, picks = cpu_replay(torch, 4), list(LSM_BOOK_PICKS)

    def book_and_singles(d, dtype, full):
        """(book, single prices, the book's s.e.) at the picks: on the full
        book, or on a book of the 4 picked contracts."""
        p = fourier_params(torch, d, dtype, "heston")
        bk, bc = lsm_book(torch, d, dtype)
        rows = picks
        if not full:
            bk, bc, rows = bk[picks], bc[picks], list(range(len(picks)))
        book, book_se = lsm.price_american_lsm_batch(p, bk, bc, 1.0, S0, replay, **kw)
        single = torch.stack([lsm.price_american_lsm(p, float(bk[r]), 1.0, S0, replay,
                                                     is_call=bool(bc[r]), **kw)[0]
                              for r in rows])
        return (book[rows].cpu().double(), single.cpu().double(),
                book_se[rows].cpu().double())

    b64, s64, _ = book_and_singles(cpu, torch.float64, False)
    b32, s32, _ = book_and_singles(cpu, torch.float32, False)
    cpu_tol = max(float((b32 - b64).abs().max()), float((s32 - s64).abs().max()))
    card64 = book_and_singles(dev, torch.float64, True)
    card32 = book_and_singles(dev, torch.float32, True)
    rel64 = float(((card64[0] - card64[1]).abs() / card64[1].abs()).max())
    gap32 = (card32[0] - card32[1]).abs()
    tol32 = torch.clamp_min(0.25 * card32[2], 2.0 * cpu_tol)
    ok = (falls and rel64 <= 1e-10 and bool((gap32 <= tol32).all())
          and bool(torch.isfinite(prices).all()))
    per = statistics.median(walls)
    emit(phase="lsm_batch", dtype="float32", n_paths=LSM_PATHS, n_steps=MC_STEPS,
         book=LSM_BOOK, call_prices_fall=falls, picks=picks,
         book_vs_single_card_f64_max_rel=rel64, book_vs_single_card_f32=gap32.tolist(),
         cpu_f32_tolerance=cpu_tol, card_f32_limit=tol32.tolist(),
         gate="calls fall; card f64 book = single at 1e-10; card f32 within "
              "max(2 x cpu f32 tolerance, 0.25 se)",
         wall_s_runs=walls, heston_american_lsm_batch128_options_per_sec=LSM_BOOK / per,
         ok=ok)
    if not ok:
        raise AssertionError("heston_american_lsm_batch128_options_per_sec missed its gate")


def phase_lsm_dual(torch, dev, reps=3):
    """bench_full.py:719-732: ``dual_upper_bound`` of the ATM put, 12 dates,
    2^15 regression paths, 1024 x 64 outer x inner paths, median of 3 warm
    calls: upper + 4 s.e. >= lower - 4 s.e. and a gap under 4% + 4 s.e.
    (tests/test_lsm_dual.py:34-37)."""
    from pde_tpu_torch.solvers import lsm_dual

    p32 = fourier_params(torch, dev, torch.float32, "heston")
    gen = torch.Generator(device=dev).manual_seed(5)
    out, walls = timed_walls(torch, dev, lambda: lsm_dual.dual_upper_bound(
        p32, 100.0, 1.0, S0, gen, rate=R, is_call=False, **DUAL), reps)
    lo, sel, up, seu = (float(x) for x in out)
    ok = (up + MC_Z * seu >= lo - MC_Z * sel and up - lo < 0.04 * lo + MC_Z * (sel + seu)
          and all(map(math.isfinite, (lo, sel, up, seu))))
    per = statistics.median(walls)
    emit(phase="lsm_dual", dtype="float32", **DUAL, lower=lo, se_lower=sel, upper=up,
         se_upper=seu, gate="upper + 4 se >= lower - 4 se; gap < 4% + 4 se",
         wall_s_runs=walls, lsm_dual_sandwich_wall_s=per,
         lsm_dual_gap_pct=100.0 * (up - lo) / max(lo, 1e-12), ok=ok)
    if not ok:
        raise AssertionError("lsm_dual_sandwich_wall_s missed its gate")


def phase_mc_greeks(torch, dev, reps=5):
    """bench_full.py:750-759: ``greeks_european_mc`` on 16 strikes in [80,
    120] (r 0.05, q 0.02), 2^16 paths x 64 steps, median of 5 warm calls:
    delta within 0.02 of ``heston.greeks_ad`` (float64, CPU;
    tests/test_exotics_mc.py:137)."""
    from pde_tpu_torch.models import heston, heston_mc

    cpu = torch.device("cpu")
    p32 = fourier_params(torch, dev, torch.float32, "heston")
    gen = torch.Generator(device=dev).manual_seed(6)
    k = torch.linspace(80.0, 120.0, 16, device=dev)
    g, walls = timed_walls(torch, dev, lambda: heston_mc.greeks_european_mc(
        p32, k, 1.0, S0, gen, rate=R, dividend=Q, n_steps=MC_STEPS, n_paths=LSM_PATHS), reps)
    # one spot per strike: greeks_ad's delta has its spot's shape
    k64 = k.cpu().double()
    exact = heston.greeks_ad(fourier_params(torch, cpu, torch.float64, "heston"), k64, 1.0,
                             torch.full_like(k64, S0), R, Q)["delta"]
    err = float((g["delta"].cpu().double() - exact).abs().max())
    ok = err <= GREEKS_DELTA_ATOL and all(bool(torch.isfinite(v).all()) for v in g.values())
    per = statistics.median(walls)
    emit(phase="mc_greeks", dtype="float32", strikes=16, n_paths=LSM_PATHS, n_steps=MC_STEPS,
         delta_max_abs_vs_greeks_ad=err, gate=GREEKS_DELTA_ATOL, wall_s_runs=walls,
         heston_mc_ad_greeks_16strike_s=per, ok=ok)
    if not ok:
        raise AssertionError("heston_mc_ad_greeks_16strike_s missed its gate")


def phase_sobol_european(torch, dev):
    """A randomized-QMC European (Sobol, 8 replicates of 8192 paths x 64
    steps, calls at 90, 100, 110): within 4 s.e. of ``price_accurate``."""
    from pde_tpu_torch.models import heston, heston_mc

    cpu = torch.device("cpu")
    k = [90.0, 100.0, 110.0]
    t0 = time.perf_counter()
    price, se = heston_mc.price_european_mc(
        fourier_params(torch, dev, torch.float32, "heston"), k, 1.0, S0,
        torch.Generator(device=dev).manual_seed(7),
        rate=R, dividend=Q, n_steps=MC_STEPS, n_paths=LSM_PATHS, antithetic=False,
        sampler="sobol", n_replicates=8)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    exact = heston.price_accurate(fourier_params(torch, cpu, torch.float64, "heston"),
                                  torch.tensor(k, dtype=torch.float64), 1.0, S0, R, Q)
    err = (price.cpu().double() - exact).abs()
    ok = bool((err <= MC_Z * se.cpu().double()).all())
    emit(phase="sobol_european", dtype="float32", replicates=8, n_paths=LSM_PATHS,
         n_steps=MC_STEPS, price=price.tolist(), stderr=se.tolist(),
         price_accurate=exact.tolist(), gate=f"{MC_Z} se", wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("the Sobol European missed its gate")


def phase_bates_american(torch, dev):
    """Bates' ``price_american_mc`` (LSM on the jump paths) of the ATM put,
    2^16 paths x 64 steps: at least the Bates European put
    (``price_accurate``, float64 on the CPU) less 4 s.e."""
    from pde_tpu_torch.models import bates

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    price, se = bates.price_american_mc(
        fourier_params(torch, dev, torch.float32, "bates"), 100.0, 1.0, S0,
        torch.Generator(device=dev).manual_seed(8), rate=R, is_call=False, n_steps=MC_STEPS,
        n_paths=LSM_PATHS)
    price, se = float(price), float(se)
    wall = time.perf_counter() - t0
    euro = float(bates.price_accurate(fourier_params(torch, cpu, torch.float64, "bates"),
                                      torch.tensor(S0, dtype=torch.float64), 1.0, S0, R, 0.0,
                                      is_call=False))
    ok = price >= euro - MC_Z * se and math.isfinite(price)
    emit(phase="bates_american", dtype="float32", n_paths=LSM_PATHS, n_steps=MC_STEPS,
         price=price, stderr=se, european_price_accurate=euro, gate=f"european - {MC_Z} se",
         wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("the Bates American missed its gate")


MC_PHASES = (phase_heston_mc_qe, phase_lsm_american, phase_lsm_batch, phase_lsm_dual,
             phase_mc_greeks, phase_sobol_european, phase_bates_american)


# the rest of the Monte Carlo desk (bench_full.py:349-361, 410-419,
# 461-489, 540-564) at the bench's full sizes
BASKET_N, BASKET_REF_N, BASKET_K = 1 << 20, 1 << 21, 16
SLV = dict(n_steps=48, n_paths=65536, n_bins=31, rate=R)
SLV_T, SLV_L = 0.5, (0.05, 20.0)
BERM_SCHED, BERM_LADDER, BERM_NX, BERM_SUB = (1.0, 6.0, 0.5), 64, 257, 16
BERM_STEPS = 160  # 10 intervals x 16 sub-steps: one K5 launch a step
BERM_MC = dict(n_paths=1 << 15, n_outer=512, n_inner=32)
CVA_N, CVA_TRADES = 1 << 16, ((1.0, 1.0, 1.0), (0.9, -1.0, 0.4), (1.1, 1.0, 0.7),
                              (1.05, -1.0, 0.3))
MC_REL = 0.01  # the Euler and kernel-fit bias allowed beside 4 s.e. (rough, local vol)
SANDWICH = {}  # the Bermudan MC sandwich, for the ladder's ATM gate


def basket_book(torch, d, dtype):
    """bench_full.py:349-357: 8 assets, equal weights, spots in [90, 115],
    vols in [0.18, 0.42], a flat 0.45 correlation, 16 strikes in [85, 120]."""
    import numpy as np

    t = lambda a: torch.as_tensor(a, dtype=dtype, device=d)  # noqa: E731
    return (t(np.linspace(90.0, 115.0, 8)), t(np.full(8, 0.125)),
            t(np.linspace(85.0, 120.0, BASKET_K)), t(np.linspace(0.18, 0.42, 8)),
            t(0.45 * np.ones((8, 8)) + 0.55 * np.eye(8)))


def basket_f64_cpu(torch, n, seed, chunk=1 << 19):
    """The basket book's calls by plain float64 Monte Carlo on the CPU (exact
    terminal sampling, antithetic pairs, no control): (price, s.e.)."""
    cpu = torch.device("cpu")
    spots, w, ks, vols, corr = basket_book(torch, cpu, torch.float64)
    L = torch.linalg.cholesky(corr)
    g = torch.Generator().manual_seed(seed)
    drift = (0.03 - 0.5 * vols**2) * 0.9
    df = math.exp(-0.03 * 0.9)
    pairs, chunk = [], min(chunk, n // 2)
    for _ in range(n // (2 * chunk)):
        z = torch.randn((chunk, 8), generator=g, dtype=torch.float64) @ L.T
        legs = [(spots * torch.exp(drift + 0.9**0.5 * vols * sz) @ w)[:, None]
                for sz in (z, -z)]
        pairs.append(0.5 * df * sum(torch.clamp_min(b - ks, 0.0) for b in legs))
    pay = torch.cat(pairs)
    return pay.mean(0), pay.std(0) / math.sqrt(pay.shape[0])


def phase_basket_mc(torch, dev, reps=20):
    """bench_full.py:349-361: ``price_basket_mc`` (two controls) on 2^20
    paths x 8 assets x 16 strikes (T 0.9, r 0.03), median of 20 warm calls.
    Each price within 4 s.e. of a plain float64 run on the CPU on 2^21
    paths, and the controls cut the s.e. against the same call without
    them."""
    from pde_tpu_torch.models import multi_asset

    book = basket_book(torch, dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(42)
    run = lambda cv: multi_asset.price_basket_mc(  # noqa: E731
        gen, book[0], book[1], book[2], 0.9, book[3], book[4], rate=0.03, n_paths=BASKET_N,
        control_variate=cv)
    (price, se), walls = timed_walls(torch, dev, lambda: run(True), reps)
    _, se_raw = run(False)
    ref, ref_se = basket_f64_cpu(torch, BASKET_REF_N, 42)
    price, se, se_raw = (a.cpu().double() for a in (price, se, se_raw))
    z = (price - ref).abs() / torch.sqrt(se**2 + ref_se**2)
    ok = (bool((z <= MC_Z).all()) and bool((se < se_raw).all())
          and bool(torch.isfinite(price).all()))
    per = statistics.median(walls)
    emit(phase="basket_mc", dtype="float32", n_paths=BASKET_N, strikes=BASKET_K,
         price=price.tolist(), stderr=se.tolist(), stderr_without_controls=se_raw.tolist(),
         cpu_f64_price=ref.tolist(), cpu_f64_stderr=ref_se.tolist(), max_z=float(z.max()),
         gate=f"{MC_Z} se of float64 on the CPU; controls cut the se", wall_s_runs=walls,
         basket_mc_cv_paths_per_sec=BASKET_N / per, ok=ok)
    if not ok:
        raise AssertionError("basket_mc_cv_paths_per_sec missed its gate")


def bin_forms_ms(torch, dev, reps=50):
    """One binning of 65,536 particles into 31 bins on the card, both forms:
    the port's one-hot product (``slv._bin_expectation``) and a float32
    ``index_add_`` (atomic order), with the spread of the latter's sums
    over ten runs."""
    from pde_tpu_torch.models import slv

    g = torch.Generator(device=dev).manual_seed(9)
    ln_s = math.log(S0) + 0.2 * torch.randn(SLV["n_paths"], generator=g, device=dev)
    v = 0.04 * torch.rand(SLV["n_paths"], generator=g, device=dev)
    edges = torch.linspace(math.log(S0) - 0.9, math.log(S0) + 0.9, SLV["n_bins"] + 1,
                           device=dev)
    nb = SLV["n_bins"]

    def index_add():
        idx = torch.clamp(torch.searchsorted(edges, ln_s) - 1, 0, nb - 1)
        sums = torch.zeros(2, nb, device=dev)
        sums[0].index_add_(0, idx, torch.ones_like(v))
        sums[1].index_add_(0, idx, v)
        return sums

    one_hot = time_ms(torch, lambda: slv._bin_expectation(ln_s, v, edges, nb), reps)
    atomic = time_ms(torch, index_add, reps)
    runs = torch.stack([index_add()[1] for _ in range(10)])
    return dict(one_hot_ms=one_hot, index_add_ms=atomic,
                index_add_sum_spread=float((runs.max(0).values - runs.min(0).values).max()))


def phase_slv_calibration(torch, dev, reps=20):
    """bench_full.py:410-419: ``calibrate_leverage`` of 65,536 particles x
    48 steps into 31 bins (flat 0.2 target, Heston TRUE, T 0.5, r 0.05),
    median of 20 warm calls: the leverage finite and in [l_min, l_max],
    and the sweep's discounted terminal spot within 4 s.e. of S0 e^{-qT}
    (q 0); with the binning's two forms timed beside it."""
    from pde_tpu_torch.models import heston_mc, slv

    p32 = fourier_params(torch, dev, torch.float32, "heston")
    gen = torch.Generator(device=dev).manual_seed(0)
    (lev, paths), walls = timed_walls(torch, dev, lambda: slv.calibrate_leverage(
        p32, lambda s, t: torch.full_like(s, 0.2), S0, SLV_T, gen, **SLV), reps)
    disc = math.exp(-R * SLV_T)
    mean, se = (float(x) for x in heston_mc._mc_estimate(disc * paths.spot.double(),
                                                          SLV["n_paths"], True))
    vals = lev.values
    ok = (bool(torch.isfinite(vals).all()) and float(vals.min()) >= SLV_L[0]
          and float(vals.max()) <= SLV_L[1] and abs(mean - S0) <= MC_Z * se)
    per = statistics.median(walls)
    emit(phase="slv_calibration", dtype="float32", **SLV, maturity=SLV_T,
         leverage_min=float(vals.min()), leverage_max=float(vals.max()),
         discounted_mean_spot=mean, martingale_se=se, binning=bin_forms_ms(torch, dev),
         gate=f"leverage finite in {list(SLV_L)}; martingale {MC_Z} se", wall_s_runs=walls,
         slv_calibration_particle_steps_per_sec=SLV["n_paths"] * SLV["n_steps"] / per, ok=ok)
    if not ok:
        raise AssertionError("slv_calibration_particle_steps_per_sec missed its gate")


def hw_params(torch, d, dtype):
    from pde_tpu_torch.models import rates

    return rates.HullWhiteParams(*(torch.tensor(v, dtype=dtype, device=d) for v in HW),
                                 rates_curve(torch, d, dtype))


def bermudan_ladder(torch, d, dtype):
    """bench_full.py:461-479: the schedule 1.0 to 6.0 by 0.5, the par rate
    of the swap from 1.0, and 64 strikes in [0.6, 1.4] par: (params,
    schedule, par, strikes)."""
    import numpy as np

    from pde_tpu_torch.models import rates

    p = hw_params(torch, d, dtype)
    lo, hi, step = BERM_SCHED
    sched = torch.as_tensor(np.arange(lo, hi + 0.01, step), dtype=dtype, device=d)
    par = float(rates.hw_swap_rate(p.curve, 1.0, sched[1:]))
    ks = torch.as_tensor(np.linspace(0.6, 1.4, BERM_LADDER) * par, dtype=dtype, device=d)
    return p, sched, par, ks


def ladder_prices(torch, d, dtype, strikes=None):
    from pde_tpu_torch.solvers import bermudan_hw

    p, sched, par, ks = bermudan_ladder(torch, d, dtype)
    return bermudan_hw.bermudan_swaption_pde(p, ks if strikes is None else strikes, sched,
                                             n_x=BERM_NX, n_sub=BERM_SUB)[0]


def phase_hw_bermudan_mc(torch, dev, reps=3):
    """bench_full.py:481-489: ``bermudan_swaption_mc`` of the ATM payer
    (2^15 regression paths, 512 x 32 outer x inner), median of 3 warm
    calls: upper + 4 s.e. >= lower - 4 s.e."""
    from pde_tpu_torch.solvers import bermudan_hw

    p, sched, par, _ = bermudan_ladder(torch, dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(7)
    out, walls = timed_walls(torch, dev, lambda: bermudan_hw.bermudan_swaption_mc(
        p, par, sched, gen, **BERM_MC), reps)
    lo, sel, up, seu = (float(x) for x in out)
    SANDWICH.update(lower=lo, se_lower=sel, upper=up, se_upper=seu)
    ok = up + MC_Z * seu >= lo - MC_Z * sel and all(map(math.isfinite, (lo, sel, up, seu)))
    per = statistics.median(walls)
    emit(phase="hw_bermudan_mc", dtype="float32", **BERM_MC, lower=lo, se_lower=sel,
         upper=up, se_upper=seu, gate=f"upper + {MC_Z} se >= lower - {MC_Z} se",
         wall_s_runs=walls, hw_bermudan_mc_sandwich_wall_s=per,
         hw_bermudan_duality_gap_pct=100.0 * (up - lo) / max(lo, 1e-12), ok=ok)
    if not ok:
        raise AssertionError("hw_bermudan_mc_sandwich_wall_s missed its gate")


def cva_desk(torch, d, dtype):
    """bench_full.py:540-564: four swaps on 0.5 to 5.0 by 0.5 around the
    par rate from 0.5, uneven notionals, a flat 2% hazard."""
    import numpy as np

    from pde_tpu_torch.models import credit, rates

    p = hw_params(torch, d, dtype)
    sched = torch.as_tensor(np.arange(0.5, 5.01, 0.5), dtype=dtype, device=d)
    k = float(rates.hw_swap_rate(p.curve, 0.5, sched[1:]))
    t = lambda a: torch.tensor(a, dtype=dtype, device=d)  # noqa: E731
    trades = [credit.SwapTrade(t(k * m), t(sgn), t(nt)) for m, sgn, nt in CVA_TRADES]
    return p, credit.flat_hazard(t(0.02)), trades, sched


def cva_se(ee_se, dq):
    """A bound on the CVA's s.e.: the dates' EE errors taken as perfectly
    correlated (they share paths)."""
    return 0.6 * float((ee_se * dq).sum())


def phase_cva_netting(torch, dev, reps=5):
    """bench_full.py:540-564: ``cva_netting_hw_mc`` of the four-swap set on
    2^16 paths, median of 5 warm calls: CVA > 0 and within 4 s.e. of the
    port's float64 run on the CPU."""
    from pde_tpu_torch.models import credit

    cpu = torch.device("cpu")
    desk = cva_desk(torch, dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(11)
    (cva, ee, ee_se), walls = timed_walls(torch, dev, lambda: credit.cva_netting_hw_mc(
        *desk, gen, n_paths=CVA_N), reps)
    desk64 = cva_desk(torch, cpu, torch.float64)
    ref, _, ref_se = credit.cva_netting_hw_mc(*desk64, torch.Generator().manual_seed(11),
                                              n_paths=CVA_N)
    q = desk64[1].q(desk64[3])
    dq = q[:-1] - q[1:]
    se = math.hypot(cva_se(ee_se.cpu().double(), dq), cva_se(ref_se, dq))
    cva, ref = float(cva), float(ref)
    ok = cva > 0.0 and abs(cva - ref) <= MC_Z * se and math.isfinite(cva)
    per = statistics.median(walls)
    emit(phase="cva_netting", dtype="float32", n_paths=CVA_N, trades=len(CVA_TRADES),
         cva=cva, cpu_f64_cva=ref, combined_se=se, ee=ee.tolist(),
         gate=f"cva > 0; {MC_Z} se of float64 on the CPU", wall_s_runs=walls,
         cva_netting4_wall_s=per, ok=ok)
    if not ok:
        raise AssertionError("cva_netting4_wall_s missed its gate")


def phase_rough_mc(torch, dev):
    """The lifted rough engine at its defaults, float32 on the card: the
    European (256 steps, 2^16 paths, strikes 90 and 100, T 0.25) within 4
    s.e. + 1% of ``price_rough`` (float64 on the CPU), and the American put
    by LSM (128 steps; K 100, T 0.5, r 0.05) at least its European less 4
    s.e."""
    from pde_tpu_torch.models import rough_heston, rough_heston_mc

    cpu = torch.device("cpu")
    p32 = fourier_params(torch, dev, torch.float32, "rough")
    gen = torch.Generator(device=dev).manual_seed(12)
    t0 = time.perf_counter()
    k = [90.0, 100.0]
    mc, se = rough_heston_mc.price_european_rough_mc(p32, k, 0.25, S0, gen, rate=0.03)
    cf = rough_heston.price_rough(fourier_params(torch, cpu, torch.float64, "rough"),
                                  torch.tensor(k, dtype=torch.float64), 0.25, S0, 0.03, 0.0,
                                  n_steps=256)
    mc, se = mc.cpu().double(), se.cpu().double()
    euro_ok = bool(((mc - cf).abs() <= MC_Z * se + MC_REL * cf).all())
    amer, amer_se = (float(x) for x in rough_heston_mc.price_american_rough_lsm(
        p32, 100.0, 0.5, S0, gen, rate=0.05))
    eur, eur_se = (float(x) for x in rough_heston_mc.price_european_rough_mc(
        p32, 100.0, 0.5, S0, gen, rate=0.05, is_call=False))
    sync(torch, dev)
    ok = euro_ok and amer >= eur - MC_Z * math.hypot(amer_se, eur_se) and math.isfinite(amer)
    emit(phase="rough_mc", dtype="float32", european=mc.tolist(), european_se=se.tolist(),
         price_rough_f64=cf.tolist(), american_put=amer, american_se=amer_se,
         european_put=eur, european_put_se=eur_se,
         gate=f"european {MC_Z} se + {MC_REL}; american >= european - {MC_Z} se",
         wall_s=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError("the rough Monte Carlo missed its gate")


def phase_g2_bermudan(torch, dev):
    """``bermudan_swaption_g2_mc`` at its defaults (2^16 regression paths,
    512 x 64) on the ATM payer 1.0 into 4.0 semi-annual: the sandwich
    ordered within 4 s.e., and the lower bound at least the best European
    (``g2_swaption``, float64 on the CPU) less 4 s.e."""
    import numpy as np

    from pde_tpu_torch.models import g2, rates
    from pde_tpu_torch.solvers import bermudan_g2

    cpu = torch.device("cpu")
    t = lambda a, d, dt: torch.as_tensor(a, dtype=dt, device=d)  # noqa: E731
    sched = np.arange(1.0, 4.01, 0.5)
    p32 = g2.G2Params(*(t(v, dev, torch.float32) for v in G2),
                      rates_curve(torch, dev, torch.float32))
    p64 = g2.G2Params(*(t(v, cpu, torch.float64) for v in G2),
                      rates_curve(torch, cpu, torch.float64))
    s64 = t(sched, cpu, torch.float64)
    par = float(rates.hw_swap_rate(p64.curve, 1.0, s64[1:]))
    t0 = time.perf_counter()
    lo, sel, up, seu = (float(x) for x in bermudan_g2.bermudan_swaption_g2_mc(
        p32, par, t(sched, dev, torch.float32), torch.Generator(device=dev).manual_seed(13)))
    wall = time.perf_counter() - t0
    best = max(float(g2.g2_swaption(p64, par, float(s64[j]), s64[j + 1:]))
               for j in range(len(sched) - 1))
    ok = (up + MC_Z * seu >= lo - MC_Z * sel and lo >= best - MC_Z * sel
          and all(map(math.isfinite, (lo, sel, up, seu))))
    emit(phase="g2_bermudan", dtype="float32", lower=lo, se_lower=sel, upper=up, se_upper=seu,
         best_european_f64=best, gate=f"sandwich ordered; lower >= best european - {MC_Z} se",
         wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("the G2 Bermudan sandwich missed its gate")


def phase_two_asset_mc(torch, dev):
    """``price_spread_mc`` (Margrabe control; K -5, 5, 10) and
    ``price_rainbow_mc`` (the four kinds, K 100) at their defaults (2^17
    paths) on the bench's two assets (rho 0.55): within 4 s.e. + 1e-5 of
    the price of ``spread_price_quad`` and of Stulz's closed form, float64
    on the CPU."""
    from pde_tpu_torch.models import multi_asset

    cpu = torch.device("cpu")
    two = {k: torch.tensor(v, dtype=torch.float64) for k, v in TWO_ASSET.items()}
    rho = torch.tensor(0.55, dtype=torch.float64)
    gen = torch.Generator(device=dev).manual_seed(14)
    t0 = time.perf_counter()
    ks = torch.tensor([-5.0, 5.0, 10.0], dtype=torch.float64)
    rows = {}
    mc, se = multi_asset.price_spread_mc(gen, strikes=ks.float().to(dev), rho=0.55,
                                         **TWO_ASSET)
    rows["spread"] = (mc, se, multi_asset.spread_price_quad(strike=ks, rho=rho, **two))
    for kind in ("call_on_max", "call_on_min", "put_on_max", "put_on_min"):
        mc, se = multi_asset.price_rainbow_mc(gen, strikes=100.0, rho=0.55, kind=kind,
                                              device=dev, **TWO_ASSET)
        rows[kind] = (mc, se, multi_asset.rainbow_two_asset_price(
            strike=torch.tensor(100.0, dtype=torch.float64, device=cpu), rho=rho, kind=kind,
            **two))
    sync(torch, dev)
    # beside 4 s.e., the float32 run's own rounding against float64 (1e-5 of
    # the price): a control that nearly IS the payoff leaves an s.e. of
    # rounding alone
    z = {k: float(((mc.cpu().double() - ref).abs() / (se.cpu().double() + 1e-5 * ref.abs()
                                                       / MC_Z)).max())
         for k, (mc, se, ref) in rows.items()}
    ok = all(v <= MC_Z for v in z.values())
    emit(phase="two_asset_mc", dtype="float32", max_z=z, gate=f"{MC_Z} se + 1e-5 |p|",
         wall_s=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError("the spread or rainbow Monte Carlo missed its gate")


def phase_lv_european_mc(torch, dev, interp):
    """A European through ``lv_simulate_fn`` on bench.py's Dupire surface
    (``heston_mc.price_european_mc``, 2^16 paths x 100 steps, strikes 90,
    100, 110, T 1, r 0.04, q 0.01): within 4 s.e. + 1% of the local-vol PDE
    price (``local_vol_pde.solve``, 200 x 100, float64 on the CPU on the
    same surface)."""
    from pde_tpu_torch.models import heston_mc, local_vol
    from pde_tpu_torch.solvers import local_vol_pde

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    k = [90.0, 100.0, 110.0]
    mc, se = heston_mc.price_european_mc(
        None, k, 1.0, S0, torch.Generator(device=dev).manual_seed(15), rate=LV_R,
        dividend=LV_Q, n_steps=100, n_paths=1 << 16, simulate_fn=local_vol.lv_simulate_fn(
            interp), device=dev)
    interp64 = local_vol.SurfaceInterpolator(torch.exp(interp.log_k).cpu(), interp.t.cpu(),
                                             interp.vols.cpu(), device=cpu,
                                             dtype=torch.float64)
    pde = torch.tensor([float(local_vol_pde.solve(interp64, S0, K=kk, T=1.0, r=LV_R, q=LV_Q,
                                                  device=cpu, dtype=torch.float64,
                                                  **LV_GRID).price) for kk in k],
                       dtype=torch.float64)
    mc, se = mc.cpu().double(), se.cpu().double()
    ok = bool(((mc - pde).abs() <= MC_Z * se + MC_REL * pde).all())
    emit(phase="lv_european_mc", dtype="float32", price=mc.tolist(), stderr=se.tolist(),
         local_vol_pde_f64=pde.tolist(), gate=f"{MC_Z} se + {MC_REL}",
         wall_s=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError("the local-vol Monte Carlo missed its gate")


MC_DESK_PHASES = (phase_basket_mc, phase_slv_calibration, phase_hw_bermudan_mc,
                  phase_cva_netting, phase_rough_mc, phase_g2_bermudan, phase_two_asset_mc)


def phase_hw_bermudan_pde_ladder(torch, dev):
    """bench_full.py:461-479's ladder as ONE march of (64, 257) systems on
    the card, float32: one K5 launch a step (exactly 160, counted by
    ``path``).  The prices within :func:`card_gate` of the port's float64
    march on the CPU; and the
    ATM price (float64, CPU) inside the MC sandwich (``phase_hw_bermudan_mc``)
    +- 4 s.e."""
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    card = ladder_prices(torch, dev, torch.float32)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    ref = ladder_prices(torch, cpu, torch.float64)
    fields, ok = card_gate(card, ref, ladder_prices(torch, cpu, torch.float32))
    par = bermudan_ladder(torch, cpu, torch.float64)[2]
    atm = float(ladder_prices(torch, cpu, torch.float64, strikes=par))
    sw = SANDWICH
    inside = (sw["lower"] - MC_Z * sw["se_lower"] <= atm <= sw["upper"] + MC_Z * sw["se_upper"])
    ok = ok and inside and bool(torch.isfinite(card).all()) and bool((card >= 0).all())
    emit(phase="hw_bermudan_pde_ladder", dtype="float32", strikes=BERM_LADDER, n_x=BERM_NX,
         n_sub=BERM_SUB, **fields, atm_pde_f64=atm, mc_sandwich=sw, atm_inside_sandwich=inside,
         first_call_wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("hw_bermudan_pde_ladder_prices_per_sec missed its gate")


def phase_bermudan_rows(torch, dev, reps=20):
    """The ladder timed outside the counted paths: median of 20 warm
    calls, bench_full.py's ``hw_bermudan_pde_ladder_prices_per_sec``."""
    walls = timed_walls(torch, dev, lambda: ladder_prices(torch, dev, torch.float32), reps)[1]
    per = statistics.median(walls)
    emit(phase="hw_bermudan_pde_ladder_rows", wall_s_runs=walls, median_call_s=per,
         hw_bermudan_pde_ladder_prices_per_sec=BERM_LADDER / per)


# bench_full.py:765-782: the strike strips; :878-885: the Bates American
PIDE_N, PIDE_SPACE, PIDE_TIME, PIDE_FP = 128, 512, 128, 2
PIDE_STEPS = PIDE_TIME * PIDE_FP   # one K5 launch a fixed-point pass
PIDE_MODEL = dict(sigma=0.2, r=R, q=Q, T=0.5, S0=S0)
PIDE_MERTON, PIDE_KOU = (0.5, -0.1, 0.15), (1.0, 0.4, 10.0, 5.0)
SERIES_RTOL, SERIES_ATOL = 3e-3, 5e-3      # tests/test_pide.py:31-38
BATES_PIDE_STEPS = 2 * 100                 # two K5 launches a step
LCP_METHODS_ATOL = 2e-2                    # tests/test_bates_pide.py:66-78
# tests/test_barrier.py:209-212: the full-Heston up-and-out call; 104-121:
# the four types in the Black-Scholes limit at 150 x 50 x 150
BARRIER_HESTON = dict(kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, v0=0.04, r=0.05, q=0.0,
                      T=1.0, K=100.0, n_spot=200, n_vol=60, n_time=200)
BARRIER_BS = dict(kappa=5.0, theta=0.0625, sigma=0.01, rho=0.0, v0=0.0625, r=0.05, q=0.02,
                  T=1.0, K=100.0, n_spot=150, n_vol=50, n_time=150, v_max=0.5)
BARRIER_RR_TOL = 2e-2
HJB_CARD = {}   # the card's Brennan-Schwartz boundaries and row, for hjb_native
# the smoke repeats cut to pay for the PIDE phases: phase -> (per-run wall
# in this run, runs cut)
REPEATS_CUT = {}


def pide_strip(torch, d, dtype, family, **kw):
    """One bench strip (128 strikes in [70, 130], 512 x 128, two passes)."""
    import numpy as np

    from pde_tpu_torch.solvers import pide

    jumps = pide.MertonJumps(*PIDE_MERTON) if family == "merton" else pide.KouJumps(*PIDE_KOU)
    m = PIDE_MODEL
    ks = torch.as_tensor(np.linspace(70.0, 130.0, PIDE_N), dtype=dtype, device=d)
    return pide.solve_pide(jumps, m["sigma"], m["r"], m["q"], m["T"], ks, m["S0"],
                           n_space=PIDE_SPACE, n_time=PIDE_TIME, fp_iterations=PIDE_FP,
                           device=d, dtype=dtype, **kw)


def phase_pide_merton_strip(torch, dev):
    """bench_full.py:765-774's Merton call strip on the card, float32: one
    K5 launch a fixed-point pass (exactly 256), the prices within the card
    gate of the port's float64 march on the CPU; that march within 3e-3 rel
    + 5e-3 abs of the Merton series on its strikes in [80, 120]."""
    import numpy as np

    from pde_tpu_torch.models.bates import merton_reference_price

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    card = pide_strip(torch, dev, torch.float32, "merton").price
    sync(torch, dev)
    wall = time.perf_counter() - t0
    ref = pide_strip(torch, cpu, torch.float64, "merton").price
    fields, ok = card_gate(card, ref, pide_strip(torch, cpu, torch.float32, "merton").price)
    ks = np.linspace(70.0, 130.0, PIDE_N)
    mid = (ks >= 80.0) & (ks <= 120.0)
    m = PIDE_MODEL
    series = merton_reference_price(ks[mid], m["T"], m["S0"], m["r"], m["q"], m["sigma"],
                                    *PIDE_MERTON)
    s_err = np.abs(ref.numpy()[mid] - series)
    s_ok = bool((s_err <= SERIES_ATOL + SERIES_RTOL * np.abs(series)).all())
    ok = ok and s_ok and bool(torch.isfinite(card).all())
    emit(phase="pide_merton_strip", dtype="float32", strikes=PIDE_N, n_space=PIDE_SPACE,
         n_time=PIDE_TIME, fp_iterations=PIDE_FP, **fields, series_max_abs_f64=float(
             s_err.max()), series_gate=f"{SERIES_RTOL} rel + {SERIES_ATOL}", series_ok=s_ok,
         first_call_wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("pide_merton_strip128_options_per_sec missed its gate")


def phase_pide_kou_american_strip(torch, dev):
    """bench_full.py:776-782's Kou American put strip on the card, float32:
    256 K5 launches; :func:`card_gate` against float64 on the CPU; there the
    American at least max(European, intrinsic) - 1e-5."""
    import numpy as np

    cpu = torch.device("cpu")
    kw = dict(is_call=False, american=True)
    t0 = time.perf_counter()
    card = pide_strip(torch, dev, torch.float32, "kou", **kw).price
    sync(torch, dev)
    wall = time.perf_counter() - t0
    ref = pide_strip(torch, cpu, torch.float64, "kou", **kw).price
    fields, ok = card_gate(card, ref, pide_strip(torch, cpu, torch.float32, "kou", **kw).price)
    euro = pide_strip(torch, cpu, torch.float64, "kou", is_call=False).price
    intrinsic = torch.clamp_min(torch.as_tensor(np.linspace(70.0, 130.0, PIDE_N)) - S0, 0.0)
    below = float((torch.maximum(euro, intrinsic) - ref).max())
    ok = ok and below <= 1e-5 and bool(torch.isfinite(card).all())
    emit(phase="pide_kou_american_strip", dtype="float32", strikes=PIDE_N, **fields,
         f64_most_below_max_european_intrinsic=below, first_call_wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("pide_kou_american_strip128_options_per_sec missed its gate")


def bates_pide_params(**over):
    from pde_tpu_torch.solvers import bates_pide, pide

    base = dict(q=Q, is_call=False, american=True, american_method="it_lcp",
                jumps=pide.MertonJumps(*PIDE_MERTON), n_time=BATES_PIDE_STEPS // 2)
    base.update(over)
    return bates_pide.BatesPIDEParams(**base)


def phase_bates_pide_american(torch, dev):
    """bench_full.py:878-885's Bates American put (Ikonen-Toivanen, 100 x
    50 x 100) on the card, float32: two K5 launches a step (exactly 200);
    `card_gate` against float64 on the CPU; there projection within 2e-2
    of Ikonen-Toivanen and both at least the European."""
    from pde_tpu_torch.solvers import bates_pide

    cpu, f64 = torch.device("cpu"), torch.float64
    p = bates_pide_params()
    t0 = time.perf_counter()
    card = bates_pide.solve_bates_pide(p, S0, device=dev, dtype=torch.float32).price
    sync(torch, dev)
    wall = time.perf_counter() - t0
    ref = bates_pide.solve_bates_pide(p, S0, device=cpu, dtype=f64).price
    fields, ok = card_gate(card[None], ref[None], bates_pide.solve_bates_pide(
        p, S0, device=cpu, dtype=torch.float32).price[None])
    proj = float(bates_pide.solve_bates_pide(p._replace(american_method="projection"), S0,
                                             device=cpu, dtype=f64).price)
    euro = float(bates_pide.solve_bates_pide(p._replace(american=False), S0, device=cpu,
                                             dtype=f64).price)
    ok = (ok and abs(proj - float(ref)) < LCP_METHODS_ATOL and min(proj, float(ref)) >= euro
          and bool(torch.isfinite(card)))
    emit(phase="bates_pide_american", dtype="float32", grid=[p.n_spot, p.n_vol, p.n_time],
         **fields,
         price=float(card), it_lcp_f64=float(ref), projection_f64=proj, european_f64=euro,
         first_call_wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("bates_pide_american_solve_s missed its gate")


def phase_barrier_pde(torch, dev):
    """The full-Heston up-and-out call at 200 x 60 x 200 on the card,
    float32 (two K5 launches a step, 400), against float64 on the CPU; then
    the four barrier types in the Black-Scholes limit at 150 x 50 x 150
    against Reiner-Rubinstein at 2e-2, each knock-out at 2N launches and
    each knock-in at 4N (its vanilla march too)."""
    from pde_tpu_torch.models import black_scholes
    from pde_tpu_torch.solvers import barrier_pde, heston_adi

    from pde_tpu_torch.ops import tridiag

    cpu, k5 = torch.device("cpu"), tridiag.thomas_batched
    p = heston_adi.HestonPDEParams(**BARRIER_HESTON)
    t0 = time.perf_counter()
    card = barrier_pde.solve_barrier(p, S0, 120.0, "up-and-out", device=dev,
                                     dtype=torch.float32).price
    sync(torch, dev)
    wall = time.perf_counter() - t0
    ref = barrier_pde.solve_barrier(p, S0, 120.0, "up-and-out", device=cpu,
                                    dtype=torch.float64).price
    fields, ok = card_gate(card[None], ref[None], barrier_pde.solve_barrier(
        p, S0, 120.0, "up-and-out", device=cpu, dtype=torch.float32).price[None])
    pb = heston_adi.HestonPDEParams(**BARRIER_BS)
    types = {}
    for bt in ("up-and-out", "down-and-out", "up-and-in", "down-and-in"):
        bar = 125.0 if bt.startswith("up") else 85.0
        before = k5.launches
        price = float(barrier_pde.solve_barrier(pb, S0, bar, bt, device=dev,
                                                dtype=torch.float32).price)
        n = k5.launches - before
        ana = float(black_scholes.barrier_price(torch.tensor(S0, dtype=torch.float64), 100.0,
                                                bar, 0.05, 0.02, 1.0, 0.25, bt, True))
        want = (4 if bt.endswith("in") else 2) * BARRIER_BS["n_time"]
        # pytest.approx(ana, rel=2e-2, abs=2e-2), as the reference's test
        good = abs(price - ana) <= max(BARRIER_RR_TOL * abs(ana), BARRIER_RR_TOL) and n == want
        types[bt] = dict(price=price, reiner_rubinstein=ana, k5_launches=n, ok=good)
        ok = ok and good
    ok = ok and bool(torch.isfinite(card))
    emit(phase="barrier_pde", dtype="float32",
         grid=[p.n_spot, p.n_vol, p.n_time], price=float(card),
         cpu_f64=float(ref), **fields, bs_limit=types, first_call_wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("the barrier PDE missed its gate")


PIDE_ROW_REPS = {"pide_merton_strip128": 20, "pide_kou_american_strip128": 20,
                 "bates_pide_american": 10, "barrier_up_and_out_200x60x200": 5}


def phase_pide_rows(torch, dev):
    """The PIDE rows timed outside the counted paths, each
    :func:`pide_profile_rows` call for its ``PIDE_ROW_REPS`` warm runs: the
    medians of 20 strip calls (``pide_merton_strip128_options_per_sec``,
    ``pide_kou_american_strip128_options_per_sec``), of 10 Bates American
    solves (``bates_pide_american_solve_s``) and of 5 full-Heston
    up-and-out calls at 200 x 60 x 200 (no bench row).  Returns the
    phase's seconds."""
    t0 = time.perf_counter()
    walls = {k: timed_walls(torch, dev, fn, PIDE_ROW_REPS[k])[1]
             for k, fn in pide_profile_rows(torch, dev).items()}
    med = {k: statistics.median(w) for k, w in walls.items()}
    emit(phase="pide_rows", wall_s_runs=walls, median_call_s=med,
         pide_merton_strip128_options_per_sec=PIDE_N / med["pide_merton_strip128"],
         pide_kou_american_strip128_options_per_sec=PIDE_N / med["pide_kou_american_strip128"],
         bates_pide_american_solve_s=med["bates_pide_american"],
         barrier_up_and_out_200x60x200_solve_s=med["barrier_up_and_out_200x60x200"],
         seconds=time.perf_counter() - t0)
    return time.perf_counter() - t0


def phase_hjb_native(torch, dev, reps=20):
    """``solve_all_boundaries(backend="native")`` on bench_full.py's
    256 x 128 Brennan-Schwartz config: the C++ host twin, no kernel; its
    boundaries within one cell of the card's march (``phase_hjb_brennan``)
    and its median wall beside the card's ``ou_freeboundary_psor_solve_s``
    (``phase_hjb_rows``)."""
    from pde_tpu_torch.solvers import hjb

    p = hjb.HJBParams(**HJB_BENCH, method="brennan_schwartz", backend="native")
    b, walls = timed_walls(torch, dev, lambda: hjb.solve_all_boundaries(p), reps)
    diff = max(abs(x - y) for x, y in zip(b, HJB_CARD["brennan_schwartz"]))
    ok = bool(b.entry_long < b.exit_long and diff <= hjb_dx(p) + 1e-6)
    med = statistics.median(walls)
    emit(phase="hjb_native", grid=[p.n_space, p.n_time], boundaries=b._asdict(),
         max_abs_diff_vs_card=diff, dx=hjb_dx(p), wall_s_runs=walls,
         native_ou_freeboundary_psor_solve_s=med,
         card_ou_freeboundary_psor_solve_s=HJB_CARD["ou_freeboundary_psor_solve_s"],
         card_over_native=HJB_CARD["ou_freeboundary_psor_solve_s"] / med, ok=ok)
    if not ok:
        raise AssertionError("the native HJB route missed its gate")


PIDE_PATHS = ((phase_pide_merton_strip, PIDE_STEPS), (phase_pide_kou_american_strip, PIDE_STEPS),
              (phase_bates_pide_american, BATES_PIDE_STEPS),
              (phase_barrier_pde, 2 * BARRIER_HESTON["n_time"]
               + 12 * BARRIER_BS["n_time"]))


# bench_full.py:945-979: calibration -> vol-arb signal -> vol-managed size on
# the 108-quote surface; :1074-1136: the micro-batching pricing service
# (20,000 requests from 32 closed-loop clients, buckets 8-2048, 2 ms wait,
# float32), its direct-batch baseline (200 calls) and a 64-request Greeks
# batch in float64; the risk rows (no bench row): GARCH(1,1) on 252 returns
# of a seeded GARCH series, EWMA over a (512, 252) universe, Monte-Carlo
# VaR with 10,000 scenarios over 8 assets
PIPELINE_RETURNS = dict(seed=7, loc=0.0005, scale=0.012, n=252)
SERVE_N, SERVE_CLIENTS, SERVE_WAIT_MS = 20_000, 32, 2.0
SERVE_BUCKETS, SERVE_DIRECT_REPS, GREEKS_N = (8, 32, 128, 512, 2048), 200, 64
GARCH_N, EWMA_ASSETS, VAR_ASSETS, VAR_SIMS = 252, 512, 8, 10_000
# float64 on the card against float64 on the CPU: the likelihood, its
# gradient, the Greeks and the VaR figures round in another order (1e-10,
# relative to the largest figure where a row has several); L-BFGS-B
# turns gradients that agree to ~1e-15 into fits within 1e-6 where the
# maximum is identified (tests/test_torch_position_sizer.py)
F64_TOL, GARCH_VOL_REL, EWMA_REL = 1e-10, 1e-6, 1e-12


def sizing_pipeline(torch, dev):
    """bench_full.py's ``pipeline()`` on the 108-quote surface, float32:
    fit, signals (market IVs from ``black_scholes.implied_vol``), size on
    252 seeded daily returns.  Returns (pipeline, chain, returns)."""
    import numpy as np

    from pde_tpu_torch.calibrate.heston import HestonCalibrator
    from pde_tpu_torch.models import black_scholes as bs
    from pde_tpu_torch.risk.position_sizer import VolatilityScaledPositionSizer
    from pde_tpu_torch.signals.vol_arbitrage import VolSurfaceArbitrageSignal

    f32 = torch.float32
    data = HestonCalibrator.generate_synthetic_data(
        S0=S0, r=R, q=Q, **TRUE, strikes=np.linspace(85.0, 115.0, 12),
        maturities=np.linspace(0.25, 1.5, 9), device=dev, dtype=f32)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=f32, device=dev)  # noqa: E731
    market_iv = bs.implied_vol(t(data["mid_price"]), S0, t(data["strike"]), R, Q,
                               t(data["maturity"])).cpu().numpy()
    chain = {"strike": np.asarray(data["strike"]), "T": np.asarray(data["maturity"]),
             "implied_vol": market_iv}
    p = PIPELINE_RETURNS
    rets = np.random.default_rng(p["seed"]).normal(p["loc"], p["scale"], p["n"])
    cal = HestonCalibrator(seed=42, device=dev, dtype=f32, **BUDGET)
    gen = VolSurfaceArbitrageSignal(use_sabr=False, device=dev, dtype=f32)
    sizer = VolatilityScaledPositionSizer()

    def pipeline():
        res = cal.calibrate(data, S0=S0, r=R, q=Q)
        sigs = gen.generate_signals(chain, S0, R, Q, heston_result=res)
        return res, sigs, sizer.compute_position_size(rets, 1_000_000.0)

    return pipeline, chain, rets


def phase_sizing_pipeline(torch, dev, timed_runs=3):
    """``calibration_to_sizing_pipeline_s``: one warm run, then the mean of
    ``timed_runs``; the fit at bench.py's gate, the card's model IVs on the
    fitted parameters by :func:`card_gate` against the port's float64 run
    on the CPU, the size equal to the sizer's numpy arithmetic."""
    import numpy as np

    from pde_tpu_torch.signals.vol_arbitrage import VolSurfaceArbitrageSignal

    pipeline, chain, rets = sizing_pipeline(torch, dev)
    pipeline()  # warm-up
    walls = []
    for _ in range(timed_runs):
        t0 = time.perf_counter()
        res, sigs, sized = pipeline()
        walls.append(time.perf_counter() - t0)
    n = len(chain["strike"])
    rel_rmse = float(np.sqrt(2.0 * res.convergence["local_cost"] / n))
    fit_ok = abs(res.params.v0 - TRUE["v0"]) < 0.02 and rel_rmse < 0.05   # bench.py:274
    cpu = torch.device("cpu")
    args = (chain["strike"], chain["T"], np.ones(n, bool), S0, R, Q, res, None)
    # the card's float32 IVs, the CPU's float64 and float32 ones
    ivs = [VolSurfaceArbitrageSignal(use_sabr=False, device=d, dtype=dt)._model_iv_vector(*args)
           for d, dt in ((dev, torch.float32), (cpu, torch.float64), (cpu, torch.float32))]
    fields, iv_ok = card_gate(*(torch.as_tensor(v) for v in ivs))
    sigs_cpu = VolSurfaceArbitrageSignal(use_sabr=False, device=cpu, dtype=torch.float64
                                         ).generate_signals(chain, S0, R, Q, heston_result=res)
    vol = float(np.clip(np.std(rets[-21:], ddof=1) * np.sqrt(252), 0.01, 1.0))
    size = min(1_000_000.0 * float(np.clip(0.15**2 / vol**2, 0.2, 2.0)), 1_000_000.0 * 0.25)
    size_ok = sized.position_size == size and size > 0
    per = statistics.mean(walls)
    ok = bool(fit_ok and iv_ok and size_ok and np.all(np.isfinite(ivs[0])))
    emit(phase="calibration_to_sizing_pipeline", n_quotes=n, rel_rmse=rel_rmse,
         params=[float(v) for v in res.params], model_iv_gate=fields, n_signals_card=len(sigs),
         n_signals_cpu_f64=len(sigs_cpu), position_size=sized.position_size,
         position_size_numpy=size, wall_s_runs=walls, calibration_to_sizing_pipeline_s=per,
         baseline_s=5.0, ok=ok)
    if not ok:
        raise AssertionError("the calibration-to-sizing pipeline missed its gate")


def serving_requests():
    """bench_full.py's requests: 81 strikes x 19 maturities cycled, calls
    and puts alternating, one Heston vector."""
    from pde_tpu_torch.serving import PricingRequest

    return [PricingRequest(strike=80.0 + (i % 81) * 0.5, maturity=0.1 + (i % 19) * 0.1,
                           spot=S0, params=tuple(TRUE.values()), rate=R, dividend=Q,
                           is_call=bool(i % 2)) for i in range(SERVE_N)]


def serving_run(pricer, reqs):
    """bench_full.py's closed-loop clients through a started server: (wall
    seconds, latencies in s, prices, the server's stats)."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from pde_tpu_torch.serving import MicroBatchingServer

    n = len(reqs)
    lat, prices = np.empty(n), np.empty(n)
    with MicroBatchingServer(pricer, max_wait_ms=SERVE_WAIT_MS) as srv:
        srv.pricer.warmup(greeks=False)

        def client(span):
            for i in range(*span):
                t0 = time.perf_counter()
                prices[i] = srv.price(reqs[i], timeout=120.0).price
                lat[i] = time.perf_counter() - t0

        chunk = n // SERVE_CLIENTS
        spans = [(c * chunk, (c + 1) * chunk if c < SERVE_CLIENTS - 1 else n)
                 for c in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            list(pool.map(client, spans))
        wall = time.perf_counter() - t0
    return wall, lat, prices, srv.stats


def direct_prices(torch, d, dtype, reqs):
    """``heston.price_carr_madan_gl`` over the requests' own parameters in
    one call, as (n, 1) parameter columns: the server's reference."""
    import numpy as np

    from pde_tpu_torch.models import heston

    cols = torch.as_tensor(np.array([(*r.params, r.strike, r.maturity, r.spot, r.rate,
                                      r.dividend, r.is_call) for r in reqs]),
                           dtype=dtype, device=d)
    p = heston.HestonParams(*(cols[:, i:i + 1] for i in range(5)))
    return heston.price_carr_madan_gl(p, *cols[:, 5:10].unbind(1), cols[:, 10])


def phase_pricing_service(torch, dev):
    """``pricing_service_requests_per_sec``, ``pricing_service_p99_latency_ms``
    and ``pricing_direct_batch_p99_latency_ms``: every price within
    :func:`card_gate` of the float64 pricer on the CPU, no error, every
    request answered, batches of more than one; then a 64-request Greeks
    batch in float64 on the card within 1e-10 of the CPU's."""
    import dataclasses

    import numpy as np

    from pde_tpu_torch.serving import BatchPricer

    cpu = torch.device("cpu")
    reqs = serving_requests()
    pricer = BatchPricer(buckets=SERVE_BUCKETS, device=dev, dtype=torch.float32)
    wall, lat, prices, stats = serving_run(pricer, reqs)
    fields, ok = card_gate(torch.as_tensor(prices), direct_prices(torch, cpu, torch.float64, reqs),
                           direct_prices(torch, cpu, torch.float32, reqs))
    ok = ok and stats.errors == 0 and stats.requests == SERVE_N and stats.mean_batch > 1
    bucket = int(np.ceil(stats.mean_batch))
    direct = reqs[:bucket]
    pricer.price(direct)
    lat_d = []
    for _ in range(SERVE_DIRECT_REPS):
        t0 = time.perf_counter()
        pricer.price(direct)
        lat_d.append(time.perf_counter() - t0)
    greeks = [dataclasses.replace(r, spot=S0 + (i % 7) - 3.0, want_greeks=True)
              for i, r in enumerate(reqs[:GREEKS_N])]
    out = {d: np.array([[g.price, g.delta, g.vega] for g in BatchPricer(
        buckets=(GREEKS_N,), device=d, dtype=torch.float64).price(greeks)]) for d in (dev, cpu)}
    greeks_err = float(np.abs(out[dev] - out[cpu]).max())
    ok = bool(ok and greeks_err <= F64_TOL and np.isfinite(out[dev]).all())
    emit(phase="pricing_service", n_requests=SERVE_N, clients=SERVE_CLIENTS,
         buckets=SERVE_BUCKETS, max_wait_ms=SERVE_WAIT_MS, dtype="float32", **fields,
         stats=stats.to_dict(), mean_batch=stats.mean_batch, wall_s=wall,
         pricing_service_requests_per_sec=SERVE_N / wall,
         pricing_service_p99_latency_ms=float(np.percentile(lat * 1e3, 99)),
         pricing_service_p50_latency_ms=float(np.percentile(lat * 1e3, 50)),
         direct_batch=bucket,
         pricing_direct_batch_p99_latency_ms=float(np.percentile(np.asarray(lat_d) * 1e3, 99)),
         pricing_direct_batch_p50_latency_ms=float(np.percentile(np.asarray(lat_d) * 1e3, 50)),
         greeks_batch=GREEKS_N, greeks_f64_max_abs_vs_cpu=greeks_err, ok=ok)
    if not ok:
        raise AssertionError("the pricing service missed its gate")


def garch_returns(n, seed):
    """A GARCH(1,1) daily return series (omega 2e-6, alpha 0.08, beta 0.9)
    from seeded normals (numpy)."""
    import numpy as np

    omega, a, b = 2e-6, 0.08, 0.9
    z = np.random.default_rng(seed).standard_normal(n)
    var, out = omega / (1.0 - a - b), np.empty(n)
    for t in range(n):
        out[t] = np.sqrt(var) * z[t]
        var = omega + a * out[t] ** 2 + b * var
    return out


def phase_risk(torch, dev, reps=20):
    """The risk layer on the card in float64 against the CPU: GARCH's
    likelihood and gradient at the fit's start (1e-10) and the fitted vol
    (1e-6 relative); EWMA ``estimate_batch`` over a (512, 252) universe
    (1e-12 relative); Monte-Carlo VaR, 10,000 scenarios over 8 assets, on
    one replay of CPU normals (1e-10), then on the card's own generator;
    each timed (medians of ``reps`` warm calls, the fits of 5)."""
    import numpy as np

    from pde_tpu_torch.risk import position_sizer, var_calculator

    cpu, f64 = torch.device("cpu"), torch.float64
    rets = garch_returns(GARCH_N, 1)
    x0 = np.array([np.log(0.1 * float(np.var(rets * 100))), 0.0, 2.0])
    ll = {d: position_sizer._garch_value_and_grad(torch.as_tensor(x0, device=d),
                                                  torch.as_tensor(rets * 100.0, device=d))
          for d in (dev, cpu)}
    # relative to the largest entry: the value and each gradient's vector
    ll_err = max(float((c.cpu() - h).abs().max() / h.abs().max().clamp_min(1.0))
                 for c, h in zip(ll[dev], ll[cpu]))
    x0_dev, r_dev = torch.as_tensor(x0, device=dev), torch.as_tensor(rets * 100.0, device=dev)
    ll_ms = statistics.median(timed_walls(torch, dev, lambda: position_sizer._garch_value_and_grad(
        x0_dev, r_dev), reps)[1]) * 1e3
    est = {d: position_sizer.VolatilityEstimator("garch", device=d) for d in (dev, cpu)}
    vol_cpu = est[cpu].estimate(rets)
    vol, fit_walls = timed_walls(torch, dev, lambda: est[dev].estimate(rets), 5)
    vol_rel = abs(vol - vol_cpu) / vol_cpu

    universe = np.random.default_rng(2).normal(0.0005, 0.012, (EWMA_ASSETS, GARCH_N))
    ewma = {d: position_sizer.VolatilityEstimator("ewma", device=d) for d in (dev, cpu)}
    ewma_card, ewma_walls = timed_walls(torch, dev, lambda: ewma[dev].estimate_batch(universe),
                                        reps)
    ewma_ref = ewma[cpu].estimate_batch(universe)
    ewma_rel = float(np.max(np.abs(ewma_card - ewma_ref) / ewma_ref))

    rng = np.random.default_rng(3)
    a = rng.normal(size=(VAR_ASSETS, VAR_ASSETS))
    cov = a @ a.T * 2e-5 + np.eye(VAR_ASSETS) * 5e-5
    hist = rng.multivariate_normal(np.full(VAR_ASSETS, 2e-4), cov, 1000)
    ids = [f"A{i}" for i in range(VAR_ASSETS)]
    book = {k: v for k, v in zip(ids, rng.uniform(-2e5, 8e5, VAR_ASSETS))}
    z = torch.randn((VAR_SIMS, VAR_ASSETS), generator=torch.Generator().manual_seed(11),
                    dtype=f64)
    own = var_calculator._mc_normals
    var_calculator._mc_normals = lambda seed, shape, dtype, device: z.to(device, dtype)
    try:
        replay = {d: var_calculator.VaRCalculator("monte_carlo", n_simulations=VAR_SIMS,
                                                  device=d).calculate(book, hist, ids)
                  for d in (dev, cpu)}
    finally:
        var_calculator._mc_normals = own
    # VaR, CVaR and the components, relative to the largest of them
    got, want = (np.array([v.var_95, v.var_99, v.cvar_95, v.cvar_99, *v.component_var.values()])
                 for v in (replay[dev], replay[cpu]))
    var_err = float(np.abs(got - want).max() / np.abs(want).max())
    mc = var_calculator.VaRCalculator("monte_carlo", n_simulations=VAR_SIMS, device=dev)
    mc_res, mc_walls = timed_walls(torch, dev, lambda: mc.calculate(book, hist, ids), reps)
    hc = var_calculator.VaRCalculator("historical", device=dev)
    hc_res, hc_walls = timed_walls(torch, dev, lambda: hc.calculate(book, hist, ids), reps)
    hist_cpu = var_calculator.VaRCalculator("historical", device=cpu).calculate(book, hist, ids)
    hist_err = abs(hc_res.var_95 - hist_cpu.var_95) / hist_cpu.var_95
    ok = bool(ll_err <= F64_TOL and vol_rel <= GARCH_VOL_REL and ewma_rel <= EWMA_REL
              and var_err <= F64_TOL and hist_err <= F64_TOL and mc_res.var_95 > 0)
    emit(phase="risk", garch_n=GARCH_N, garch_ll_grad_max_abs_vs_cpu=ll_err,
         garch_value_and_grad_ms=ll_ms, garch_vol=vol, garch_vol_rel_vs_cpu=vol_rel,
         garch_fit_s=statistics.median(fit_walls), ewma_batch=[EWMA_ASSETS, GARCH_N],
         ewma_max_rel_vs_cpu=ewma_rel, ewma_batch_ms=statistics.median(ewma_walls) * 1e3,
         var_assets=VAR_ASSETS, var_sims=VAR_SIMS, var_replay_max_rel_vs_cpu=var_err,
         var_mc_var_95=mc_res.var_95, var_mc_ms=statistics.median(mc_walls) * 1e3,
         var_historical_rel_vs_cpu=hist_err, var_historical_ms=statistics.median(hc_walls) * 1e3,
         ok=ok)
    if not ok:
        raise AssertionError("the risk layer missed its gate")


SIGNAL_PHASES = (phase_sizing_pipeline, phase_pricing_service, phase_risk)


def signal_profile_rows(torch, dev):
    """The pipeline and the pricing service, float32 on the card."""
    from pde_tpu_torch.serving import BatchPricer

    pipeline = sizing_pipeline(torch, dev)[0]
    pricer = BatchPricer(buckets=SERVE_BUCKETS, device=dev, dtype=torch.float32)
    reqs = serving_requests()
    return {"calibration_to_sizing_pipeline": pipeline,
            "pricing_service": lambda: serving_run(pricer, reqs)}


# The backtests, validation statistics, linear algebra and options data, in
# float64 on the card against the same calls on the CPU (no kernel): the
# full strategy grid (48 points) over the reference's sector universe, 13
# groups of 114 symbols (pde_tpu/backtest/sectors.py:51-75), ten years of
# daily bars each; the rolling re-optimization and the MA walk-forward
# (252 / 63) on one such series; 10,000 shuffled and block-bootstrapped
# (20-bar blocks) paths of 2,520 returns, a 10,000-resample bootstrap, a
# 100,000 x 63-day Student-t(4) stress; a 12-expiry x 81-strike call and
# put chain (2 weeks to 2.5 years) on a Heston surface with an SVI fit per
# expiry; an EWMA
# covariance of 100 assets and 500 x 500 positive-definite repairs and
# solves.
BT_GROUPS = (18, 14, 10, 9, 7, 8, 9, 6, 6, 6, 7, 5, 9)
BT_BARS, BT_OPT, BT_TRADE = 2520, 252, 63
BT_SIMS, BT_BLOCK, BT_BOOT = 10_000, 20, 10_000
BT_STRESS = dict(daily_vol=0.012, n_days=63, n_paths=100_000, t_dof=4.0)
CHAIN_DAYS = (14, 30, 60, 91, 122, 182, 273, 365, 456, 547, 730, 913)
CHAIN_STRIKES, CHAIN_WIDTH = 81, 2.5         # strikes to +-2.5 sd of a 20% vol
EWMA_SHAPE, PD_N = (2520, 100), 500
# the card against the CPU on the same float64 inputs: reductions, LAPACK
# and cuSOLVER round in another order (the positions and prefix scans are
# the same bits on both); implied vols to the Newton's own 1e-8; SVI's LM
# to 1e-6 (tests/test_torch_options_data.py), its fit within 1e-4 in total
# variance
BT_REL, OOS_ABS, IV_ABS, SVI_ABS, SVI_RMSE = 1e-10, 1e-12, 1e-8, 1e-6, 1e-4


def bt_series(n_series, seed):
    """Seeded daily log prices: AR(1)s (phi 0.9-0.995, vol 1-2.5%) around
    slow random walks, as (n_series, BT_BARS) prices (numpy)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    phi = rng.uniform(0.9, 0.995, (n_series, 1))
    eps = rng.normal(0.0, 1.0, (n_series, BT_BARS)) * rng.uniform(0.01, 0.025, (n_series, 1))
    x = np.zeros((n_series, BT_BARS))
    for t in range(1, BT_BARS):
        x[:, t] = phi[:, 0] * x[:, t - 1] + eps[:, t]
    walk = np.cumsum(rng.normal(0.0002, 0.006, (n_series, BT_BARS)), axis=1)
    return 100.0 * np.exp(x + walk)


def bt_universe():
    """{group: {symbol: prices}} of the reference's sector sizes."""
    prices = iter(bt_series(sum(BT_GROUPS), 17))
    return {f"sector{g}": {f"S{g}_{i}": next(prices) for i in range(size)}
            for g, size in enumerate(BT_GROUPS)}


def rel_err(got, want):
    """Largest |got - want| over max(1, |want|)."""
    import numpy as np

    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)), initial=0.0))


def fit_err(got, want):
    """(the same choice, the largest relative error of the figures) of two
    FitnessResults."""
    figs = ("fitness", "sharpe", "total_return", "max_drawdown")
    return (got.strategy, got.params) == (want.strategy, want.params), rel_err(
        [getattr(got, k) for k in figs], [getattr(want, k) for k in figs])


def idle_share(torch, dev, fn):
    """One warm call under torch.profiler: (wall s, busy s, idle share)."""
    wall, dev_us = profiled(torch, dev, fn)
    busy = sum(dev_us.values()) * 1e-6
    return wall, busy, 1.0 - busy / wall


def phase_strategy_optimizer(torch, dev, timed_runs=3):
    """``StrategyOptimizer().run_optimization`` over the universe, all five
    families' grids: the same family and parameters in every group and
    family as on the CPU, the figures within BT_REL; one warm call, then
    the median of ``timed_runs``, and one profiled call's idle share."""
    from pde_tpu_torch.backtest.optimizer import STRATEGY_FAMILIES, StrategyOptimizer

    groups = bt_universe()
    card = StrategyOptimizer(device=dev)
    res, walls = timed_walls(torch, dev, lambda: card.run_optimization(groups), timed_runs)
    ref = StrategyOptimizer(device=torch.device("cpu")).run_optimization(groups)
    checks = [fit_err(res[g][s], ref[g][s]) for g in ref for s in ref[g]]
    same, err = all(c[0] for c in checks), max(c[1] for c in checks)
    best = {g: max(cells.values(), key=lambda f: f.fitness).strategy for g, cells in res.items()}
    wall, busy, idle = idle_share(torch, dev, lambda: card.run_optimization(groups))
    ok = bool(same and err <= BT_REL)
    emit(phase="strategy_optimizer", groups=len(BT_GROUPS), symbols=sum(BT_GROUPS),
         bars=BT_BARS, grid_points=sum(len(list(itertools.product(*f["grid"].values())))
                                       for f in STRATEGY_FAMILIES.values()),
         same_choices_as_cpu=same, max_rel_vs_cpu=err, best_family=best, wall_s_runs=walls,
         strategy_optimizer_s=statistics.median(walls), profiled_wall_s=wall,
         device_busy_s=busy, idle_share=idle, ok=ok)
    if not ok:
        raise AssertionError("the strategy optimizer missed its gate")


def phase_rolling_walk_forward(torch, dev, timed_runs=3):
    """``RollingOptimizationBacktester`` (every family) and the MA-crossover
    ``WalkForwardAnalysis``, 252 / 63, on one 2,520-bar series: the same
    choice in each of the 36 periods as on the CPU, the out-of-sample
    returns within OOS_ABS, the aggregates within BT_REL."""
    import numpy as np

    from pde_tpu_torch.backtest.analysis import WalkForwardAnalysis
    from pde_tpu_torch.backtest.optimizer import (STRATEGY_FAMILIES,
                                                  RollingOptimizationBacktester,
                                                  StrategyOptimizer)

    prices = bt_series(1, 23)[0]
    periods = (BT_BARS - BT_OPT - BT_TRADE) // BT_TRADE + 1   # 36
    ma = STRATEGY_FAMILIES["ma_crossover"]
    runs = {
        "rolling": {d: RollingOptimizationBacktester(StrategyOptimizer(device=d), BT_OPT,
                                                     BT_TRADE).run
                    for d in (dev, torch.device("cpu"))},
        "walk_forward": {d: WalkForwardAnalysis(ma["fn"], ma["grid"], BT_OPT, BT_TRADE,
                                                device=d).run
                         for d in (dev, torch.device("cpu"))},
    }
    out, ok = {}, True
    for name, run in runs.items():
        res, walls = timed_walls(torch, dev, lambda: run[dev](prices), timed_runs)
        ref = run[torch.device("cpu")](prices)
        if name == "rolling":
            picks = [(p.chosen_strategy, p.chosen_params) for p in res.periods]
            want = [(p.chosen_strategy, p.chosen_params) for p in ref.periods]
            agg, agg_ref = res.aggregate_metrics, ref.aggregate_metrics
        else:
            picks = [w.best_params for w in res.windows]
            want = [w.best_params for w in ref.windows]
            agg = dict(res.oos_metrics, avg_is_sharpe=res.avg_is_sharpe,
                       avg_oos_sharpe=res.avg_oos_sharpe)
            agg_ref = dict(ref.oos_metrics, avg_is_sharpe=ref.avg_is_sharpe,
                           avg_oos_sharpe=ref.avg_oos_sharpe)
        oos = float(np.max(np.abs(res.oos_returns - ref.oos_returns)))
        agg_err = rel_err([agg[k] for k in agg_ref], list(agg_ref.values()))
        good = (len(picks) == periods and picks == want
                and res.oos_returns.shape == ref.oos_returns.shape
                and oos <= OOS_ABS and agg_err <= BT_REL)
        ok = ok and good
        out[name] = dict(periods=len(picks), same_choices_as_cpu=picks == want,
                         oos_max_abs_vs_cpu=oos, aggregates_max_rel_vs_cpu=agg_err,
                         wall_s=statistics.median(walls), ok=good)
    emit(phase="rolling_walk_forward", bars=BT_BARS, windows=[BT_OPT, BT_TRADE], **out,
         ok=bool(ok))
    if not ok:
        raise AssertionError("the rolling optimization or the walk-forward missed its gate")


def bt_returns():
    """2,520 daily strategy returns: a 0.04% drift under Student-t(5) noise."""
    import numpy as np

    rng = np.random.default_rng(31)
    return 0.0004 + 0.01 * rng.standard_t(5, BT_BARS) / np.sqrt(5.0 / 3.0)


def path_drawdowns(equity):
    """Each equity path's max drawdown (numpy)."""
    import numpy as np

    return np.max(1.0 - equity / np.maximum.accumulate(equity, axis=1), axis=1)


def phase_backtest_monte_carlo(torch, dev, timed_runs=3):
    """``MonteCarloSimulator`` (shuffle, block), ``BootstrapAnalysis`` and
    ``run_monte_carlo_stress`` on one replay of a CPU generator's draws:
    every figure on the card within BT_REL of the CPU's.  Then each timed
    on the card's own generator (one warm call, the median of
    ``timed_runs``); the simulator's mean max drawdown on its own draws
    within 4 standard errors of the replay's."""
    import numpy as np

    from pde_tpu_torch.backtest.analysis import MonteCarloSimulator
    from pde_tpu_torch.validation.statistical_tests import BootstrapAnalysis
    from pde_tpu_torch.validation.stress_testing import StressTestEngine

    cpu = torch.device("cpu")
    rets = bt_returns()
    out, ok = {}, True
    for seed, method in enumerate(("shuffle", "block")):
        sim = {d: MonteCarloSimulator(BT_SIMS, method, BT_BLOCK, seed=seed, device=d)
               for d in (dev, cpu)}
        rep = cpu_replay(torch, 40 + seed)
        ref, got = (sim[d].run(rets, keep_paths=True, generator=rep) for d in (cpu, dev))
        figs = ("final_equity_percentiles", "max_drawdown_percentiles", "sharpe_percentiles")
        err = max(rel_err(list(getattr(got, k).values()), list(getattr(ref, k).values()))
                  for k in figs)
        err = max(err, rel_err([got.final_equity_mean, got.final_equity_std, got.prob_loss],
                               [ref.final_equity_mean, ref.final_equity_std, ref.prob_loss]),
                  rel_err(got.equity_paths, ref.equity_paths))
        _, walls = timed_walls(torch, dev, lambda: sim[dev].run(rets), timed_runs)
        own = path_drawdowns(sim[dev].run(rets, keep_paths=True).equity_paths)
        replay = path_drawdowns(ref.equity_paths)
        se = math.sqrt(own.var() / own.size + replay.var() / replay.size)
        good = bool(err <= BT_REL and abs(own.mean() - replay.mean()) <= 4.0 * se)
        ok = ok and good
        out[method] = dict(replay_max_rel_vs_cpu=err, mean_max_dd_own=float(own.mean()),
                           mean_max_dd_replay=float(replay.mean()), se=se,
                           wall_ms=statistics.median(walls) * 1e3, ok=good)

    boot = {d: BootstrapAnalysis(BT_BOOT, device=d) for d in (dev, cpu)}
    rep = cpu_replay(torch, 50)
    cis = {d: [boot[d].sharpe_confidence_interval(rets, generator=rep),
               boot[d].max_drawdown_confidence_interval(rets, generator=rep)]
           for d in (cpu, dev)}
    err = rel_err(cis[dev], cis[cpu])
    _, walls = timed_walls(torch, dev, lambda: (boot[dev].sharpe_confidence_interval(rets),
                                                boot[dev].max_drawdown_confidence_interval(rets)),
                           timed_runs)
    ok = ok and err <= BT_REL
    out["bootstrap"] = dict(n=BT_BOOT, sharpe_ci=cis[dev][0], max_dd_ci=cis[dev][1],
                            replay_max_rel_vs_cpu=err, wall_ms=statistics.median(walls) * 1e3)

    eng = {d: StressTestEngine(device=d) for d in (dev, cpu)}
    rep = cpu_replay(torch, 60)
    st = {d: eng[d].run_monte_carlo_stress(**BT_STRESS, generator=rep) for d in (cpu, dev)}
    err = rel_err([st[dev][k] for k in st[cpu]], list(st[cpu].values()))
    own, walls = timed_walls(torch, dev, lambda: eng[dev].run_monte_carlo_stress(**BT_STRESS),
                             timed_runs)
    ok = ok and err <= BT_REL
    out["stress"] = dict(**BT_STRESS, replay=st[dev], replay_max_rel_vs_cpu=err, own=own,
                         wall_ms=statistics.median(walls) * 1e3)
    emit(phase="backtest_monte_carlo", sims=BT_SIMS, returns=BT_BARS, block_size=BT_BLOCK, **out,
         ok=bool(ok))
    if not ok:
        raise AssertionError("the Monte-Carlo backtest statistics missed their gate")


def options_chain(torch):
    """CHAIN_DAYS x CHAIN_STRIKES calls and puts with mids from the converged
    Heston pricer (TRUE, S0, R, Q; float64 on the CPU) and 0.1% spreads;
    each expiry's strikes span +-CHAIN_WIDTH standard deviations of a 20%
    vol about the forward, rounded to cents, as listed chains widen with
    maturity."""
    from datetime import date, timedelta

    import numpy as np

    from pde_tpu_torch.data.options import OptionQuote
    from pde_tpu_torch.models import heston

    as_of = date(2026, 1, 5)
    cpu = torch.device("cpu")
    p = heston.HestonParams(*(torch.tensor(v, dtype=torch.float64) for v in TRUE.values()))
    quotes = []
    for days in CHAIN_DAYS:
        exp = as_of + timedelta(days=days)
        T = days / 365.0
        strikes = np.round(S0 * math.exp((R - Q) * T) * np.exp(
            CHAIN_WIDTH * 0.2 * math.sqrt(T) * np.linspace(-1.0, 1.0, CHAIN_STRIKES)), 2)
        for is_call in (True, False):
            mids = heston.price_accurate(p, torch.as_tensor(strikes, device=cpu), days / 365.0,
                                         S0, R, Q, is_call).numpy()
            quotes += [OptionQuote(strike=float(k), expiration=exp,
                                   option_type="call" if is_call else "put",
                                   bid=float(m) * 0.999, ask=float(m) * 1.001, volume=100)
                       for k, m in zip(strikes, mids)]
    return quotes, as_of


def phase_options_surface(torch, dev, timed_runs=1):
    """``OptionsChainProcessor.build_surface`` on the chain, then
    ``fit_svi_smile`` on each expiry: IVs within IV_ABS of the CPU's, SVI
    parameters within SVI_ABS, each fit within SVI_RMSE in total variance;
    one warm run, then the median of ``timed_runs`` (one: the twelve LM
    fits take ~9 s a run, all host dispatch)."""
    import numpy as np

    from pde_tpu_torch.data.options import OptionsChainProcessor

    quotes, as_of = options_chain(torch)
    expiries = sorted({q.expiration for q in quotes})

    def run(d):
        proc = OptionsChainProcessor(R, Q, device=d)
        surface = proc.build_surface(quotes, S0, as_of=as_of)
        return surface, [proc.fit_svi_smile(surface, e) for e in expiries]

    (surface, fits), walls = timed_walls(torch, dev, lambda: run(dev), timed_runs)
    ref_surface, ref_fits = run(torch.device("cpu"))
    same = [(p.strike, p.expiration, p.option_type) for p in surface.points] == [
        (p.strike, p.expiration, p.option_type) for p in ref_surface.points]
    iv_err = float(np.max(np.abs(np.array([p.implied_vol for p in surface.points])
                                 - np.array([p.implied_vol for p in ref_surface.points]))))
    names = ("a", "b", "rho", "m", "sigma")
    svi_err = max(abs(f.params[k] - g.params[k]) for f, g in zip(fits, ref_fits) for k in names)
    rmse = []
    for e, f in zip(expiries, fits):
        pts = [p for p in surface.points if p.expiration == e]
        T = surface._expiry_times[e]
        k = np.log(np.array([p.strike for p in pts]) / (S0 * math.exp((R - Q) * T)))
        w = np.array([p.implied_vol**2 * T for p in pts])
        a, b, rho, m, sig = (f.params[n] for n in names)
        fitted = a + b * (rho * (k - m) + np.sqrt((k - m) ** 2 + sig**2))
        rmse.append(float(np.sqrt(np.mean((fitted - w) ** 2))))
    ok = bool(same and iv_err <= IV_ABS and svi_err <= SVI_ABS and max(rmse) < SVI_RMSE)
    emit(phase="options_surface", quotes=len(quotes), points=len(surface.points),
         expiries=len(expiries), same_points_as_cpu=same, iv_max_abs_vs_cpu=iv_err,
         svi_max_abs_vs_cpu=svi_err, svi_total_variance_rmse=rmse,
         wall_s=statistics.median(walls), ok=ok)
    if not ok:
        raise AssertionError("the options surface missed its gate")


def phase_linalg(torch, dev, reps=20):
    """``ewma_covariance`` over (2,520, 100) returns, ``make_positive_definite``
    of a 500 x 500 indefinite matrix and ``solve_positive_definite`` of its
    repair (four right-hand sides), each within BT_REL of the CPU (relative
    to the largest entry); medians of ``reps`` warm calls."""
    import numpy as np

    from pde_tpu_torch.utils import linalg

    rng = np.random.default_rng(41)
    returns = rng.normal(0.0, 0.01, EWMA_SHAPE) @ (np.eye(EWMA_SHAPE[1]) + 0.05 * rng.normal(
        size=(EWMA_SHAPE[1], EWMA_SHAPE[1])))
    a = rng.normal(size=(PD_N, PD_N))
    a = a @ a.T / PD_N - 0.5 * np.eye(PD_N)   # symmetric, some eigenvalues below 0
    b = rng.normal(size=(PD_N, 4))
    spd = linalg.make_positive_definite(a, 1e-2, device="cpu").numpy()   # condition ~350
    calls = {
        "ewma_covariance": lambda d: linalg.ewma_covariance(returns, device=d),
        "make_positive_definite": lambda d: linalg.make_positive_definite(a, 1e-2, device=d),
        "solve_positive_definite": lambda d: linalg.solve_positive_definite(spd, b, device=d),
    }
    out, ok = {}, True
    for name, call in calls.items():
        got, walls = timed_walls(torch, dev, lambda: call(dev), reps)
        want = call(torch.device("cpu")).numpy()
        err = float(np.abs(got.cpu().numpy() - want).max() / np.abs(want).max())
        ok = ok and err <= BT_REL and bool(np.isfinite(want).all())
        out[name] = dict(max_rel_vs_cpu=err, ms=statistics.median(walls) * 1e3)
    emit(phase="linalg", ewma=list(EWMA_SHAPE), pd_n=PD_N, **out, ok=bool(ok))
    if not ok:
        raise AssertionError("the linear algebra missed its gate")


BACKTEST_PHASES = (phase_strategy_optimizer, phase_rolling_walk_forward,
                   phase_backtest_monte_carlo, phase_options_surface, phase_linalg)


def backtest_profile_rows(torch, dev):
    """The universe's optimization and the shuffled Monte Carlo, on the card."""
    from pde_tpu_torch.backtest.analysis import MonteCarloSimulator
    from pde_tpu_torch.backtest.optimizer import StrategyOptimizer

    groups, rets = bt_universe(), bt_returns()
    opt = StrategyOptimizer(device=dev)
    sim = MonteCarloSimulator(BT_SIMS, "shuffle", device=dev)
    return {"strategy_optimizer": lambda: opt.run_optimization(groups),
            "backtest_monte_carlo": lambda: sim.run(rets)}


# The command line (``pde_tpu_torch.cli``): each subcommand through
# ``cli.main`` in this process, at the CLI's own defaults, its standard
# output captured and parsed.  The numeric subcommands run on the card in
# float32 and on the CPU in float64 and float32, and every printed number
# is held by the card gate, one gate for each field of the output (over a
# list's items): a badly conditioned field, such as ``rates``' float32
# Hull-White refit of the cap-vol strip, then widens its own gate only.  The
# calibration, Monte Carlo and strategy subcommands and the trading system
# run on the card against their own gates (scan and sector-portfolio in
# float64, equal to the CPU's output).  Only ``price --method pde``,
# ``pide`` and ``rates --bermudan`` launch a kernel (K5); the Merton
# ``pide`` strip at 512 x 128 exactly as often as
# ``phase_pide_merton_strip``.  The Greeks the PDE and PIDE read off their
# grids (``delta``, ``gamma``: central differences of float32 values, whose
# rounding a second difference divides by ds^2 ~ 1) are held within the
# grid Greeks' own accuracy, 3e-4 of float64 (tests/test_pide.py:141-142),
# and not by the card gate.  ``price --method greeks`` runs on one strike,
# as tests/test_system.py does: each strike is one autograd march.
K5_NEEDS = ("K5", "K5-smem")
GRID_GREEKS, GRID_GREEKS_ATOL = ("delta", "gamma"), 3e-4
CLI_NUMERIC = (
    ("price_cf", ("price", "--method", "cf"), ()),
    ("price_pde", ("price", "--method", "pde"), K5_NEEDS),
    ("price_pde_american_put", ("price", "--method", "pde", "--put", "--american"), K5_NEEDS),
    ("price_digital", ("price", "--method", "digital"), ()),
    ("price_greeks", ("price", "--method", "greeks", "--strikes", "100"), ()),
    ("varswap", ("varswap",), ()),
    ("vix", ("vix", "--strikes", "18", "22", "26"), ()),
    ("rates", ("rates", "--bermudan", "--cap-vols", "0.25", "0.23", "0.22", "0.21"), K5_NEEDS),
    ("credit", ("credit",), ()),
    ("pide_merton", ("pide",), K5_NEEDS),
    ("pide_kou_american_put", ("pide", "--jumps", "kou", "--put", "--american"), K5_NEEDS),
    ("fwdstart", ("fwdstart",), ()),
)
# every subcommand the smoke runs on the card: its argv and torch's default
# dtype there
CLI_RUNS = {
    **{name: (argv, "float32") for name, argv, _ in CLI_NUMERIC},
    "calibrate": (("calibrate",), "float32"),
    "fwdstart_mc": (("fwdstart", "--mc-check"), "float32"),
    "scan": (("scan",), "float64"),
    "sector_portfolio": (("sector-portfolio",), "float64"),
    "backtest": (("backtest", "--json"), "float32"),
    "status": (("status",), "float32"),
    "portfolio": (("portfolio",), "float32"),
    "demo": (("demo",), "float32"),
}


def run_cli(torch, dev, argv, dtype):
    """``pde_tpu_torch.cli.main(argv)`` on ``dev`` under torch's default
    dtype ``dtype``: (exit code, standard output, wall seconds)."""
    import contextlib
    import io

    from pde_tpu_torch import cli

    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    buf = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--device", str(dev), *argv])
        sync(torch, dev)
        wall = time.perf_counter() - t0
    finally:
        torch.set_default_dtype(old)
    return rc, buf.getvalue(), wall


def run_named(torch, dev, name, dtype=None):
    """``CLI_RUNS[name]`` on ``dev``, in its own dtype unless ``dtype``."""
    argv, dt = CLI_RUNS[name]
    return run_cli(torch, dev, argv, dtype or getattr(torch, dt))


def cli_json(torch, dev, name, dtype=None):
    rc, out, wall = run_named(torch, dev, name, dtype)
    if rc != 0:
        raise AssertionError(f"cli {name} exited {rc} on {dev}")
    return json.loads(out), wall


def json_leaves(out, path=""):
    """Every leaf of a parsed JSON output as (path, value), in order."""
    if isinstance(out, dict):
        return [leaf for k, v in out.items() for leaf in json_leaves(v, f"{path}.{k}")]
    if isinstance(out, list):
        return [leaf for i, v in enumerate(out) for leaf in json_leaves(v, f"{path}[{i}]")]
    return [(path, out)]


def leaf_field(path):
    """The field a leaf is, over a list's items: ``.curve[3].df`` ->
    ``.curve[].df``."""
    return re.sub(r"\[\d+\]", "[]", path)


def cli_phase(name, needs):
    """A numeric subcommand's phase: the card's float32 output held by the
    card gate against the CPU's float64 run, one gate for each field of
    the output, the CPU's float32 run setting each (a grid march's
    ``GRID_GREEKS`` within ``GRID_GREEKS_ATOL``); text and flags equal to
    the CPU's float64 run's."""
    def phase(torch, dev):
        cpu = torch.device("cpu")
        card, wall = cli_json(torch, dev, name)
        ref, cpu32 = (cli_json(torch, cpu, name, dt)[0] for dt in (torch.float64, torch.float32))
        leaves = [json_leaves(x) for x in (card, ref, cpu32)]
        if not [p for p, _ in leaves[0]] == [p for p, _ in leaves[1]] == [p for p, _ in leaves[2]]:
            raise AssertionError(f"cli {name}: the outputs differ in shape")
        number = [isinstance(v, (int, float)) and not isinstance(v, bool) for _, v in leaves[1]]
        greek = [bool(needs) and p.rsplit(".", 1)[-1].split("[")[0] in GRID_GREEKS
                 for p, _ in leaves[1]]
        gated = [i for i, (n, g) in enumerate(zip(number, greek)) if n and not g]
        gates, ok = {}, True
        for field in dict.fromkeys(leaf_field(leaves[1][i][0]) for i in gated):
            idx = [i for i in gated if leaf_field(leaves[1][i][0]) == field]
            vec = [torch.tensor([float(leaf[i][1]) for i in idx], dtype=torch.float64)
                   for leaf in leaves]
            fields, held = card_gate(*vec)
            held = held and bool(torch.isfinite(vec[0]).all())
            gates[field] = dict(numbers=len(idx), **fields, ok=held)
            ok = ok and held
        greek_err = max([abs(v - w) for (_, v), (_, w), g in zip(leaves[0], leaves[1], greek)
                         if g], default=0.0)
        other = [(p, v, w) for (p, v), (_, w), n in zip(leaves[0], leaves[1], number)
                 if not n and v != w]
        ok = ok and greek_err <= GRID_GREEKS_ATOL and not other
        emit(phase=f"cli_{name}", argv=list(CLI_RUNS[name][0]), dtype="float32",
             numbers=len(gated), gates=gates, grid_greeks=sum(greek),
             grid_greeks_max_abs_vs_cpu_f64=greek_err, differing_text=other,
             first_call_s=wall, ok=ok)
        if not ok:
            raise AssertionError(f"cli {name} missed its gate")
    phase.__name__ = f"phase_cli_{name}"
    return phase


def phase_cli_calibrate(torch, dev):
    """``calibrate`` at its defaults (11 x 3 quotes, DE 100/15), float32 on
    the card, at bench.py:274's gate."""
    import numpy as np

    out, wall = cli_json(torch, dev, "calibrate")
    n = out["fit_quality"]["n_options"]
    rel_rmse = float(np.sqrt(2.0 * out["convergence"]["local_cost"] / n))
    ok = out["success"] and abs(out["params"]["v0"] - TRUE["v0"]) < 0.02 and rel_rmse < 0.05
    emit(phase="cli_calibrate", params=out["params"], n_options=n, rel_rmse=rel_rmse,
         first_call_s=wall, ok=ok)
    if not ok:
        raise AssertionError("cli calibrate missed bench.py's gate")


def phase_cli_fwdstart_mc(torch, dev):
    """``fwdstart --mc-check`` (65,536 QE paths x 64 steps a strike, a
    generator seeded 0 on the card), float32: each MC price within 4 of its
    own s.e. of the analytic price."""
    out, wall = cli_json(torch, dev, "fwdstart_mc")
    rows = out["forward_starts"]
    z = [abs(r["mc_price"] - r["price"]) / r["mc_stderr"] for r in rows]
    ok = all(zi <= 4.0 for zi in z)
    emit(phase="cli_fwdstart_mc", rows=rows, z=z, first_call_s=wall, ok=ok)
    if not ok:
        raise AssertionError("cli fwdstart --mc-check missed its 4 s.e. gate")


def phase_cli_equal_cpu(torch, dev):
    """``scan`` and ``sector-portfolio`` at their defaults in float64 on the
    card, ``backtest`` in float32: each output equal to the CPU's."""
    cpu = torch.device("cpu")
    walls, ok = {}, True
    for name in ("scan", "sector_portfolio", "backtest"):
        rc, card, walls[name] = run_named(torch, dev, name)
        rc_cpu, ref, _ = run_named(torch, cpu, name)
        ok = ok and rc == rc_cpu == 0 and card == ref
    emit(phase="cli_equal_cpu", first_call_s=walls, ok=ok)
    if not ok:
        raise AssertionError("cli scan, sector-portfolio or backtest differs from the CPU")


def phase_cli_system(torch, dev):
    """``status`` (every component initialised on the card), ``portfolio``
    and ``demo`` (exit 0, the Heston fit's rmse under 0.05), float32."""
    status, w_status = cli_json(torch, dev, "status")
    rc, _, w_port = run_named(torch, dev, "portfolio")
    rc_demo, demo, w_demo = run_named(torch, dev, "demo")
    rmse = float(re.search(r"rmse=([0-9.]+)", demo).group(1))
    ok = (status["initialized"] and bool(status["components"])
          and all(status["components"].values()) and rc == 0 and rc_demo == 0 and rmse < 0.05)
    emit(phase="cli_system", components=status["components"], demo_rmse=rmse,
         first_call_s=dict(status=w_status, portfolio=w_port, demo=w_demo), ok=ok)
    if not ok:
        raise AssertionError("cli status, portfolio or demo failed on the card")


CLI_PATHS = (*((cli_phase(name, needs), needs) for name, _, needs in CLI_NUMERIC),
             (phase_cli_calibrate, ()), (phase_cli_fwdstart_mc, ()),
             (phase_cli_equal_cpu, ()), (phase_cli_system, ()))


def phase_cli_seconds(torch, dev):
    """Each subcommand's wall on the card, second call (the first ran in
    its phase), and the total."""
    seconds = {}
    for name in CLI_RUNS:
        rc, _, seconds[name] = run_named(torch, dev, name)
        if rc != 0:
            raise AssertionError(f"cli {name} exited {rc} on its second call")
    emit(phase="cli_seconds", seconds=seconds, total_s=sum(seconds.values()))


def cli_profile_rows(torch, dev):
    """``demo`` and ``price --method pde`` through the command line, float32
    on the card."""
    return {"cli_demo": lambda: run_named(torch, dev, "demo"),
            "cli_price_pde": lambda: run_named(torch, dev, "price_pde")}


# -- the parallel layer (ROADMAP A.7): a world-size-1 NCCL group --------------

PARALLEL_BS = dict(n_space=200, n_time=50, is_call=False, american=True)
# K5 launches predicted from the code, one call each (PERF.md, PR 19): the
# Black-Scholes march solves one (1, 200) batch a step (at one rank the
# partitioned solve is the local solve of d); the Heston march one (50, 100) S
# batch and one (100, 50) v batch a step; the distributed solve one batch
PARALLEL_LAUNCHES = {"phase_parallel_bs": 50, "phase_parallel_heston": 2 * 100,
                     "phase_parallel_dist_tridiag": 1}
PARALLEL_TRIDIAG = (50, 100)
PARALLEL_CAL_U, PARALLEL_STEPS = 4, 3
PARALLEL_X0 = (1.5, 0.06, 0.4, -0.5, 0.06)
GROUP = {}  # the process group's store directory, once a run


def world_mesh(torch, dev, axis_names=("grid",)):
    """A mesh over the world of one rank: the NCCL group on the card (gloo
    only for a CPU rehearsal), made once through the port's own
    ``initialize_distributed`` on a file store in a temporary directory (no
    port, no network), and ``make_mesh``."""
    import tempfile
    from datetime import timedelta

    from pde_tpu_torch.parallel import initialize_distributed, make_mesh

    if "store" not in GROUP:
        GROUP["store"] = tempfile.mkdtemp(prefix="pde_tpu_torch_group_")
        world = initialize_distributed(f"file://{GROUP['store']}/store", 1, 0, device=dev,
                                       timeout=timedelta(seconds=120))
        if world != 1:
            raise AssertionError(f"the group has {world} ranks, not 1")
    return make_mesh(1, axis_names, (1,) * len(axis_names),
                     device_type="cuda" if dev.type == "cuda" else "cpu")


def close_group():
    """Destroy the process group and its store, if this run made them."""
    import shutil

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    if "store" in GROUP:
        shutil.rmtree(GROUP.pop("store"), ignore_errors=True)


def phase_parallel_group(torch, dev):
    """The group and mesh the parallel phases run on: NCCL on the card, one
    rank, and one real collective through it."""
    import torch.distributed as dist

    mesh = world_mesh(torch, dev, ("dp", "quotes"))
    x = torch.full((4,), 2.0, device=dev)
    dist.all_reduce(x)
    sync(torch, dev)
    ok = (float(x.sum()) == 8.0 and dist.get_world_size() == 1
          and (dev.type != "cuda" or dist.get_backend() == "nccl")
          and mesh.device_type == dev.type and tuple(mesh.mesh_dim_names) == ("dp", "quotes"))
    emit(phase="parallel_group", backend=dist.get_backend(), world=dist.get_world_size(),
         mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)), mesh_device=mesh.device_type,
         all_reduce=float(x.sum()), ok=ok)
    if not ok:
        raise AssertionError("the parallel layer's group is not the one asked for")


def _gate_solve(torch, card, cpu64, cpu32, fields):
    """The card gate on the price and the grid of a sharded solve."""
    out, ok = {}, True
    for f in fields:
        g, good = card_gate(getattr(card, f), getattr(cpu64, f), getattr(cpu32, f))
        out[f], ok = g, ok and good and bool(torch.isfinite(getattr(card, f)).all())
    return out, ok


def phase_parallel_heston(torch, dev):
    """``sharded_heston_solve`` at bench_full.py:787's 100x50x100 (q 0.02),
    float32, on the one-rank grid mesh: the card gate against
    ``heston_adi.solve`` in float64 on the CPU (its float32 run setting the
    gate), price and grid.  Returns the card's result."""
    from pde_tpu_torch.parallel import sharded_heston_solve
    from pde_tpu_torch.solvers import heston_adi

    cpu, p = torch.device("cpu"), heston_params()
    t0 = time.perf_counter()
    card = sharded_heston_solve(world_mesh(torch, dev), p, 100.0, dtype=torch.float32)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    refs = [heston_adi.solve(p, 100.0, device=cpu, dtype=dt)
            for dt in (torch.float64, torch.float32)]
    gates, ok = _gate_solve(torch, card, *refs, ("price", "prices"))
    emit(phase="parallel_heston", grid=list(GRID.values()), dtype="float32",
         price=float(card.price), price_cpu_f64=float(refs[0].price), gates=gates,
         greeks_abs_vs_cpu_f64={g: abs(float(getattr(card, g)) - float(getattr(refs[0], g)))
                                for g in ("delta", "gamma", "vega", "theta")},
         first_call_wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("sharded_heston_solve missed the card gate")
    return card


def phase_parallel_bs(torch, dev):
    """``sharded_bs_solve`` of the American put by projection at 200x50,
    float32, on the one-rank grid mesh: the card gate against
    ``bs_pde.solve`` in float64 on the CPU.  Returns the card's result."""
    from pde_tpu_torch.parallel import sharded_bs_solve
    from pde_tpu_torch.solvers import bs_pde

    cpu, p = torch.device("cpu"), bs_pde.BSPDEParams(**PARALLEL_BS)
    card = sharded_bs_solve(world_mesh(torch, dev), p, 100.0, dtype=torch.float32)
    sync(torch, dev)
    refs = [bs_pde.solve(p, 100.0, device=cpu, dtype=dt) for dt in (torch.float64, torch.float32)]
    gates, ok = _gate_solve(torch, card, *refs, ("price", "prices"))
    emit(phase="parallel_bs", grid=[p.n_space, p.n_time], dtype="float32",
         price=float(card.price), price_cpu_f64=float(refs[0].price), gates=gates, ok=ok)
    if not ok:
        raise AssertionError("sharded_bs_solve missed the card gate")
    return card


def phase_parallel_dist_tridiag(torch, dev):
    """``dist_tridiagonal_solve`` of a seeded (50, 100) float32 batch on the
    one-rank grid mesh, against ``ops.tridiag.thomas`` on the card."""
    from pde_tpu_torch.ops import tridiag
    from pde_tpu_torch.parallel import dist_tridiagonal_solve

    lower, diag, upper, rhs = seeded_system(torch, dev, *PARALLEL_TRIDIAG)
    X = dist_tridiagonal_solve(lower, diag, upper, rhs, world_mesh(torch, dev))
    compare(torch, dev, X, tridiag.thomas(lower, diag, upper, rhs), kernel="K5",
            case="dist_tridiagonal_solve", B=PARALLEL_TRIDIAG[0], n=PARALLEL_TRIDIAG[1])


def phase_parallel_vs_single(torch, dev, heston, bs):
    """The sharded solves against the single-device port on the card, same
    float32 inputs: price and grid within 1e-7 + 1e-4 |p| (outside the
    counted paths: the single-device solves launch K5 too)."""
    from pde_tpu_torch.solvers import bs_pde, heston_adi

    singles = {"heston": (heston, heston_adi.solve(heston_params(), 100.0, device=dev)),
               "bs": (bs, bs_pde.solve(bs_pde.BSPDEParams(**PARALLEL_BS), 100.0, device=dev))}
    out, ok = {}, True
    for name, (sharded, single) in singles.items():
        for f in ("price", "prices"):
            a, b = getattr(sharded, f).double(), getattr(single, f).double()
            over = float(((a - b).abs() / (PANEL_ATOL + PANEL_RTOL * b.abs())).max())
            out[f"{name}.{f}"] = dict(max_abs=float((a - b).abs().max()), max_over_limit=over)
            ok = ok and over <= 1.0
    emit(phase="parallel_vs_single_device", limit=f"{PANEL_ATOL} + {PANEL_RTOL} |p|",
         fields=out, ok=ok)
    if not ok:
        raise AssertionError("a sharded solve strays from the single-device port on the card")


def _surface_108(torch, dev, dtype):
    """bench.py's 108-quote surface as (strikes, maturities, prices)."""
    import numpy as np

    from pde_tpu_torch.calibrate.heston import HestonCalibrator

    data = HestonCalibrator.generate_synthetic_data(
        S0=S0, r=R, q=Q, **TRUE, strikes=np.linspace(85.0, 115.0, 12),
        maturities=np.linspace(0.25, 1.5, 9), device=dev, dtype=dtype)
    return (np.asarray(data["strike"]), np.asarray(data["maturity"]),
            np.asarray(data["mid_price"]))


def phase_parallel_calibration_step(torch, dev):
    """Three ``sharded_calibration_step``s on the 108-quote surface, float32,
    on the one-rank (dp, quotes) mesh, from PARALLEL_X0: the last cost by
    the card gate against three iterations of the single-device port's LM
    (``levenberg_marquardt``, the same damped step) in float64 on the CPU,
    its float32 run setting the gate; the costs never rise."""
    import numpy as np

    from pde_tpu_torch.calibrate.heston import HestonCalibrator
    from pde_tpu_torch.calibrate.lm import levenberg_marquardt
    from pde_tpu_torch.parallel import sharded_calibration_step
    from pde_tpu_torch.parallel.mesh import _price_population

    k, t, y = _surface_108(torch, dev, torch.float64)
    bounds = HestonCalibrator.DEFAULT_BOUNDS
    lower = np.array([bounds[n][0] for n in ("kappa", "theta", "sigma", "rho", "v0")])
    upper = np.array([bounds[n][1] for n in ("kappa", "theta", "sigma", "rho", "v0")])
    step = sharded_calibration_step(world_mesh(torch, dev, ("dp", "quotes")), lower, upper)
    f32 = torch.float32
    x = torch.tensor([PARALLEL_X0], dtype=f32, device=dev)
    lam = torch.full((1,), 1e-3, dtype=f32, device=dev)
    costs = []
    for _ in range(PARALLEL_STEPS):
        x, cost, lam = step(x, k[None], t[None], y[None], lam, S0, R, Q)
        costs.append(cost[0])
    card = torch.stack(costs)

    def lm_costs(dtype):
        c = torch.device("cpu")
        kk, tt, yy = (torch.as_tensor(a, dtype=dtype) for a in (k, t, y))

        def res(xv):
            prices = torch.clamp_min(_price_population(xv, kk, tt, S0, R, Q), 1e-10)
            return (prices - yy) / yy

        x0 = torch.tensor(PARALLEL_X0, dtype=dtype, device=c)
        lo, hi = (torch.as_tensor(a, dtype=dtype) for a in (lower, upper))
        return levenberg_marquardt(res, x0, lo, hi, max_iter=PARALLEL_STEPS).cost[None]

    ref64, ref32 = lm_costs(torch.float64), lm_costs(f32)
    gate, ok = card_gate(card[-1:], ref64, ref32)
    c = card.double().cpu()
    ok = ok and bool(torch.isfinite(c).all()) and bool((c[1:] <= c[:-1]).all())
    emit(phase="parallel_calibration_step", n_quotes=int(k.shape[0]), steps=PARALLEL_STEPS,
         dtype="float32", costs=c.tolist(), last_cost_cpu_f64=float(ref64[0]), gate=gate,
         x=x[0].cpu().double().tolist(), ok=ok)
    if not ok:
        raise AssertionError("sharded_calibration_step missed its gate")


def phase_parallel_calibrate_batch(torch, dev):
    """``calibrate_batch(mesh=...)`` of U = 4 copies of the 108-quote surface
    (DE 100/15, LM 60, float32) on the one-rank (dp, quotes) mesh: equal to
    the unmeshed call (the same draws, the same generations), every surface
    at bench.py:274's gate."""
    import numpy as np

    from pde_tpu_torch.calibrate.heston import HestonCalibrator

    k, t, y = _surface_108(torch, dev, torch.float32)
    tile = lambda a: np.tile(a, (PARALLEL_CAL_U, 1))  # noqa: E731
    book = (tile(k), tile(t), tile(y), np.full(PARALLEL_CAL_U, S0))
    # "cuda" with no index, as a user writes it: the mesh's cuda:<current>
    cal = HestonCalibrator(seed=42, device="cuda", dtype=torch.float32, **BUDGET)
    mesh = world_mesh(torch, dev, ("dp", "quotes"))
    t0 = time.perf_counter()
    meshed = cal.calibrate_batch(*book, R, Q, mesh=mesh)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    plain = cal.calibrate_batch(*book, R, Q)
    diffs = {f: float((meshed[f].double() - plain[f].double()).abs().max()) for f in meshed}
    params = meshed["params"].cpu().double().numpy()
    rel_rmse = np.sqrt(2.0 * meshed["cost"].cpu().double().numpy() / k.shape[0])
    ok = (all(d == 0.0 for d in diffs.values())
          and bool(np.all(np.abs(params[:, 4] - TRUE["v0"]) < 0.02) and np.all(rel_rmse < 0.05)))
    emit(phase="parallel_calibrate_batch", surfaces=PARALLEL_CAL_U, dtype="float32",
         max_abs_meshed_vs_unmeshed=diffs, v0=params[:, 4].tolist(),
         rel_rmse=rel_rmse.tolist(), gate="equal to the unmeshed fit; bench.py:274 on each",
         meshed_wall_s=wall, de_generations=meshed["de_n_iter"].tolist(), ok=ok)
    if not ok:
        raise AssertionError("calibrate_batch(mesh=...) is not the unmeshed fit")


def phase_parallel_mc(torch, dev):
    """``price_european_mc_sharded`` (2^17 x 64) and
    ``price_american_lsm_sharded`` (2^16 x 64), float32 on the one-rank
    mesh (seed 7), each within 4 s.e. of the single-device pricer
    (``heston_mc.price_european_mc``, ``lsm.price_american_lsm``) on its own
    generator."""
    from pde_tpu_torch.models import heston_mc
    from pde_tpu_torch.parallel import price_american_lsm_sharded, price_european_mc_sharded
    from pde_tpu_torch.solvers import lsm

    p32 = fourier_params(torch, dev, torch.float32, "heston")
    mesh = world_mesh(torch, dev, ("paths",))
    gen = torch.Generator(device=dev).manual_seed(8)
    eu = dict(rate=R, dividend=Q, n_steps=MC_STEPS, n_paths=MC_PATHS)
    am = dict(rate=R, is_call=False, n_steps=MC_STEPS, n_paths=LSM_PATHS)
    runs = {
        "european": (price_european_mc_sharded(p32, 100.0, 1.0, S0, 7, mesh, **eu),
                     heston_mc.price_european_mc(p32, 100.0, 1.0, S0, gen, **eu)),
        "american": (price_american_lsm_sharded(p32, 100.0, 1.0, S0, 7, mesh, **am),
                     lsm.price_american_lsm(p32, 100.0, 1.0, S0, gen, **am)),
    }
    out, ok = {}, True
    for name, ((p, se), (p1, se1)) in runs.items():
        p, se, p1, se1 = float(p), float(se), float(p1), float(se1)
        z = abs(p - p1) / (se * se + se1 * se1) ** 0.5
        out[name] = dict(sharded=p, stderr=se, single_device=p1, single_stderr=se1, z=z)
        ok = ok and z <= MC_Z
    emit(phase="parallel_mc", dtype="float32", runs=out, gate=f"|z| <= {MC_Z}", ok=ok)
    if not ok:
        raise AssertionError("a sharded Monte Carlo pricer strays from its single-device twin")


PARALLEL_PATHS = ((phase_parallel_group, ()), (phase_parallel_heston, ("K5", "K5-smem")),
                  (phase_parallel_bs, ("K5", "K5-smem")),
                  (phase_parallel_dist_tridiag, ("K5", "K5-smem")),
                  (phase_parallel_calibration_step, ()), (phase_parallel_calibrate_batch, ()),
                  (phase_parallel_mc, ()))


def parallel_rows(torch, dev, reps=5):
    """The sharded solves' walls on the card, median of ``reps`` warm calls,
    beside the single-device port's (outside the counted paths)."""
    from pde_tpu_torch.parallel import sharded_bs_solve, sharded_heston_solve
    from pde_tpu_torch.solvers import bs_pde, heston_adi

    mesh, p, pb = world_mesh(torch, dev), heston_params(), bs_pde.BSPDEParams(**PARALLEL_BS)
    rows = {"sharded_heston_solve_s": lambda: sharded_heston_solve(mesh, p, 100.0,
                                                                   dtype=torch.float32),
            "heston_adi_solve_s": lambda: heston_adi.solve(p, 100.0, device=dev),
            "sharded_bs_solve_s": lambda: sharded_bs_solve(mesh, pb, 100.0, dtype=torch.float32),
            "bs_pde_solve_s": lambda: bs_pde.solve(pb, 100.0, device=dev)}
    walls = {k: statistics.median(timed_walls(torch, dev, fn, reps)[1]) for k, fn in rows.items()}
    emit(phase="parallel_rows", reps=reps, **walls)


# -- the services facade and the health manager (ROADMAP A.6f) ---------------

def _service_steps(torch, d, dtype, workdir, label):
    """Each of the four service steps once on ``d`` (the simulated provider,
    seed 3, a fresh sqlite file in ``workdir``): statuses, stored signals and
    walls."""
    import os

    from pde_tpu_torch import services
    from pde_tpu_torch.data.providers import SimulatedDataProvider
    from pde_tpu_torch.database.db import TimeSeriesDB

    db = TimeSeriesDB(os.path.join(workdir, f"services_{label}.db"))
    prov = SimulatedDataProvider(seed=3, device=d, dtype=dtype)
    where = dict(device=d, dtype=dtype)
    steps = {
        "data-ingestion": lambda: services.ingestion_step(provider=prov, db=db,
                                                          symbols=["SPY", "QQQ"], **where),
        "signals": lambda: services.signals_step(provider=prov, db=db,
                                                 symbols=["SPY", "QQQ", "IWM"], **where),
        "calibration": lambda: services.calibration_step(provider=prov, db=db, symbols=["SPY"],
                                                         **where),
        "execution": lambda: services.execution_step(symbols=["SPY"], n_ticks=40, **where),
    }
    out, walls = {}, {}
    for name, fn in steps.items():
        t0 = time.perf_counter()
        out[name] = fn()
        sync(torch, d)
        walls[name] = time.perf_counter() - t0
    signals = {sym: [(s["signal_type"], s["payload"]) for s in db.query_signals(asset=sym)]
               for sym in ("SPY", "QQQ", "IWM")}
    return out, signals, walls


def phase_services(torch, dev):
    """The four service steps once on the card (float32) and once on the
    CPU (float64), each against a temporary sqlite file, in a temporary
    working directory (the trading system's default database): equal
    statuses and the same stored candidates; then the ``HealthManager``
    with the three synthetic probes (the calibration probe fitting on the
    card), all healthy."""
    import os
    import tempfile

    from pde_tpu_torch.monitoring import health

    here = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="pde_tpu_torch_services_") as workdir:
        os.chdir(workdir)
        try:
            card, card_signals, walls = _service_steps(torch, dev, torch.float32, workdir,
                                                       "card")
            cpu, cpu_signals, cpu_walls = _service_steps(torch, torch.device("cpu"),
                                                         torch.float64, workdir, "cpu")
        finally:
            os.chdir(here)
    mgr = health.HealthManager()
    for check in (health.SyntheticOrderFlowProbe(), health.SyntheticDataFeedProbe(),
                  health.SyntheticCalibrationProbe(device=dev, dtype=torch.float32)):
        mgr.register(check)
    ready = mgr.readiness()
    same_signals = {sym: [t for t, _ in card_signals[sym]] == [t for t, _ in cpu_signals[sym]]
                    for sym in card_signals}
    # the execution chunk's worst signal-to-order latency is a wall time
    statuses = lambda o: {k: v for k, v in o.items() if k != "execution"}  # noqa: E731
    ok = (statuses(card) == statuses(cpu) and all(same_signals.values())
          and card["execution"]["orders_submitted"] == cpu["execution"]["orders_submitted"]
          and ready["status"] == "ok"
          and mgr.overall == health.HealthState.HEALTHY)
    emit(phase="services", dtype="float32", statuses=card, cpu_f64_statuses=cpu,
         stored_signals=card_signals, cpu_stored_signals=cpu_signals,
         health=ready, walls_s=walls, cpu_walls_s=cpu_walls, ok=ok)
    if not ok:
        raise AssertionError("a service step or probe disagrees with the CPU run")
    return walls


# -- the rest of the port: the C++ reference's Heston oracle, the native
# host bindings, the collective audit --------------------------------------

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                           "reference_pde_values.json")
GOLDEN_BASE = dict(kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, v0=0.04, r=0.05, q=0.0, T=1.0,
                   K=100.0, is_call=True)
# tests/test_golden_pde.py:83-105: case -> (parameters, golden key by result field)
GOLDEN_CASES = {
    "euro_call": ({}, {"price": "heston_pde_euro_call_price",
                       "delta": "heston_pde_euro_call_delta",
                       "gamma": "heston_pde_euro_call_gamma",
                       "vega": "heston_pde_euro_call_vega"}),
    "euro_put": (dict(is_call=False), {"price": "heston_pde_euro_put_price"}),
    "amer_put": (dict(is_call=False, american=True), {"price": "heston_pde_amer_put_price"}),
    "second_set": (dict(kappa=1.5, theta=0.09, sigma=0.5, rho=-0.5, v0=0.06, r=0.03, q=0.01,
                        T=0.5, K=110.0), {"price": "heston_pde2_euro_call_price"}),
}
GOLDEN_TOL = dict(price=1e-10, delta=1e-10, gamma=1e-10, vega=1e-9)
# K5 launches, read from the code: the native host phases hold one
# tridiagonal_solve at (50, 100) and one heston_adi.solve at 100x50x100 (two
# sweeps a step); the audit at one rank runs the Black-Scholes march at 64
# points for 2 and 3 steps (one launch a step), the Heston march at 32 x 8
# for 2 and 3 steps (two a step) and one distributed solve
NATIVE_LAUNCHES = {"phase_native_thomas": 1, "phase_native_heston_adi": 2 * GRID["n_time"],
                   "phase_native_ou": 0}
AUDIT_LAUNCHES = (2 + 3) + 2 * (2 + 3) + 1
NATIVE_OU = dict(speed=2.0, mean=6.0, sigma=0.4, T=4.0, n=1000)


def phase_golden_pde(torch, dev):
    """``heston_adi_ref.solve_reference`` in float64 on the card on the four
    cases of tests/test_golden_pde.py:83-105, against the C++ reference's
    own numbers (tests/golden/reference_pde_values.json) at 1e-10 (vega
    1e-9): the largest error of each field and each solve's wall."""
    from pde_tpu_torch.solvers import heston_adi, heston_adi_ref

    with open(GOLDEN_PATH) as fh:
        gold = json.load(fh)
    errs, walls, ok = {}, {}, True
    for name, (over, fields) in GOLDEN_CASES.items():
        p = heston_adi.HestonPDEParams(**{**GOLDEN_BASE, **over})
        t0 = time.perf_counter()
        res = heston_adi_ref.solve_reference(p, 100.0, device=dev)
        sync(torch, dev)
        walls[name] = time.perf_counter() - t0
        ok = ok and res.prices.dtype == torch.float64 and res.prices.device == dev
        for f, key in fields.items():
            err = abs(float(getattr(res, f)) - gold[key])
            errs[f] = max(errs.get(f, 0.0), err)
            ok = ok and err <= GOLDEN_TOL[f]
    emit(phase="golden_pde", dtype="float64", grid=[GRID["n_spot"], GRID["n_vol"],
                                                    GRID["n_time"]],
         max_abs_vs_golden=errs, tolerance=GOLDEN_TOL, solve_wall_s=walls, ok=ok)
    if not ok:
        raise AssertionError("solve_reference missed the C++ reference's golden numbers")


def phase_native_thomas(torch, dev):
    """``native.thomas_solve`` (float64 on the host) against K5 through
    ``tridiagonal_solve`` at (50, 100) on the card: the card gate, with the
    port's float32 ``thomas`` on the CPU setting it."""
    from pde_tpu_torch import native
    from pde_tpu_torch.ops import tridiag

    lower, diag, upper, rhs = seeded_system(torch, dev, *PARALLEL_TRIDIAG)
    card = tridiag.tridiagonal_solve(lower, diag, upper, rhs)
    sync(torch, dev)
    host = [t.detach().cpu().double() for t in (lower, diag, upper, rhs)]
    native.load()  # the host library's build at first use is not the call's
    t0 = time.perf_counter()
    ref = torch.as_tensor(native.thomas_solve(*(t.numpy() for t in host)))
    host_s = time.perf_counter() - t0
    fields, ok = card_gate(card, ref, tridiag.thomas(*(t.float() for t in host)))
    ok = ok and bool(torch.isfinite(card).all())
    emit(phase="native_thomas", B=PARALLEL_TRIDIAG[0], n=PARALLEL_TRIDIAG[1], dtype="float32",
         reference="native.thomas_solve, float64 on the host", **fields,
         native_wall_s=host_s, ok=ok)
    if not ok:
        raise AssertionError("K5 missed native.thomas_solve by the card gate")


def phase_native_heston_adi(torch, dev):
    """``native.heston_adi_solve`` (the independent float64 C++ Douglas
    march) against ``heston_adi.solve`` at 100x50x100 in float32 on the
    card (the scan route, K5): price and grid by the card gate, the port's
    float32 march on the CPU setting it."""
    from pde_tpu_torch import native
    from pde_tpu_torch.solvers import heston_adi

    p = heston_adi.HestonPDEParams(**GRID)
    native.load()
    t0 = time.perf_counter()
    card = heston_adi.solve(p, 100.0, device=dev, dtype=torch.float32)
    sync(torch, dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    price, grid = native.heston_adi_solve(p.kappa, p.theta, p.sigma, p.rho, p.v0, p.r, p.q,
                                          p.T, p.K, 100.0, n_spot=p.n_spot, n_vol=p.n_vol,
                                          n_time=p.n_time)
    host_s = time.perf_counter() - t0
    cpu32 = heston_adi.solve(p, 100.0, device=torch.device("cpu"), dtype=torch.float32)
    gates, ok = {}, True
    for f, ref in (("price", torch.tensor(price)), ("prices", torch.as_tensor(grid))):
        gates[f], good = card_gate(getattr(card, f), ref, getattr(cpu32, f))
        ok = ok and good and bool(torch.isfinite(getattr(card, f)).all())
    emit(phase="native_heston_adi", grid=list(GRID.values()), dtype="float32",
         reference="native.heston_adi_solve, float64 on the host", price=float(card.price), price_native_f64=price, gates=gates, card_wall_s=card_s,
         native_wall_s=host_s, ok=ok)
    if not ok:
        raise AssertionError("heston_adi.solve missed native.heston_adi_solve by the card gate")


def phase_native_ou(torch, dev):
    """``native.ou_mle`` against ``ou.fit_mle`` in float64 on the card on
    one seeded OU path of 1000 steps, at tests/test_native.py's
    tolerances (theta 1e-8 absolute, mu 1e-6 and sigma 1e-8 relative)."""
    import numpy as np

    from pde_tpu_torch import native
    from pde_tpu_torch.models import ou

    o = NATIVE_OU
    dt = o["T"] / o["n"]
    a = math.exp(-o["speed"] * dt)
    sd = o["sigma"] * math.sqrt((1 - a * a) / (2 * o["speed"]))
    z = np.random.default_rng(5).normal(size=o["n"])
    path = np.empty(o["n"] + 1)
    path[0] = 2.0
    for k in range(o["n"]):
        path[k + 1] = o["mean"] + (path[k] - o["mean"]) * a + sd * z[k]
    fit = ou.fit_mle(torch.as_tensor(path, dtype=torch.float64, device=dev), dt).params
    host = native.ou_mle(path, dt)
    card = [float(fit.theta), float(fit.mu), float(fit.sigma)]
    err = dict(theta_abs=abs(card[0] - host[0]), mu_rel=abs(card[1] - host[1]) / abs(host[1]),
               sigma_rel=abs(card[2] - host[2]) / abs(host[2]))
    ok = err["theta_abs"] <= 1e-8 and err["mu_rel"] <= 1e-6 and err["sigma_rel"] <= 1e-8
    emit(phase="native_ou", dtype="float64", n=o["n"], card=card, native=list(host), **err,
         ok=ok)
    if not ok:
        raise AssertionError("ou.fit_mle on the card missed native.ou_mle")


NATIVE_PATHS = (phase_native_thomas, phase_native_heston_adi, phase_native_ou)


def phase_comm_audit(torch, dev):
    """``comm_audit.audit_table`` on the world-size-1 NCCL group: at one
    rank every collective is skipped, so every program counts nothing and
    sends no byte, as on the gloo ranks at P = 1
    (tests/test_torch_parallel.py::test_audit_counts_nothing_at_one_rank)."""
    import torch.distributed as dist

    from pde_tpu_torch.parallel import comm_audit

    world_mesh(torch, dev)
    table = comm_audit.audit_table(device_type="cuda" if dev.type == "cuda" else "cpu")
    sync(torch, dev)
    counts = {prog: {k: dict(per_step={op: n for op, n in e["per_step"].items() if n},
                             fixed={op: n for op, n in e["fixed"].items() if n},
                             bytes_sent=e["bytes_sent"])
                     for k, e in by_k.items()} for prog, by_k in table.items()}
    ok = (len(table) == 6 and all(list(by_k) == [1] for by_k in table.values())
          and all(not e["per_step"] and not e["fixed"] and e["bytes_sent"] == 0
                  for by_k in counts.values() for e in by_k.values()))
    emit(phase="comm_audit", backend=dist.get_backend(), world=dist.get_world_size(),
         counts=counts, ok=ok)
    if not ok:
        raise AssertionError("the collective audit at one rank counted a collective")


def parallel_profile_rows(torch, dev):
    """The sharded Heston march on the one-rank NCCL mesh and one pass of the
    calibration service, float32 on the card (its sqlite file in a temporary
    directory, removed with the rows or at exit)."""
    import os
    import tempfile

    from pde_tpu_torch import services
    from pde_tpu_torch.data.providers import SimulatedDataProvider
    from pde_tpu_torch.database.db import TimeSeriesDB
    from pde_tpu_torch.parallel import sharded_heston_solve

    f32 = torch.float32
    workdir = tempfile.TemporaryDirectory(prefix="pde_tpu_torch_profile_")
    db = TimeSeriesDB(os.path.join(workdir.name, "profile.db"))
    prov = SimulatedDataProvider(seed=3, device=dev, dtype=f32)
    return {"parallel_heston_100x50x100": lambda: sharded_heston_solve(
                world_mesh(torch, dev), heston_params(), 100.0, dtype=f32),
            # the row holds ``workdir``: its directory lives as long as the row
            "services_calibration": lambda: (workdir, services.calibration_step(
                provider=prov, db=db, symbols=["SPY"], device=dev, dtype=f32))[1]}


def timed_walls(torch, dev, fn, reps):
    """One warm call, then ``reps`` host-clock walls, each ending in a sync."""
    fn()
    sync(torch, dev)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn()
        sync(torch, dev)
        walls.append(time.perf_counter() - t0)
    return res, walls


def phase_book(torch, dev, grid=GRID, B=BOOK_B, reps=10):
    """bench.py's fused-ADI book, checked against the converged price."""
    from pde_tpu_torch.models.heston import HestonParams, price_accurate
    from pde_tpu_torch.solvers import heston_adi

    K = torch.linspace(85.0, 115.0, B, device=dev)
    T = torch.linspace(0.25, 1.5, B, device=dev)
    cf = (torch.arange(B, device=dev) % 2).float()

    def run():
        return heston_adi.solve_fused_batch(2.0, 0.04, 0.3, -0.7, 0.04, R, Q, T, K,
                                            cf, S0, device=dev, **grid)

    res, walls = timed_walls(torch, dev, run, reps)
    fields = ("price", "delta", "gamma", "vega", "theta")
    finite = all(bool(torch.isfinite(getattr(res, f)).all()) for f in fields)
    # the repo's PDE-vs-truth gate (tests/test_solvers.py:485-489): the
    # converged Carr-Madan price, not the reference grid's, which sits ~2%
    # below the truth at the money
    atm = (K >= 95.0) & (K <= 105.0)
    f64 = torch.float64
    truth = price_accurate(HestonParams(2.0, 0.04, 0.3, -0.7, 0.04),
                           K[atm].to(f64), T[atm].to(f64), S0, R, Q, cf[atm] > 0.5)
    rel = ((res.price[atm].to(f64) - truth).abs() / truth).max()
    per = statistics.median(walls)
    ok = finite and float(rel) < 0.01
    emit(phase="fused_adi_book", B=B, grid=list(grid.values()), finite=finite,
         n_atm=int(atm.sum()), atm_max_rel_err=float(rel), wall_s=per,
         wall_s_runs=walls, options_per_s=B / per, ok=ok)
    if not ok:
        raise AssertionError("the fused-ADI book failed its checks")


def phase_local_vol_book(torch, dev, interp, grid=LV_GRID, B=LV_B, reps=10):
    """bench.py's local-vol row, checked against the scan route on the card
    (the reference test's own gate, tests/test_local_vol.py:240)."""
    from pde_tpu_torch.solvers import local_vol_pde

    K, T, cf = lv_book(torch, dev, B)

    def run(route="fused"):
        return local_vol_pde.solve_fused_batch(interp, 100.0, K=K, T=T, is_call=cf,
                                               r=LV_R, q=LV_Q, route=route,
                                               device=dev, **grid)

    res, walls = timed_walls(torch, dev, run, reps)
    fields = ("price", "delta", "gamma", "prices")
    finite = all(bool(torch.isfinite(getattr(res, f)).all()) for f in fields)
    scan = run("scan")
    sync(torch, dev)
    err = (res.price - scan.price).abs()
    over = float((err / (2e-4 + 2e-4 * scan.price.abs())).max())
    per = statistics.median(walls)
    ok = finite and over <= 1.0
    emit(phase="local_vol_book", B=B, grid=list(grid.values()), finite=finite,
         max_abs_vs_scan=float(err.max()), max_over_bound_vs_scan=over, wall_s=per,
         wall_s_runs=walls, options_per_s=B / per, ok=ok)
    if not ok:
        raise AssertionError("the local-vol book failed its checks")


def phase_bs_book(torch, dev, grid=BS_GRID, B=BS_B, reps=10):
    """bench_full.py's Black-Scholes American book; its European twin
    against the closed form near the money, and American >= European."""
    from pde_tpu_torch.models import black_scholes
    from pde_tpu_torch.solvers import bs_pde

    sig = torch.linspace(0.15, 0.45, B, device=dev)
    T = torch.linspace(0.25, 1.5, B, device=dev)
    K = torch.linspace(80.0, 120.0, B, device=dev)
    cf = (torch.arange(B, device=dev) % 2).float()

    def run(american):
        return bs_pde.solve_fused_batch(sig, BS_R, BS_Q, T, K, cf, 100.0,
                                        american=american, device=dev, **grid)

    amer, walls = timed_walls(torch, dev, lambda: run(torch.ones(B, device=dev)), reps)
    euro = run(torch.zeros(B, device=dev))
    f64 = torch.float64
    closed = black_scholes.price(100.0, K.to(f64), BS_R, BS_Q, T.to(f64), sig.to(f64),
                                 cf > 0.5)
    atm = (K >= 95.0) & (K <= 105.0)
    rel = float(((euro.price.to(f64) - closed).abs() / closed)[atm].max())
    floor_gap = float((amer.price - euro.price).min())
    fields = ("price", "delta", "gamma", "theta")
    finite = all(bool(torch.isfinite(getattr(r, f)).all()) for r in (amer, euro)
                 for f in fields)
    per = statistics.median(walls)
    ok = finite and rel < 0.01 and floor_gap >= -1e-4
    emit(phase="bs_american_book", B=B, grid=list(grid.values()), finite=finite,
         n_atm=int(atm.sum()), european_atm_max_rel_err=rel,
         min_american_minus_european=floor_gap, wall_s=per, wall_s_runs=walls,
         options_per_s=B / per, ok=ok)
    if not ok:
        raise AssertionError("the Black-Scholes American book failed its checks")


def phase_sabr(torch, dev, reps=5):
    """bench.py's SABR smile fit (the mean of 5 warm fits), then one regular
    5-maturity surface."""
    import numpy as np

    from pde_tpu_torch.calibrate.sabr import SABRCalibrator
    from pde_tpu_torch.models import sabr

    truth = sabr.SABRParams(**SABR_TRUTH)
    cal = SABRCalibrator(beta=truth.beta, device=dev, dtype=torch.float32)

    def smile(K, F, T):
        vols = sabr.implied_volatilities(torch.as_tensor(K, dtype=torch.float32,
                                                         device=dev), F, T, truth)
        return vols.cpu().double().numpy()

    F1 = 100.0 * float(np.exp(0.03))
    K = np.linspace(80.0, 120.0, 11)
    vols = smile(K, F1, 1.0)
    cal.calibrate_single_maturity(K, vols, F1, 1.0)  # warm-up
    t0 = time.perf_counter()
    for _ in range(reps):
        p, rmse = cal.calibrate_single_maturity(K, vols, F1, 1.0)
    per = (time.perf_counter() - t0) / reps
    REPEATS_CUT["phase_sabr"] = (per, 20 - reps)
    miss = max(abs(getattr(p, k) - SABR_TRUTH[k]) for k in ("alpha", "rho", "nu"))
    ok = rmse < 1e-4 and miss < 1e-2
    emit(phase="sabr_smile", fit_s=per, rmse=rmse, params=[p.alpha, p.rho, p.nu],
         max_param_err=miss, ok=ok)
    if not ok:
        raise AssertionError("the SABR smile fit missed the truth")

    Ts = np.array([0.25, 0.5, 1.0, 1.5, 2.0])
    Fs = 100.0 * np.exp(0.03 * Ts)
    Ks = [np.linspace(0.8 * F, 1.2 * F, 11) for F in Fs]
    data = {"strike": np.concatenate(Ks), "T": np.repeat(Ts, 11),
            "implied_vol": np.concatenate([smile(k, float(F), float(T))
                                           for k, F, T in zip(Ks, Fs, Ts)])}
    t0 = time.perf_counter()
    res = cal.calibrate(data, F0=100.0, r=0.03)
    wall = time.perf_counter() - t0
    miss = max(abs(getattr(p, k) - SABR_TRUTH[k]) for p in res.params_by_maturity.values()
               for k in ("alpha", "rho", "nu"))
    ok = res.total_rmse < 1e-4 and miss < 1e-2 and len(res.params_by_maturity) == len(Ts)
    emit(phase="sabr_surface", n_maturities=res.n_maturities, total_rmse=res.total_rmse,
         max_param_err=miss, success=res.success, wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("the SABR surface calibration missed the truth")


def heston_params(**over):
    """bench_full.py:787's HestonPDEParams(q=0.02) at 100x50x100, with
    ``over`` replaced."""
    from pde_tpu_torch.solvers import heston_adi

    return heston_adi.HestonPDEParams(**{**HESTON_PDE, **GRID, **over})


# the American put of bench_full.py:866 (Ikonen-Toivanen), priced at S0=90
AMER_PUT = dict(is_call=False, american=True, american_method="it_lcp", r=0.08, q=0.0)
K2_CASES = (("european_call", {}),
            ("american_put_projection", dict(is_call=False, american=True, r=0.08, q=0.0)),
            ("american_put_it_lcp", AMER_PUT))


def k2_inputs(torch, dev, p):
    """K2's public inputs for one option, built by the port's own
    ``_fused_inputs`` in float32 on ``dev``."""
    from pde_tpu_torch.solvers import heston_adi

    t = lambda k: torch.tensor(float(getattr(p, k)), device=dev)  # noqa: E731
    return heston_adi._fused_inputs(p, *(t(k) for k in ("kappa", "theta", "sigma", "rho",
                                                        "r", "q", "T", "K")))[0]


def phase_k2(torch, dev, plain_reps=1, kernel_reps=20):
    """K2 against its plain twin, three cases a grid: the shared-memory
    route at 16x8, 40x20, the bench grid and 160x50 (bands read in place),
    the first design at the bench grid (where it ran before that route
    existed) and on a grid too large for that route (200x100), each public
    call checked to have taken its route.  Both designs are timed at the
    bench grid, each launched on inputs stacked once."""
    from pde_tpu_torch.ops import adi_fused

    march, plain = adi_fused.fused_douglas_march, adi_fused._fused_douglas_march_plain
    nT = GRID["n_time"]
    size = (GRID["n_spot"], GRID["n_vol"], nT)
    worst = 0.0
    for nS, nv in ((16, 8), (40, 20), size[:2], (160, 50), (200, 100)):
        plan = adi_fused._smem_plan_single(nS, nv)
        for name, over in K2_CASES:
            args = k2_inputs(torch, dev, heston_params(n_spot=nS, n_vol=nv, **over))
            stacked = adi_fused._stack_single(*args)
            before = march.launches_smem
            V = march(*args, nS, nv, nT)
            if (march.launches_smem > before) != (plan is not None):
                raise AssertionError(f"K2 at {nS}x{nv} did not take the "
                                     f"{'shared-memory' if plan else 'first'} route")
            P = plain(*stacked, nS, nv, nT)
            route = "first" if plan is None else "smem" if plan[3] else "smem_bands_in_place"
            worst = max(worst, compare(torch, dev, V, P, kernel="K2", grid=[nS, nv],
                                       route=route, case=name))
            if (nS, nv) == size[:2]:
                V = adi_fused._launch_single(*stacked, nS, nv, nT)
                worst = max(worst, compare(torch, dev, V, P, kernel="K2", grid=[nS, nv],
                                           route="first", case=name))
    args = k2_inputs(torch, dev, heston_params())
    stacked = adi_fused._stack_single(*args)
    plan = adi_fused._smem_plan_single(*size[:2])
    before = march.launches_smem
    ms = kernel_ms(torch, lambda: adi_fused._launch_single_smem(*stacked, *size, plan),
                   kernel_reps)
    if march.launches_smem <= before:
        raise AssertionError("K2's shared-memory launch count did not move")
    first_ms = kernel_ms(torch, lambda: adi_fused._launch_single(*stacked, *size), kernel_reps)
    plain_ms = time_ms(torch, lambda: plain(*stacked, *size), plain_reps)
    emit(phase="kernel_timing", kernel="K2", grid=list(size), kernel_ms=ms,
         first_design_ms=first_ms, plain_ms=plain_ms)
    # per node and step (csrc/adi_fused.cu): stencils and explicit rhs 22,
    # S sweep 5, rhs2 7, v sweep 5, floor 1 = 40
    nodes = size[0] * size[1]
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound=bound(nbytes(*stacked) + nodes * 4, 40.0 * nodes * size[2]))


PCR_VARIANTS = {"K1-pcr_v": dict(pcr_v=True), "K1-pcr_s": dict(pcr_s=True),
                "K1-pcr_v+s": dict(pcr_v=True, pcr_s=True)}


def phase_k1_pcr(torch, dev, grid=GRID, B=BOOK_B, plain_reps=1, kernel_reps=20):
    """K1's PCR sweeps against the plain twin's, European and IT books: the
    S sweep on the shared-memory route at B = 512, 130, 37 and 1, the v
    sweep alone and with the S sweep on the same route at B = 512, 130, 37
    and 1 on 100x50, 40x20 and 16x8; each variant on the first design at
    100x50 (B = 512, through its launcher) and on a grid too large for the
    shared-memory route (200x100, B = 37, through the public wrapper); each
    public call checked to have taken its route.  Each variant is timed at
    B = 512 on both designs."""
    from pde_tpu_torch.ops import adi_fused

    march = adi_fused.fused_douglas_march_batched
    plain = adi_fused._fused_douglas_march_batched_plain
    size = (grid["n_spot"], grid["n_vol"], grid["n_time"])
    nT = size[2]
    lev_s, lev_v = adi_fused._levels(size[0]), adi_fused._levels(size[1])
    out = {}
    for key, variant in PCR_VARIANTS.items():
        worst = 0.0
        pcr_v, pcr_s = variant.get("pcr_v", False), variant.get("pcr_s", False)
        sizes = [size[:2]] if key == "K1-pcr_s" else [size[:2], (40, 20), (16, 8)]
        cases = [(b, sz) for sz in sizes for b in (B, 130, 37, 1)] + [(37, (200, 100))]
        for b, (nS, nv) in cases:
            mixed = (torch.arange(b) % 3 == 0).float()
            for name, amer, use_it in (("european", torch.zeros(b), False),
                                       ("american_it", mixed, True)):
                smem = adi_fused._route_plan(nS, nv, use_it, pcr_v, pcr_s) is not None
                args = book(torch, dev, b, amer, dict(n_spot=nS, n_vol=nv, n_time=nT))
                counts = ("launches_smem", "launches_pcr_v_smem", "launches_pcr_s_smem")
                before = [getattr(march, c) for c in counts]
                V = march(*args, nS, nv, nT, use_it=use_it, **variant)
                moved = tuple(getattr(march, c) > n for c, n in zip(counts, before))
                if moved != (smem, smem and pcr_v, smem and pcr_s):
                    raise AssertionError(f"{key} at {nS}x{nv} did not take the "
                                         f"{'shared-memory' if smem else 'first'} route")
                P = plain(*args, nS, nv, nT, use_it, **variant)
                worst = max(worst, compare(torch, dev, V, P, kernel=key, B=b, grid=[nS, nv],
                                           route="smem" if smem else "first", case=name))
                if smem and b == B and (nS, nv) == size[:2]:
                    V = adi_fused._launch(*args, *size, use_it, pcr_v, pcr_s)
                    worst = max(worst, compare(torch, dev, V, P, kernel=key, B=b,
                                               grid=list(size[:2]), route="first", case=name))
        args = book(torch, dev, B, torch.zeros(B), grid)
        ms = kernel_ms(torch, lambda: march(*args, *size, **variant), kernel_reps)
        first_ms = kernel_ms(torch, lambda: adi_fused._launch(*args, *size, False, pcr_v, pcr_s),
                             kernel_reps)
        wave_ms = {}
        if key == "K1-pcr_s":
            # one wave of the shared-memory route (one block an SM) and a
            # quarter wave: equal times mean each SM's own work binds, a
            # shorter quarter wave the stream through device memory
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            for b in (sms, sms // 4):
                sub = book(torch, dev, b, torch.zeros(b), grid)
                wave_ms[b] = kernel_ms(torch, lambda: march(*sub, *size, **variant), kernel_reps)
        plain_ms = time_ms(torch, lambda: plain(*args, *size, False, **variant), plain_reps)
        emit(phase="kernel_timing", kernel=key, B=B, grid=list(size), kernel_ms=ms,
             first_design_ms=first_ms, plain_ms=plain_ms, kernel_options_per_s=B / ms * 1e3,
             kernel_ms_at_B=wave_ms)
        # K1's 38 flops a node and step with a PCR sweep in place of a
        # Thomas sweep (5): 4 a level and 1 for the final 1/d
        flops = 38.0 + sum(4.0 * lev + 1.0 - 5.0 for lev, on in
                           ((lev_v, pcr_v), (lev_s, pcr_s)) if on)
        nodes = size[0] * size[1] * B
        out[key] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                        bound=bound(nbytes(*args) + nodes * 4, flops * nodes * size[2]))
    return out


def bs_system(torch, dev, B=BS_B, grid=BS_GRID, w=0.5):
    """The Black-Scholes book's per-step CN system as (B, n) rows: lower,
    diag, upper (interior rows I - w dt L, identity rows at both ends), the
    explicit side on the payoff as right-hand side, and the payoff."""
    pay, sc = bs_inputs(torch, dev, B, torch.zeros(B, device=dev), grid)
    n = grid["n_space"]
    dt, Lm, Lc, Lp = (sc[k][:, None] for k in (0, 6, 7, 8))
    one, zero = torch.ones((B, 1), device=dev), torch.zeros((B, 1), device=dev)
    inner = lambda v: v.expand(B, n - 2)  # noqa: E731
    lower = torch.cat([inner(-w * dt * Lm), zero], 1)
    upper = torch.cat([zero, inner(-w * dt * Lp)], 1)
    diag = torch.cat([one, inner(1.0 - w * dt * Lc), one], 1)
    V = pay.T.contiguous()
    LV = Lm * V[:, :-2] + Lc * V[:, 1:-1] + Lp * V[:, 2:]
    rhs = torch.cat([V[:, :1], V[:, 1:-1] + (1.0 - w) * dt * LV, V[:, -1:]], 1)
    return lower, diag, upper, rhs, V


def adi_v_system(torch, dev, B=BOOK_B, grid=GRID):
    """The fused-ADI book's v-sweep systems, one per (option, S row):
    (B nS, nv) rows of the port's own implicit v bands, and a seeded
    right-hand side."""
    i2 = book(torch, dev, B, torch.zeros(B), grid)[5]             # (3, nv, B)
    nS, nv = grid["n_spot"], grid["n_vol"]
    rows = lambda a: a.T[:, None, :].expand(B, nS, a.shape[0]).reshape(B * nS, -1)  # noqa: E731
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rhs = 100.0 * torch.rand((B * nS, nv), generator=gen, device=dev)
    return rows(i2[0][1:]), rows(i2[1]), rows(i2[2][:-1]), rhs


def dense(torch, lower, diag, upper):
    """The (B, n, n) matrices of a batch of tridiagonal systems."""
    B, n = diag.shape
    A = torch.zeros((B, n, n), dtype=diag.dtype, device=diag.device)
    A.diagonal(0, -2, -1).copy_(diag)
    A.diagonal(-1, -2, -1).copy_(lower)
    A.diagonal(1, -2, -1).copy_(upper)
    return A


def median_ms(torch, fn, reps, warmup=3):
    """(median, least, most) milliseconds of ``reps`` single calls after
    ``warmup`` calls, each call between its own pair of CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), min(times), max(times)


def operand_bytes(*tensors):
    """Bytes of operands read once each: a band expanded over the batch
    (batch stride 0) is one row."""
    return sum((t[0] if t.dim() == 2 and t.shape[0] > 1 and t.stride(0) == 0 else t).numel()
               * t.element_size() for t in tensors)


def k5_timing(torch, dev, lower, diag, upper, rhs, kernel_reps=200, plain_reps=3,
              library_reps=10):
    """K5 on one batch of systems: the kernel alone on both routes (the
    lane-group route on the operands where they lie, the first design on
    batch-last copies laid out once, without the wrapper), its plain twin,
    and the yardstick torch.linalg.solve on the same systems as dense
    matrices, TF32 off, the solve alone (median of single warmed calls,
    with its spread); plus the bytes and flops of the bound."""
    from pde_tpu_torch.ops import tridiag

    B, n = rhs.shape
    system = (lower, diag, upper, rhs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    g, ch, cp, n_bytes = tridiag._lane_plan(n)
    ops = [tridiag._batch_stride(a) for a in system]
    x = torch.empty((B, n), device=dev)
    lanes = tridiag._lanes_library()
    ms = kernel_ms(torch, lambda: lanes(*(a.data_ptr() for a, _ in ops), x.data_ptr(),
                                        *(st for _, st in ops), B, n, g, ch, cp, n_bytes,
                                        stream), kernel_reps)
    first, ins = tridiag._thomas_library(), tridiag._row_major(*system)
    xt, C = (torch.empty((n, B), device=dev) for _ in range(2))
    ptrs = [t.data_ptr() for t in (*ins, xt, C)]
    first_ms = kernel_ms(torch, lambda: first(*ptrs, B, n, stream), kernel_reps)
    first_diff = float((xt.T - x).abs().max())
    plain_ms = time_ms(torch, lambda: tridiag._thomas_batched_plain(*system), plain_reps)
    torch.backends.cuda.matmul.allow_tf32 = False
    A, b = dense(torch, lower, diag, upper), rhs[..., None]
    lib_ms, lib_min, lib_max = median_ms(torch, lambda: torch.linalg.solve(A, b),
                                         library_reps)
    lib_diff = float((torch.linalg.solve(A, b)[..., 0] - x).abs().max())
    del A
    # per row: forward 7 (pivot 2, reciprocal 1, c 1, dp 3), back 2
    return dict(B=B, n=n, lanes=g, rows_per_lane=ch, ms=ms, first_design_ms=first_ms,
                max_abs_first_vs_lanes=first_diff, plain_ms=plain_ms, library_ms=lib_ms,
                library_min_max_ms=[lib_min, lib_max], max_abs_vs_library=lib_diff,
                n_bytes=operand_bytes(*system) + B * n * 4, n_flops=9.0 * B * n)


def k6_timing(torch, dev, lower, diag, upper, b, g, x0=None, omega=1.5,
              n_iter=PSOR_ITERS[0], kernel_reps=20, plain_reps=1):
    """K6 on one batch of LCPs: the kernel alone on both routes (the warp
    route on the operands where they lie, the first design on row-aligned
    operands laid out once, without the wrapper) and its plain twin; plus
    the bytes and flops of the bound."""
    from pde_tpu_torch.solvers import lcp

    B, n = b.shape
    system = (lower, diag, upper, b, g, x0, omega, n_iter)
    warp, x, _ = lcp._warp_launcher(*system)
    first, xf = lcp._first_launcher(*system)
    ms = kernel_ms(torch, warp, kernel_reps)
    first_ms = kernel_ms(torch, first, kernel_reps)
    plain_ms = time_ms(torch, lambda: lcp._projected_sor(lower, diag, upper, b, g, x0,
                                                         omega, n_iter), plain_reps)
    # per row and sweep: neighbours 3, Gauss-Seidel value 2, relaxation 3,
    # projection 1; the start 2 (max(b / d, g)) or 1 (max(x0, g))
    start_flops = 2.0 if x0 is None else 1.0
    return dict(B=B, n=n, n_iter=n_iter, x0=x0 is not None, ms=ms, first_design_ms=first_ms,
                max_abs_first_vs_warp=float((xf - x).abs().max()), plain_ms=plain_ms,
                n_bytes=nbytes(lower, diag, upper, b, g, *(() if x0 is None else (x0,)))
                + B * n * 4,
                n_flops=(9.0 * n_iter + start_flops) * B * n)


def seeded_lcp(torch, dev, B, n, seed=0):
    """Seeded (B, n) float32 LCPs on ``dev``: M-matrix bands, right-hand
    side, obstacle, and a start."""
    lower, diag, upper, b = seeded_system(torch, dev, B, n, seed=seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    g = torch.rand((B, n), generator=gen, device=dev) - 0.5
    return lower.contiguous(), diag.contiguous(), upper.contiguous(), b, g, 0.5 * b


def seeded_system(torch, dev, B, n, shared_bands=False, seed=0):
    """Seeded diagonally dominant (B, n) float32 systems on ``dev``; with
    ``shared_bands`` the three bands are one row expanded over the batch
    (batch stride 0), as the scan's v sweep and ``tridiagonal_solve`` give
    them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = 1 if shared_bands else B
    rand = lambda m: torch.rand((rows, m), generator=gen, device=dev)  # noqa: E731
    lower, diag, upper = -rand(n - 1), 2.5 + rand(n), -rand(n - 1)
    rhs = torch.randn((B, n), generator=gen, device=dev)
    return (lower.expand(B, n - 1), diag.expand(B, n), upper.expand(B, n - 1), rhs)


def profiled(torch, dev, fn):
    """One warm call of ``fn`` under torch.profiler: (wall seconds, {kernel
    name: device microseconds}), device-side events only (the CPU ops that
    launched them carry the same time again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync(torch, dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(torch, dev)
        wall = time.perf_counter() - t0
    busy = {}  # kernels whose names share their first 60 characters add up
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            busy[e.key[:60]] = busy.get(e.key[:60], 0.0) + e.self_device_time_total
    return wall, busy


def wrapper_profile(torch, dev, fn, reps):
    """``reps`` warm calls of ``fn`` in one torch.profiler session: {kernel
    name: launches on the card}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync(torch, dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync(torch, dev)
    return {e.key[:60]: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def phase_k5(torch, dev):
    """K5 against its plain twin, each call checked to have taken the
    lane-group route: at the scan paths' shapes, a ragged batch, the BS
    book's per-step system and the fused-ADI book's v sweep; both routes
    timed alone beside torch.linalg.solve; one wrapper call profiled.
    Returns the worst |kernel - plain|."""
    from pde_tpu_torch.ops import tridiag

    solve = tridiag.thomas_batched
    worst = 0.0
    cases = (("scan_s_sweep", seeded_system(torch, dev, 50, 100)),
             ("scan_v_sweep", seeded_system(torch, dev, 100, 50, shared_bands=True)),
             ("projection_step", seeded_system(torch, dev, 1, 200, shared_bands=True)),
             ("ragged", seeded_system(torch, dev, 37, 100)),
             ("bs_book_step", bs_system(torch, dev)[:4]),
             ("adi_v_sweep", adi_v_system(torch, dev)))
    for name, system in cases:
        B, n = system[3].shape
        before = (solve.launches, solve.launches_smem)
        X = solve(*system)
        if (solve.launches - before[0], solve.launches_smem - before[1]) != (1, 1):
            raise AssertionError(f"K5 at ({B}, {n}) did not take the lane-group route")
        worst = max(worst, compare(torch, dev, X, tridiag._thomas_batched_plain(*system),
                                   kernel="K5", case=name, B=B, n=n, route="lanes"))
        V = tridiag._launch_thomas_first(*system)
        worst = max(worst, compare(torch, dev, V, tridiag._thomas_batched_plain(*system),
                                   kernel="K5", case=name, B=B, n=n, route="first"))
        wrapper_ms = time_ms(torch, lambda: solve(*system), 20)
        emit(phase="kernel_timing", kernel="K5", case=name, wrapper_ms=wrapper_ms,
             **k5_timing(torch, dev, *system))
    system = cases[0][1]
    _, kernels = profiled(torch, dev, lambda: solve(*system))
    ok = len(kernels) == 1
    emit(phase="k5_wrapper_profile", B=50, n=100, n_kernels=len(kernels), kernels=kernels,
         ok=ok)
    if not ok:
        raise AssertionError(f"one K5 wrapper call launched {len(kernels)} kernels, not 1")
    return worst


def phase_k6(torch, dev, wrapper_reps=10):
    """K6 against its plain twin, bit for bit, each public call checked to
    have taken its route and its residual to equal ``_residual`` on its
    result: the BS book's LCP (512, 200) at 60 and 120 sweeps on both
    designs; seeded LCPs on the warp route at n = 2, 3, 33 and 200 (B = 1, 7
    and 37; ragged: a partly filled last block, lanes holding one row or
    none) and at n = 100, 150 and 256 (B = 1 and 37: register chunks of 4,
    8 and 8 slots a lane, slots past the chunk at 150, all used at 256),
    with and without a start; on the first design at n = 300 and 512 (B =
    1 and 37) and 600 (B = 7).  Both
    designs timed at (512, 200); ``wrapper_reps`` wrapper calls at (512, 200)
    and at (1, 200) from a start profiled: the kernel once a call, and at
    most one reduction besides.  Returns the worst |kernel - plain|."""
    from pde_tpu_torch.solvers import lcp

    psor = lcp.projected_sor_batched
    worst = 0.0

    def check(system, x0, n_iter, case):
        lower, diag, upper, b, g = system
        n = b.shape[1]
        warp = lcp._warp_plan(n) is not None
        before = (psor.launches, psor.launches_warp)
        x, resid = psor(lower, diag, upper, b, g, n_iter=n_iter, x0=x0)
        if (psor.launches - before[0], psor.launches_warp - before[1]) != (1, int(warp)):
            raise AssertionError(f"K6 at n={n} did not take the "
                                 f"{'warp' if warp else 'first'} route")
        xp, _ = lcp._projected_sor(lower, diag, upper, b, g, x0, 1.5, n_iter)
        want = lcp._residual(lower, diag, upper, b, g, x)
        err = compare(torch, dev, x, xp, kernel="K6", case=case, B=b.shape[0], n=n,
                      n_iter=n_iter, x0=x0 is not None, route="warp" if warp else "first",
                      residual=float(resid), residual_equal=float(resid) == float(want))
        if err != 0.0 or float(resid) != float(want):
            raise AssertionError(f"K6 ({case}, n={n}) is not bit-equal to its twin, or its "
                                 "residual differs from _residual")
        return err

    system = bs_system(torch, dev)
    for n_iter in PSOR_ITERS:
        worst = max(worst, check(system, None, n_iter, "bs_book_lcp"))
        x = lcp._launch_psor_first(*system, None, 1.5, n_iter)
        xp, _ = lcp._projected_sor(*system, None, 1.5, n_iter)
        worst = max(worst, compare(torch, dev, x, xp, kernel="K6", case="bs_book_lcp",
                                   n_iter=n_iter, route="first"))
    for n, batches in ((2, (1, 7, 37)), (3, (1, 7, 37)), (33, (1, 7, 37)), (200, (1, 7, 37)),
                       (100, (1, 37)), (150, (1, 37)), (256, (1, 37)), (300, (1, 37)),
                       (512, (1, 37)), (600, (7,))):
        for B in batches:
            *lcp_system, x0 = seeded_lcp(torch, dev, B, n, seed=n + B)
            for start in (None, x0):
                worst = max(worst, check(lcp_system, start, PSOR_ITERS[0], "seeded"))

    lower, diag, upper, b, g = system
    before = psor.launches_warp
    wrapper_ms = time_ms(torch, lambda: psor(lower, diag, upper, b, g), 20)
    if psor.launches_warp <= before:
        raise AssertionError("K6's warp-route launch count did not move")
    emit(phase="kernel_timing", kernel="K6", case="bs_book_lcp", wrapper_ms=wrapper_ms,
         **k6_timing(torch, dev, lower, diag, upper, b, g))
    one = bs_system(torch, dev, 1)
    for case, call in (("bs_book_lcp", lambda: psor(lower, diag, upper, b, g)),
                       ("bs_pde_solve_step", lambda: psor(*one[:4], one[4], x0=one[4]))):
        B = 512 if case == "bs_book_lcp" else 1
        counts = wrapper_profile(torch, dev, call, wrapper_reps)
        kernels = [k for k in counts if "psor" in k]
        others = sum(c for k, c in counts.items() if k not in kernels)
        ok = [counts[k] for k in kernels] == [wrapper_reps] \
            and others <= (wrapper_reps if B > 1 else 0)
        emit(phase="k6_wrapper_profile", case=case, B=B, calls=wrapper_reps,
             launches=counts, launches_per_call=sum(counts.values()) / wrapper_reps, ok=ok)
        if not ok:
            raise AssertionError(f"{wrapper_reps} K6 wrapper calls ({case}) launched {counts}")
    return worst


def phase_heston_scan(torch, dev, reps=5):
    """bench_full.py:787: heston_adi.solve at 100x50x100 (the scan route,
    its sweeps on K5), against the true price (tests/test_solvers.py:140)."""
    from pde_tpu_torch.solvers import heston_adi

    p = heston_params()
    res, walls = timed_walls(torch, dev, lambda: heston_adi.solve(p, 100.0, device=dev), reps)
    per = statistics.median(walls)
    err = abs(float(res.price) - HESTON_TRUE_CALL)
    ok = bool(torch.isfinite(res.prices).all()) and err < 0.03
    emit(phase="heston_adi_scan", grid=list(GRID.values()), price=float(res.price),
         abs_err_vs_truth=err, wall_s=per, wall_s_runs=walls,
         heston_adi_100x50_steps_per_sec=p.n_time / per, ok=ok)
    if not ok:
        raise AssertionError("heston_adi.solve failed its checks")
    return res


def fused_vs_scan(torch, fused, scan):
    """Max |diff| on the grid, the same over its gate, and |diff| on the
    price (tests/test_solvers.py:226-231)."""
    diff = (fused.prices - scan.prices).abs()
    over = diff / (FUSED_ATOL + FUSED_GRID_RTOL * scan.prices.abs())
    return float(diff.max()), float(over.max()), abs(float(fused.price) - float(scan.price))


def phase_heston_fused(torch, dev, scan, reps=20):
    """bench_full.py:799: solve_fused (K2) on the same grid, held against
    the scan solve on the card at 5e-4 absolute."""
    from pde_tpu_torch.solvers import heston_adi

    p = heston_params()
    res, walls = timed_walls(torch, dev, lambda: heston_adi.solve_fused(p, 100.0, device=dev),
                             reps)
    grid_err, grid_over, price_err = fused_vs_scan(torch, res, scan)
    per = statistics.median(walls)
    ok = (bool(torch.isfinite(res.prices).all()) and grid_over <= 1.0
          and price_err <= FUSED_ATOL)
    # how far float32 itself sits from float64 on this grid: the scan
    # route in float64 on the card (its factored twin) as the reference
    s64 = heston_adi.solve(p, 100.0, device=dev, dtype=torch.float64).prices
    emit(phase="heston_adi_fused", price=float(res.price), max_abs_grid_vs_scan=grid_err,
         max_over_bound_grid_vs_scan=grid_over, abs_price_vs_scan=price_err,
         max_abs_grid_scan_vs_scan_f64=float((scan.prices.double() - s64).abs().max()),
         max_abs_grid_fused_vs_scan_f64=float((res.prices.double() - s64).abs().max()),
         heston_adi_fused_solve_s=per, wall_s_runs=walls, ok=ok)
    if not ok:
        raise AssertionError("solve_fused disagrees with solve")


def phase_heston_lcp(torch, dev, reps=5):
    """bench_full.py:866-873: the Ikonen-Toivanen American put at S0=90
    through solve (K5) and solve_fused (K2), held against each other."""
    from pde_tpu_torch.solvers import heston_adi

    p = heston_params(**AMER_PUT)
    scan, scan_walls = timed_walls(torch, dev, lambda: heston_adi.solve(p, 90.0, device=dev),
                                   reps)
    fused, fused_walls = timed_walls(
        torch, dev, lambda: heston_adi.solve_fused(p, 90.0, device=dev), 4 * reps)
    grid_err, grid_over, price_err = fused_vs_scan(torch, fused, scan)
    ok = (grid_over <= 1.0 and price_err <= FUSED_ATOL and float(scan.price) >= 10.0
          and bool(torch.isfinite(scan.prices).all()))
    emit(phase="heston_american_lcp", price=float(scan.price), fused_price=float(fused.price),
         max_abs_grid_fused_vs_scan=grid_err, max_over_bound_grid=grid_over,
         heston_american_lcp_solve_s=statistics.median(scan_walls),
         heston_american_lcp_fused_solve_s=statistics.median(fused_walls), ok=ok)
    if not ok:
        raise AssertionError("the Ikonen-Toivanen American put failed its checks")


def surface(torch, dev):
    """bench_full.py:805-817's mixed surface: 12 strikes in [85, 115] x 9
    maturities in [0.25, 1.5], calls and puts alternating."""
    n_k, n_t = 12, 9
    K = torch.linspace(85.0, 115.0, n_k, device=dev).repeat(n_t)
    T = torch.linspace(0.25, 1.5, n_t, device=dev).repeat_interleave(n_k)
    return K, T, torch.arange(n_k * n_t, device=dev) % 2 == 0


def phase_heston_surface(torch, dev, reps=5):
    """The 108-option surface through solve_batch (K5) and
    solve_fused_batch (K1), held against each other (tests/test_solvers.py:
    260-265: 5e-4 absolute on the price)."""
    from pde_tpu_torch.solvers import heston_adi

    K, T, call = surface(torch, dev)
    B = K.shape[0]
    args = (2.0, 0.04, 0.3, -0.7, 0.04, R, Q, T, K)
    scan, scan_walls = timed_walls(torch, dev, lambda: heston_adi.solve_batch(
        *args, call, S0, device=dev, **GRID), reps)
    fused, fused_walls = timed_walls(torch, dev, lambda: heston_adi.solve_fused_batch(
        *args, call.float(), S0, device=dev, **GRID), reps)
    err = float((fused.price - scan.price).abs().max())
    ok = err <= FUSED_ATOL and bool(torch.isfinite(scan.price).all())
    emit(phase="heston_surface", B=B, max_abs_price_fused_vs_scan=err,
         heston_adi_batch108_options_per_sec=B / statistics.median(scan_walls),
         heston_adi_mixed_book_options_per_sec=B / statistics.median(fused_walls), ok=ok)
    if not ok:
        raise AssertionError("the 108-option surface failed its checks")


def phase_k1_routes(torch, dev, reps=5):
    """The 108-option surface and the 512-book through solve_fused_batch,
    on K1's shared-memory route and on its first design, in turns (shared,
    first, first, shared): options/s of each turn (median of ``reps`` warm
    calls), the two routes' prices within 5e-4 of each other; and the host
    microseconds of one uncached ``_smem_plan``, which the wrapper asks for
    at every launch."""
    import contextlib
    from unittest import mock

    from pde_tpu_torch.ops import adi_fused
    from pde_tpu_torch.solvers import heston_adi

    march = adi_fused.fused_douglas_march_batched
    K, T, call = surface(torch, dev)
    rows = {"heston_surface": (K, T, call.float()),
            "fused_adi_book": (torch.linspace(85.0, 115.0, BOOK_B, device=dev),
                               torch.linspace(0.25, 1.5, BOOK_B, device=dev),
                               (torch.arange(BOOK_B, device=dev) % 2).float())}
    ok = True
    for row, (K, T, cf) in rows.items():
        def run(K=K, T=T, cf=cf):
            return heston_adi.solve_fused_batch(2.0, 0.04, 0.3, -0.7, 0.04, R, Q, T, K, cf,
                                                S0, device=dev, **GRID)

        per_s, price, took = {"smem": [], "first": []}, {}, {}
        for route in ("smem", "first", "first", "smem"):
            force = (mock.patch.object(adi_fused, "_smem_plan", lambda *a: None)
                     if route == "first" else contextlib.nullcontext())
            before = march.launches_smem
            with force:
                res, walls = timed_walls(torch, dev, run, reps)
            took[route] = march.launches_smem > before
            per_s[route].append(K.shape[0] / statistics.median(walls))
            price[route] = res.price
        diff = float((price["smem"] - price["first"]).abs().max())
        row_ok = took["smem"] and not took["first"] and diff <= FUSED_ATOL
        ok = ok and row_ok
        emit(phase="k1_routes", row=row, B=int(K.shape[0]), options_per_s=per_s,
             max_abs_price_smem_vs_first=diff, ok=row_ok)
    t0 = time.perf_counter()
    for _ in range(100):
        adi_fused._smem_plan.__wrapped__(GRID["n_spot"], GRID["n_vol"], False)
    emit(phase="k1_smem_plan_host", uncached_us=(time.perf_counter() - t0) * 1e4)
    if not ok:
        raise AssertionError("K1's two routes disagree or did not take their routes")


def phase_greeks(torch, dev, eps=1e-3):
    """greeks_ad in float64 at 60x30x40 against central differences of
    solve_batch (tests/test_solvers.py:327-344)."""
    from pde_tpu_torch.solvers import heston_adi

    f64 = torch.float64
    kw = dict(n_spot=60, n_vol=30, n_time=40, device=dev, dtype=f64)
    t0 = time.perf_counter()
    out = heston_adi.greeks_ad(2.0, 0.04, 0.3, -0.7, 0.04, R, Q, 1.0, 100.0, True, S0, **kw)
    sync(torch, dev)
    wall = time.perf_counter() - t0

    def price(s0=S0, sigma=0.3):
        return float(heston_adi.solve_batch(2.0, 0.04, sigma, -0.7, 0.04, R, Q, 1.0, 100.0,
                                            True, s0, **kw).price[0])

    fd_delta = (price(s0=S0 + eps) - price(s0=S0 - eps)) / (2 * eps)
    fd_dsigma = (price(sigma=0.3 + eps) - price(sigma=0.3 - eps)) / (2 * eps)
    rel_delta = abs(float(out["delta"]) - fd_delta) / abs(fd_delta)
    rel_dsigma = abs(float(out["d_sigma"]) - fd_dsigma) / abs(fd_dsigma)
    ok = (rel_delta <= 1e-4 and rel_dsigma <= 1e-3 and float(out["d_T"]) > 0
          and float(out["d_v0"]) > 0)
    emit(phase="greeks_ad", dtype="float64", grid=[60, 30, 40],
         greeks={k: float(v) for k, v in out.items()}, rel_err_delta_vs_fd=rel_delta,
         rel_err_d_sigma_vs_fd=rel_dsigma, wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("greeks_ad disagrees with central differences")


def phase_pcr_book(torch, dev, variant, grid=GRID, B=BOOK_B):
    """The 512-book through solve_fused_batch with the PCR sweeps of
    ``variant`` (a key of PCR_VARIANTS), held against the Thomas book at
    1e-4 relative + 1e-4 absolute."""
    from pde_tpu_torch.solvers import heston_adi

    K = torch.linspace(85.0, 115.0, B, device=dev)
    T = torch.linspace(0.25, 1.5, B, device=dev)
    cf = (torch.arange(B, device=dev) % 2).float()
    run = lambda **kw: heston_adi.solve_fused_batch(  # noqa: E731
        2.0, 0.04, 0.3, -0.7, 0.04, R, Q, T, K, cf, S0, device=dev, **grid, **kw).price
    base = run()
    over = float(((run(**PCR_VARIANTS[variant]) - base).abs() / (1e-4 + 1e-4 * base.abs())).max())
    ok = over <= 1.0
    emit(phase="pcr_book", variant=variant, B=B, max_over_bound_vs_thomas=over, ok=ok)
    if not ok:
        raise AssertionError(f"the {variant} book disagrees with the Thomas book")


def phase_bs_solve(torch, dev, reps=2):
    """bs_pde.solve for an American put at 200x100 by each method:
    projection (K5), PSOR (K6), Brennan-Schwartz; Brennan-Schwartz within
    1e-3 of PSOR, each at least the European price less 1e-4."""
    from pde_tpu_torch.solvers import bs_pde

    p = bs_pde.BSPDEParams(is_call=False, american=True, **BS_GRID)
    euro = float(bs_pde.solve(p._replace(american=False), 100.0, device=dev).price)
    prices, walls = {}, {}
    for method in ("projection", "psor", "brennan_schwartz"):
        res, w = timed_walls(torch, dev, lambda: bs_pde.solve(
            p._replace(american_method=method), 100.0, device=dev), reps)
        prices[method], walls[method] = float(res.price), statistics.median(w)
    ok = (abs(prices["brennan_schwartz"] - prices["psor"]) <= 1e-3
          and min(prices.values()) >= euro - 1e-4)
    emit(phase="bs_pde_solve", grid=list(BS_GRID.values()), european=euro, american=prices,
         wall_s=walls, ok=ok)
    if not ok:
        raise AssertionError("bs_pde.solve failed its checks")


def phase_tridiagonal_solve(torch, dev):
    """ops.tridiagonal_solve on the BS book's 2D float32 system (its kernel
    branch), against the plain twin."""
    from pde_tpu_torch.ops import tridiag

    lower, diag, upper, rhs, _ = bs_system(torch, dev)
    X = tridiag.tridiagonal_solve(lower, diag, upper, rhs)
    P = tridiag._thomas_batched_plain(lower, diag, upper, rhs)
    compare(torch, dev, X, P, kernel="K5", case="tridiagonal_solve")


def phase_projected_sor(torch, dev):
    """lcp.projected_sor_batched on the BS book's LCP: x >= g, a small
    complementarity residual, and more sweeps shrink it."""
    from pde_tpu_torch.solvers import lcp

    lower, diag, upper, b, g = bs_system(torch, dev)
    (x, r60), (_, r120) = (lcp.projected_sor_batched(lower, diag, upper, b, g, n_iter=it)
                           for it in PSOR_ITERS)
    ok = bool((x >= g).all()) and float(r120) <= float(r60) and float(r120) < 1e-2
    emit(phase="projected_sor_batched", residual_60=float(r60), residual_120=float(r120),
         ok=ok)
    if not ok:
        raise AssertionError("projected_sor_batched failed its checks")


def ar1_fit_mean_mu(paths=OU_PATHS, steps=OU_STEPS, seed=0):
    """The mean mu that the AR(1) fit (the moments of models/ou.fit_mle)
    finds over ``paths`` OU paths of ``steps`` daily steps from theta,
    simulated and fitted in numpy float64, apart from the port: at 252 steps
    the estimator sits far above the true mu (Kendall's small-sample bias of
    the slope; the reference engine's own fit of one such path reads 8.95
    for a true 5, tests/golden/reference_values.json ou_fit_mu)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    th, mu, sig = OU["theta"], OU["mu"], OU["sigma"]
    dt = 1.0 / steps
    a = np.exp(-mu * dt)
    s = np.sqrt(sig**2 * (1.0 - np.exp(-2.0 * mu * dt)) / (2.0 * mu))
    z = rng.standard_normal((paths, steps))
    x = np.empty((paths, steps + 1))
    x[:, 0] = th
    for i in range(steps):
        x[:, i + 1] = th + (x[:, i] - th) * a + s * z[:, i]
    xt, xn = x[:, :-1], x[:, 1:]
    mx, mn = xt.mean(1), xn.mean(1)
    b = ((xt * xn).mean(1) - mx * mn) / ((xt * xt).mean(1) - mx * mx)
    b = np.where(b >= 1.0, 0.9999, np.where(b <= 0.0, 0.0001, b))
    return float(np.mean(-np.log(b) / dt))


def phase_ou(torch, dev, reps=10, long_reps=5):
    """bench_full.py:645-671: simulate 1024 OU(100, 5, 2) paths of 252
    steps from 100 and fit_mle over them, both in float32 on the card; the
    fits' mean theta within 0.5 of 100, their mean sigma within 5% of 2,
    and their mean mu within 20% of the same estimator's mean on numpy
    float64 paths (ar1_fit_mean_mu: ~9.9, not 5, at this length).  Then
    simulate_parallel on one path of 10^6 steps over 4 years, on the
    card's normals, against simulate's step loop on the same normals."""
    from pde_tpu_torch.models import ou

    p = ou.OUParams(**OU)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    paths, walls = timed_walls(
        torch, dev, lambda: ou.simulate(p, OU["theta"], 1.0, OU_STEPS, gen,
                                        shape=(OU_PATHS,), device=dev), reps)
    fit, fit_walls = timed_walls(torch, dev, lambda: ou.fit_mle(paths, 1.0 / OU_STEPS), reps)
    mean = lambda t: float(t.double().mean())  # noqa: E731
    fit64 = ou.fit_mle(paths.cpu().double(), 1.0 / OU_STEPS)
    expect_mu = ar1_fit_mean_mu()
    got = {k: mean(getattr(fit.params, k)) for k in ("theta", "mu", "sigma")}
    ok = (tuple(paths.shape) == (OU_PATHS, OU_STEPS + 1) and paths.dtype == torch.float32
          and bool(torch.isfinite(paths).all()) and bool((paths[:, 0] == OU["theta"]).all())
          and abs(got["theta"] - OU["theta"]) < 0.5
          and abs(got["sigma"] - OU["sigma"]) / OU["sigma"] < 0.05
          and abs(got["mu"] - expect_mu) / expect_mu < 0.2)
    emit(phase="ou", paths=OU_PATHS, steps=OU_STEPS, mean_fit=got,
         numpy_f64_mean_mu=expect_mu,
         mean_fit_cpu_f64={k: mean(getattr(fit64.params, k)) for k in ("theta", "mu", "sigma")},
         ou_sim252_paths_per_sec=OU_PATHS / statistics.median(walls),
         ou_mle252_fits_per_sec=OU_PATHS / statistics.median(fit_walls),
         sim_wall_s_runs=walls, fit_wall_s_runs=fit_walls, ok=ok)
    if not ok:
        raise AssertionError("the OU simulation and fits failed their checks")

    dt = 4.0 / OU_LONG
    _, long_walls = timed_walls(
        torch, dev,
        lambda: ou.simulate_parallel(p, OU["theta"], 4.0, OU_LONG, gen, device=dev), long_reps)
    gen.manual_seed(7)
    z = torch.randn(OU_LONG, generator=gen, device=dev)
    scan = {"float32": ou._path_parallel(p, OU["theta"], dt, z),
            "float64": ou._path_parallel(p, OU["theta"], dt, z.double())}
    loop_f64 = ou._path(p, OU["theta"], dt, z.cpu().double())
    rel = lambda a, b: float(((a.cpu().double() - b.cpu()).abs() / b.cpu().abs()).max())  # noqa: E731
    errs = {"scan_f64_vs_loop_f64": rel(scan["float64"], loop_f64),
            "scan_f32_vs_scan_f64": rel(scan["float32"], scan["float64"])}
    ok = bool(errs["scan_f64_vs_loop_f64"] <= 1e-10 and torch.isfinite(scan["float32"]).all()
              and errs["scan_f32_vs_scan_f64"] <= OU_LONG_F32_REL)
    emit(phase="ou_long_path", steps=OU_LONG, max_rel=errs,
         ou_sim_longpath_steps_per_sec=OU_LONG / statistics.median(long_walls),
         wall_s_runs=long_walls, ok=ok)
    if not ok:
        raise AssertionError("simulate_parallel disagrees with simulate")


def hjb_dx(p):
    return (p.x_max - p.x_min) / (p.n_space - 1)


def hjb_goldens():
    """The reference engine's HJB values (tests/golden/reference_pde_values.json)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                        "reference_pde_values.json")
    with open(path) as fh:
        return json.load(fh)


def hjb_cells_off_f64(torch, p, b):
    """The largest distance, in cells, of the boundaries ``b`` from the
    same problem's float64 march on the CPU."""
    from pde_tpu_torch.solvers import hjb

    ref = hjb.solve_all_boundaries(p, device="cpu", dtype=torch.float64)
    return max(abs(x - y) for x, y in zip(b, ref)) / hjb_dx(p)


def phase_hjb_projection(torch, dev):
    """solve_all_boundaries at the default HJBParams (200x200) by
    projection on the card: each step one K5 launch on the four problems'
    (4, 200) rows, their shared bands at batch stride 0; entry_long and
    entry_short within one cell of the reference engine's goldens, as
    tests/test_golden_pde.py:145-152 holds the JAX package (its goldens
    keep reference_compat's cut band: phase_hjb_goldens), and every
    boundary within HJB_CELLS of the CPU's float64 march."""
    from pde_tpu_torch.solvers import hjb

    p = hjb.HJBParams()
    b = hjb.solve_all_boundaries(p, device=dev)
    gold = hjb_goldens()
    err = {k: abs(getattr(b, k) - gold[f"hjb_{k}"]) for k in ("entry_long", "entry_short")}
    cells = hjb_cells_off_f64(torch, p, b)
    ok = bool(max(err.values()) <= hjb_dx(p) + 1e-6 and cells <= HJB_CELLS)
    emit(phase="hjb_projection", grid=[p.n_space, p.n_time], boundaries=b._asdict(),
         abs_err_vs_golden=err, dx=hjb_dx(p), cells_off_cpu_f64=cells, ok=ok)
    if not ok:
        raise AssertionError("HJB projection boundaries miss the goldens")
    return b


def phase_hjb_psor(torch, dev, proj):
    """The same by PSOR (one K6 launch a step, (4, 200), 60 sweeps from V):
    within one cell of the goldens and of the projection boundaries, and
    within HJB_CELLS of the CPU's float64 PSOR march."""
    from pde_tpu_torch.solvers import hjb

    p = hjb.HJBParams(method="psor")
    b = hjb.solve_all_boundaries(p, device=dev)
    gold = hjb_goldens()
    err = {k: abs(getattr(b, k) - gold[f"hjb_{k}"]) for k in ("entry_long", "entry_short")}
    vs_proj = {k: abs(getattr(b, k) - getattr(proj, k)) for k in ("entry_long", "entry_short")}
    cells = hjb_cells_off_f64(torch, p, b)
    ok = bool(max(err.values()) <= hjb_dx(p) + 1e-6
              and max(vs_proj.values()) <= hjb_dx(p) + 1e-6 and cells <= HJB_CELLS)
    emit(phase="hjb_psor", grid=[p.n_space, p.n_time], boundaries=b._asdict(),
         abs_err_vs_golden=err, abs_diff_vs_projection=vs_proj, cells_off_cpu_f64=cells,
         ok=ok)
    if not ok:
        raise AssertionError("HJB PSOR boundaries miss the goldens or projection")


def phase_hjb_goldens(torch, dev):
    """The reference engine's own assembly (reference_compat, the goldens'
    band) by projection on the card, 200 K5 launches for the four problems
    and 200 for the single solve: all six boundaries within HJB_CELLS of
    tests/golden/reference_pde_values.json and the value probes within
    HJB_VALUE_ATOL.  (PSOR's upwind operator is not the goldens': in
    float64 it sits one cell off on the entries, 97.5 on the exits; it is
    held to its own float64 march in phase_hjb_psor.)"""
    from pde_tpu_torch.solvers import hjb

    p = hjb.HJBParams(reference_compat=True)
    b = hjb.solve_all_boundaries(p, device=dev)
    res = hjb.solve(p, device=dev)
    gold = hjb_goldens()
    cells = {k: abs(v - gold[f"hjb_{k}"]) / hjb_dx(p) for k, v in b._asdict().items()}
    values = {k: abs(res.value_at(x) - gold[k])
              for k, x in (("hjb_entry_long_value_at_0", 0.0),
                           ("hjb_entry_long_value_at_m02", -0.2))}
    ok = bool(max(cells.values()) <= HJB_CELLS and max(values.values()) <= HJB_VALUE_ATOL)
    emit(phase="hjb_goldens", grid=[p.n_space, p.n_time], boundaries=b._asdict(),
         cells_off_golden=cells, value_abs_err=values, ok=ok)
    if not ok:
        raise AssertionError("HJB reference_compat misses the goldens")


def phase_hjb_brennan(torch, dev):
    """bench_full.py:887-907: solve_all_boundaries by Brennan-Schwartz at
    256x128, c = 0.002 (no kernel: a row loop of tensor ops), and by PSOR
    (K6) for comparison: entry_long < exit_long (bench_full.py:906), each
    boundary within one cell of PSOR's."""
    from pde_tpu_torch.solvers import hjb

    p = hjb.HJBParams(**HJB_BENCH, method="brennan_schwartz")
    t0 = time.perf_counter()
    b = hjb.solve_all_boundaries(p, device=dev)
    wall = time.perf_counter() - t0
    ps = hjb.solve_all_boundaries(p._replace(method="psor"), device=dev)
    diff = max(abs(x - y) for x, y in zip(b, ps))
    ok = bool(b.entry_long < b.exit_long and diff <= hjb_dx(p) + 1e-6)
    HJB_CARD["brennan_schwartz"] = b
    emit(phase="hjb_brennan_schwartz", grid=[p.n_space, p.n_time], boundaries=b._asdict(),
         psor_boundaries=ps._asdict(), max_abs_diff_vs_psor=diff, dx=hjb_dx(p),
         wall_s=wall, ok=ok)
    if not ok:
        raise AssertionError("HJB Brennan-Schwartz failed its checks")


def hjb_book(torch, dev, B=HJB_B):
    """bench_full.py:912-922's book: theta 0, mu in [2, 8], sigma in [0.05,
    0.2], float32 on ``dev``."""
    return dict(theta=torch.zeros(B, device=dev), mu=torch.linspace(2.0, 8.0, B, device=dev),
                sigma=torch.linspace(0.05, 0.2, B, device=dev), r=HJB_BENCH["r"],
                c_entry=HJB_BENCH["c_entry"], c_exit=HJB_BENCH["c_exit"], T=HJB_BENCH["T"],
                n_space=HJB_BENCH["n_space"], n_time=HJB_BENCH["n_time"])


def phase_hjb_batch(torch, dev, picks=(0, 21, 42, 63)):
    """boundaries_batch for the 64-config book at 256x128 by
    Brennan-Schwartz and by projection (one K5 launch a step on the (256,
    256) rows of the 64 configs' four problems); four of its configs
    within one cell of the port's own solve_all_boundaries on the card by
    the same method, on the config's grid."""
    from pde_tpu_torch.solvers import hjb

    book = hjb_book(torch, dev)
    mu, sigma, theta = (book[k].cpu().double().numpy() for k in ("mu", "sigma", "theta"))
    worst = {}
    for method in ("brennan_schwartz", "projection"):
        out = hjb.boundaries_batch(**book, method=method, device=dev)
        batch = hjb.extract_boundaries_batch(*out, mu, sigma, theta)
        dx = (out[0][:, 1] - out[0][:, 0]).cpu().double().numpy()
        over = 0.0
        for i in picks:
            ss = float(sigma[i] / (2.0 * mu[i]) ** 0.5)
            single = hjb.solve_all_boundaries(hjb.HJBParams(
                theta=float(theta[i]), mu=float(mu[i]), sigma=float(sigma[i]),
                **{k: HJB_BENCH[k] for k in ("r", "c_entry", "c_exit", "T", "n_space",
                                              "n_time")},
                x_min=-15.8 * ss, x_max=15.8 * ss, method=method), device=dev)
            over = max(over, max(abs(x - y) for x, y in zip(batch[i], single)) / dx[i])
        worst[method] = over
    ok = bool(max(worst.values()) <= 1.0 + 1e-4)
    emit(phase="hjb_boundaries_batch", B=HJB_B, grid=[HJB_BENCH["n_space"],
                                                   HJB_BENCH["n_time"]],
         configs_checked=list(picks), max_diff_over_dx_vs_single=worst, ok=ok)
    if not ok:
        raise AssertionError("boundaries_batch disagrees with solve_all_boundaries")


def phase_hjb_rows(torch, dev, reps=3):
    """The HJB rows timed outside the counted paths: solve_all_boundaries
    at 200x200 by projection and PSOR, bench_full.py's
    ``ou_freeboundary_psor_solve_s`` (Brennan-Schwartz at 256x128, median
    of ``reps``) and ``ou_freeboundary_batch64_books_per_sec``
    (boundaries_batch, B = 64, Brennan-Schwartz), and the same book by
    projection."""
    from pde_tpu_torch.solvers import hjb

    book = hjb_book(torch, dev)
    calls = {
        "projection_200x200": lambda: hjb.solve_all_boundaries(hjb.HJBParams(), device=dev),
        "psor_200x200": lambda: hjb.solve_all_boundaries(hjb.HJBParams(method="psor"),
                                                         device=dev),
        "brennan_schwartz_256x128": lambda: hjb.solve_all_boundaries(
            hjb.HJBParams(**HJB_BENCH, method="brennan_schwartz"), device=dev),
        "batch64_brennan_schwartz": lambda: hjb.boundaries_batch(**book, device=dev),
        "batch64_projection": lambda: hjb.boundaries_batch(**book, method="projection",
                                                           device=dev),
    }
    walls = {name: timed_walls(torch, dev, fn, reps)[1] for name, fn in calls.items()}
    med = {name: statistics.median(w) for name, w in walls.items()}
    HJB_CARD["ou_freeboundary_psor_solve_s"] = med["brennan_schwartz_256x128"]
    emit(phase="hjb_rows", wall_s=med, wall_s_runs=walls,
         ou_freeboundary_psor_solve_s=med["brennan_schwartz_256x128"],
         ou_freeboundary_batch64_books_per_sec=HJB_B / med["batch64_brennan_schwartz"],
         batch64_projection_books_per_sec=HJB_B / med["batch64_projection"])


def run_ou_hjb_paths(torch, dev, path):
    """The OU path, then the HJB paths, each through ``path`` (main's
    counted runner): the projection march makes one K5 launch a step and
    the PSOR march one K6 launch a step, all on the redesigned routes;
    Brennan-Schwartz has no kernel, its PSOR comparison one K6 launch a
    step; the goldens' projection marches (all four problems, then one),
    the book's projection march and its four single configs one K5 launch
    a step each.  Fails on any other count.  Returns {kernel: {path:
    launches}}."""
    path(phase_ou, torch, dev)
    launches = {"K5": {}, "K6": {}}

    def hjb_path(fn, *args, kernel, steps):
        route = f"{kernel}-smem" if kernel == "K5" else f"{kernel}-warp"
        counts, out = path(fn, torch, dev, *args, needs=(kernel, route))
        if counts[kernel] != steps or counts[route] != steps:
            raise AssertionError(f"{fn.__name__} launched {kernel} {counts[kernel]} times "
                                 f"({counts[route]} on its route), not {steps}")
        launches[kernel][fn.__name__] = counts[kernel]
        return out

    proj = hjb_path(phase_hjb_projection, kernel="K5", steps=200)
    hjb_path(phase_hjb_goldens, kernel="K5", steps=2 * 200)
    hjb_path(phase_hjb_psor, proj, kernel="K6", steps=200)
    hjb_path(phase_hjb_brennan, kernel="K6", steps=HJB_BENCH["n_time"])
    hjb_path(phase_hjb_batch, kernel="K5", steps=5 * HJB_BENCH["n_time"])
    return launches


def phase_grad_guard(torch, dev):
    """Each kernel wrapper on the card, given an input that requires grad:
    it raises (the kernels have no backward; the reference's pallas_call
    raises under jax.grad) and launches nothing; under torch.no_grad() it
    launches.  The fused-ADI book's entry point raises alike; and
    tridiagonal_solve under grad takes the differentiable thomas, whose
    gradient agrees with central differences."""
    from pde_tpu_torch.ops import adi_fused, cn1d_fused, cn1d_tv_fused, tridiag
    from pde_tpu_torch.solvers import heston_adi, lcp, local_vol_pde

    small = dict(n_spot=16, n_vol=8, n_time=4)
    k1_args = book(torch, dev, 4, torch.zeros(4), small)
    k2_args = k2_inputs(torch, dev, heston_params(**small))
    K, T, cf = lv_book(torch, dev, 4)
    flat = lambda s, t: torch.full_like(s, 0.2)  # noqa: E731
    k3_args = local_vol_pde._march_inputs(flat, K, T, cf, torch.zeros(4, device=dev), LV_R,
                                          LV_Q, 33, 4, 0.2, 5.0)[:3]
    k4_args = bs_inputs(torch, dev, 4, torch.zeros(4, device=dev), dict(n_space=32, n_time=4))
    system = seeded_system(torch, dev, 8, 32)
    psor = bs_system(torch, dev, 4, dict(n_space=32, n_time=4))
    wrappers = {
        "K1": (adi_fused.fused_douglas_march_batched,
               lambda a: adi_fused.fused_douglas_march_batched(a, *k1_args[1:], 16, 8, 4)),
        "K2": (adi_fused.fused_douglas_march,
               lambda a: adi_fused.fused_douglas_march(a, *k2_args[1:], 16, 8, 4)),
        "K3": (cn1d_tv_fused.fused_cn_march_1d_tv,
               lambda a: cn1d_tv_fused.fused_cn_march_1d_tv(a, *k3_args[1:], 33, 4)),
        "K4": (cn1d_fused.fused_cn_march_1d,
               lambda a: cn1d_fused.fused_cn_march_1d(a, k4_args[1], 32, 4)),
        "K5": (tridiag.thomas_batched, lambda a: tridiag.thomas_batched(*system[:3], a)),
        "K6": (lcp.projected_sor_batched,
               lambda a: lcp.projected_sor_batched(*psor[:3], a, psor[4])),
    }
    firsts = {"K1": k1_args[0], "K2": k2_args[0], "K3": k3_args[0], "K4": k4_args[0],
              "K5": system[3], "K6": psor[3]}
    result = {}
    for key, (wrapper, call) in wrappers.items():
        leaf = firsts[key].detach().clone().requires_grad_()
        before = wrapper.launches
        try:
            call(leaf)
            raised = False
        except RuntimeError as exc:
            raised = "no backward" in str(exc)
        refused = raised and wrapper.launches == before
        with torch.no_grad():
            call(leaf)
        sync(torch, dev)
        result[key] = refused and wrapper.launches == before + 1
    kappa = torch.tensor([2.0, 1.5], device=dev, requires_grad=True)
    try:
        heston_adi.solve_fused_batch(kappa, 0.04, 0.3, -0.7, 0.04, R, Q, 1.0, 100.0, 1.0,
                                     S0, device=dev, **small)
        result["solve_fused_batch"] = False
    except RuntimeError as exc:
        result["solve_fused_batch"] = "no backward" in str(exc)
    # tridiagonal_solve under grad: thomas, no launch, the gradient of
    # sum(x) by rhs against central differences in float32
    lower, diag, upper, rhs = (t.contiguous() for t in system)
    leaf = rhs.clone().requires_grad_()
    before = tridiag.thomas_batched.launches
    grad, = torch.autograd.grad(tridiag.tridiagonal_solve(lower, diag, upper, leaf).sum(),
                                leaf)
    eps = 1e-2
    bump = torch.zeros_like(rhs)
    bump[0, 5] = eps
    with torch.no_grad():
        fd = (tridiag.thomas(lower, diag, upper, rhs + bump).sum()
              - tridiag.thomas(lower, diag, upper, rhs - bump).sum()) / (2 * eps)
    fd_err = abs(float(grad[0, 5]) - float(fd))
    result["tridiagonal_solve"] = tridiag.thomas_batched.launches == before and fd_err < 1e-3
    ok = all(result.values())
    emit(phase="grad_guard", ok_by_wrapper=result, tridiagonal_solve_grad_vs_fd=fd_err, ok=ok)
    if not ok:
        raise AssertionError(f"the grad guard failed: {result}")


def keep(a):
    """A copy of a launcher's argument in its own layout: a band expanded
    over the batch stays one row expanded."""
    if not hasattr(a, "clone"):
        return a
    if a.dim() == 2 and a.shape[0] > 1 and a.stride(0) == 0:
        return a[:1].clone().expand_as(a)
    return a.clone()


class LaunchInputs:
    """Stands in for a kernel's launcher ``module.name`` while the main
    paths run: it keeps, for each path, a clone of the first argument set
    of each shape it is given, and calls through to the launcher."""

    def __init__(self, module, name):
        self.module, self.name, self.launch = module, name, getattr(module, name)
        self.path, self.kept = None, {}
        setattr(module, name, self)

    def __call__(self, *args):
        key = (self.path,) + tuple(tuple(a.shape) if hasattr(a, "shape") else a
                                   for a in args)
        if key not in self.kept:
            self.kept[key] = [keep(a) for a in args]
        return self.launch(*args)

    def on(self, path):
        """The argument sets kept on ``path``."""
        return [args for key, args in self.kept.items() if key[0] == path]

    def close(self):
        setattr(self.module, self.name, self.launch)


def phase_path_inputs(torch, dev, k5_inputs, k6_inputs, k5_path, k6_path, extra=()):
    """K5 and K6 against their plain twins on every argument set the main
    paths gave them, then timed at the shapes of ``k5_path`` (the scan's S
    and v sweeps, one launch each a step: the kernel line gives the mean of
    one launch) and ``k6_path`` (the PSOR solve's systems, started at V);
    and, on lines of their own, at the shapes of each (kernel, path) of
    ``extra``, whose rows are returned under ``"kernel:path"``."""
    from pde_tpu_torch.ops import tridiag
    from pde_tpu_torch.solvers import lcp

    worst = {"K5": 0.0, "K6": 0.0}
    for (path, *_), args in k5_inputs.kept.items():
        B, n = args[3].shape
        X = tridiag.thomas_batched(*args)
        err = compare(torch, dev, X, tridiag._thomas_batched_plain(*args), kernel="K5",
                      case=path, B=B, n=n)
        worst["K5"] = max(worst["K5"], err)
    for (path, *_), (lower, diag, upper, b, g, x0, omega, n_iter) in k6_inputs.kept.items():
        x, _ = lcp.projected_sor_batched(lower, diag, upper, b, g, omega=omega,
                                         n_iter=n_iter, x0=x0)
        xp, _ = lcp._projected_sor(lower, diag, upper, b, g, x0, omega, n_iter)
        err = compare(torch, dev, x, xp, kernel="K6", case=path, B=b.shape[0], n=b.shape[1],
                      n_iter=n_iter, x0=x0 is not None)
        worst["K6"] = max(worst["K6"], err)

    k5 = [k5_timing(torch, dev, *args) for args in k5_inputs.on(k5_path)]
    k6 = [k6_timing(torch, dev, *args) for args in k6_inputs.on(k6_path)]
    out = {}
    for key, rows, path in (("K5", k5, k5_path), ("K6", k6, k6_path)):
        if not rows:
            raise AssertionError(f"{path} gave {key} no input")
        mean = lambda f: sum(r[f] for r in rows) / len(rows)  # noqa: E731
        out[key] = dict(max_abs_err=worst[key], ms=mean("ms"), plain_ms=mean("plain_ms"),
                        first_design_ms=mean("first_design_ms"),
                        bound=bound(mean("n_bytes"), mean("n_flops")))
        if key == "K5":
            out[key].update(library_ms=mean("library_ms"))
        emit(phase="kernel_timing", kernel=key, case=path, per_launch_mean=out[key]["ms"],
             first_design_per_launch_mean=out[key]["first_design_ms"], shapes=rows)
    for key, path in extra:
        inputs, timing = ((k5_inputs, k5_timing) if key == "K5" else (k6_inputs, k6_timing))
        rows = [timing(torch, dev, *args) for args in inputs.on(path)]
        if not rows:
            raise AssertionError(f"{path} gave {key} no input")
        for r in rows:
            r["bound"] = bound(r["n_bytes"], r["n_flops"])
        emit(phase="kernel_timing", kernel=key, case=path, shapes=rows)
        out[f"{key}:{path}"] = rows
    return out


def fourier_profile_rows(torch, dev):
    """One call of each Fourier-priced row, float32 on the card."""
    from pde_tpu_torch.calibrate.rough import RoughHestonCalibrator
    from pde_tpu_torch.models import bates, digital, forward_start, multi_asset, varswap

    f32 = torch.float32
    _, K, t_idx, uT = pricing_book(torch, dev, f32)
    hp, bp = (fourier_params(torch, dev, f32, w) for w in ("heston", "bates"))
    k_fs = torch.linspace(0.7, 1.3, FS_N, device=dev)
    ks, q, fwd = strip_chain(torch, dev, f32)
    k2, rho2 = two_asset_book(torch, dev, f32)
    data = RoughHestonCalibrator.generate_synthetic_surface(n_steps=96, device=dev, dtype=f32)
    rcal = RoughHestonCalibrator(n_steps=96, max_iter=40, device=dev, dtype=f32)
    T32 = torch.tensor(0.5, device=dev)
    return {
        "bates_pricing_grouped_8192": lambda: bates.price_carr_madan_gl_grouped(
            bp, K, t_idx, uT, S0, R, Q),
        "digital_pricing_grouped_8192": lambda: digital.price_grouped(
            hp, K, t_idx, uT, S0, R, Q),
        "forward_start_smile256": lambda: forward_start.price_forward_start(
            hp, k_fs, 0.5, 1.0, rate=R, dividend=Q),
        "rough_heston_smile64": lambda: rough_smile(torch, dev, f32),
        "rough_heston_surface_calibration": lambda: rcal.calibrate(
            data["strikes"], data["maturities"], data["mid_prices"], data["S0"], data["r"],
            data["q"]),
        "varswap_strip_1024": lambda: varswap.strip_variance(ks, q, fwd, 0.5, 0.03),
        "volswap_exact_strike": lambda: varswap.fair_volatility_strike(bp, T32),
        "spread_quad_4096": lambda: multi_asset.spread_price_quad(
            strike=k2, rho=rho2, **TWO_ASSET),
        "rainbow_stulz_4096": lambda: multi_asset.rainbow_two_asset_price(
            strike=k2.abs() + 80.0, rho=rho2, kind="call_on_min", **TWO_ASSET),
    }


def rates_profile_rows(torch, dev):
    """One call of each rates and credit row, float32 on the card."""
    from pde_tpu_torch.calibrate.g2 import G2Calibrator
    from pde_tpu_torch.calibrate.rates import HullWhiteCalibrator

    f32 = torch.float32
    caplets = hw_caplet_desk(torch, dev, f32)
    swaptions = g2_swaption_desk(torch, dev, f32)
    hw_cal = HullWhiteCalibrator(max_iter=60, device=dev, dtype=f32)
    g2_cal = G2Calibrator(max_iter=60, device=dev, dtype=f32)
    return {
        "hw_swaption_panel_256": swaption_panel(torch, dev, f32, "hw", HW_PANEL_N),
        "hw_caplet_calibration": lambda: hw_cal.calibrate_caplets(*caplets),
        "g2_swaption_panel_128": swaption_panel(torch, dev, f32, "g2", G2_PANEL_N, n_gh=64),
        "g2_swaption_calibration": lambda: g2_cal.calibrate_swaptions(*swaptions),
        "cds_bootstrap_5pillar": cds_bootstrap(torch, dev, f32)[1],
    }


def mc_profile_rows(torch, dev):
    """One call of each Heston Monte Carlo row, float32 on the card."""
    from pde_tpu_torch.models import heston_mc
    from pde_tpu_torch.solvers import lsm, lsm_dual

    p32 = fourier_params(torch, dev, torch.float32, "heston")
    gen = torch.Generator(device=dev).manual_seed(0)
    kw = dict(rate=R, n_steps=MC_STEPS, n_paths=LSM_PATHS)
    k, calls = lsm_book(torch, dev, torch.float32)
    k16 = torch.linspace(80.0, 120.0, 16, device=dev)
    return {
        "heston_mc_qe_131072x64": lambda: heston_mc.simulate_qe(
            p32, S0, 1.0, gen, n_steps=MC_STEPS, n_paths=MC_PATHS, rate=R, dividend=Q),
        "heston_american_lsm_65536x64": lambda: lsm.price_american_lsm(
            p32, 100.0, 1.0, S0, gen, is_call=False, **kw),
        "heston_american_lsm_batch128": lambda: lsm.price_american_lsm_batch(
            p32, k, calls, 1.0, S0, gen, **kw),
        "lsm_dual_sandwich": lambda: lsm_dual.dual_upper_bound(
            p32, 100.0, 1.0, S0, gen, rate=R, is_call=False, **DUAL),
        "heston_mc_ad_greeks_16strike": lambda: heston_mc.greeks_european_mc(
            p32, k16, 1.0, S0, gen, rate=R, dividend=Q, n_steps=MC_STEPS, n_paths=LSM_PATHS),
    }


def mc_desk_profile_rows(torch, dev):
    """One call of each row of the rest of the Monte Carlo desk, float32 on
    the card."""
    from pde_tpu_torch.models import credit, multi_asset, slv
    from pde_tpu_torch.solvers import bermudan_hw

    book = basket_book(torch, dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    p32 = fourier_params(torch, dev, torch.float32, "heston")
    hw, sched, par, _ = bermudan_ladder(torch, dev, torch.float32)
    desk = cva_desk(torch, dev, torch.float32)
    return {
        "basket_mc_cv_1048576": lambda: multi_asset.price_basket_mc(
            gen, book[0], book[1], book[2], 0.9, book[3], book[4], rate=0.03,
            n_paths=BASKET_N),
        "slv_calibration_65536x48": lambda: slv.calibrate_leverage(
            p32, lambda s, t: torch.full_like(s, 0.2), S0, SLV_T, gen, **SLV),
        "hw_bermudan_pde_ladder_64": lambda: ladder_prices(torch, dev, torch.float32),
        "hw_bermudan_mc_sandwich": lambda: bermudan_hw.bermudan_swaption_mc(
            hw, par, sched, gen, **BERM_MC),
        "cva_netting4": lambda: credit.cva_netting_hw_mc(*desk, gen, n_paths=CVA_N),
    }


def pide_profile_rows(torch, dev):
    """One call of each jump-diffusion and barrier row, float32 on the card."""
    from pde_tpu_torch.solvers import barrier_pde, bates_pide, heston_adi

    f32 = torch.float32
    p, pb = bates_pide_params(), heston_adi.HestonPDEParams(**BARRIER_HESTON)
    return {
        "pide_merton_strip128": lambda: pide_strip(torch, dev, f32, "merton").price,
        "pide_kou_american_strip128": lambda: pide_strip(torch, dev, f32, "kou",
                                                         is_call=False, american=True).price,
        "bates_pide_american": lambda: bates_pide.solve_bates_pide(p, S0, device=dev,
                                                                   dtype=f32).price,
        "barrier_up_and_out_200x60x200": lambda: barrier_pde.solve_barrier(
            pb, S0, 120.0, "up-and-out", device=dev, dtype=f32).price,
    }


def profile_rows(torch, dev, interp, top=4):
    """One warm call of each row under ``torch.profiler``: the call's wall,
    the card's busy time (device time of its kernels), the idle share and
    the kernels that took most of the device time."""
    import numpy as np

    from pde_tpu_torch.calibrate.heston import HestonCalibrator
    from pde_tpu_torch.calibrate.sabr import SABRCalibrator
    from pde_tpu_torch.models import heston, ou, sabr
    from pde_tpu_torch.ops import tridiag
    from pde_tpu_torch.solvers import bs_pde, heston_adi, hjb, lcp, local_vol_pde

    K, T, cf = lv_book(torch, dev, LV_B)
    system = bs_system(torch, dev)
    american_put = bs_pde.BSPDEParams(is_call=False, american=True,
                                      american_method="psor", **BS_GRID)
    Kb = torch.linspace(80.0, 120.0, BS_B, device=dev)
    Tb = torch.linspace(0.25, 1.5, BS_B, device=dev)
    cb = (torch.arange(BS_B, device=dev) % 2).float()
    sig = torch.linspace(0.15, 0.45, BS_B, device=dev)
    Ks = np.linspace(80.0, 120.0, 11)
    F1 = 100.0 * float(np.exp(0.03))
    vols = sabr.implied_volatilities(torch.as_tensor(Ks, device=dev), F1, 1.0,
                                     sabr.SABRParams(**SABR_TRUTH)).cpu().numpy()
    cal = SABRCalibrator(beta=0.5, device=dev, dtype=torch.float32)
    ou_p = ou.OUParams(**OU)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    paths = ou.simulate(ou_p, OU["theta"], 1.0, OU_STEPS, gen, shape=(OU_PATHS,), device=dev)
    hbook = hjb_book(torch, dev)
    pricing = pricing_book(torch, dev, torch.float32)
    cal_book = calibrate_batch_book(torch, dev, torch.float32)
    calibrator = HestonCalibrator(seed=42, device=dev, dtype=torch.float32, **BUDGET)
    rows = {
        "fused_adi_book": lambda: heston_adi.solve_fused_batch(
            2.0, 0.04, 0.3, -0.7, 0.04, R, Q, Tb, Kb, cb, S0, device=dev, **GRID),
        "local_vol_book": lambda: local_vol_pde.solve_fused_batch(
            interp, 100.0, K=K, T=T, is_call=cf, r=LV_R, q=LV_Q, device=dev, **LV_GRID),
        "bs_american_book": lambda: bs_pde.solve_fused_batch(
            sig, BS_R, BS_Q, Tb, Kb, cb, 100.0, american=torch.ones(BS_B, device=dev),
            device=dev, **BS_GRID),
        "sabr_smile": lambda: cal.calibrate_single_maturity(Ks, vols, F1, 1.0),
        "heston_adi_solve": lambda: heston_adi.solve(heston_params(), 100.0, device=dev),
        "heston_adi_fused": lambda: heston_adi.solve_fused(heston_params(), 100.0,
                                                           device=dev),
        "bs_pde_solve_psor": lambda: bs_pde.solve(american_put, 100.0, device=dev),
        "k6_projected_sor": lambda: lcp.projected_sor_batched(*system),
        "k5_thomas_batched": lambda: tridiag.thomas_batched(*system[:4]),
        "ou_sim252": lambda: ou.simulate(ou_p, OU["theta"], 1.0, OU_STEPS, gen,
                                         shape=(OU_PATHS,), device=dev),
        "ou_mle252": lambda: ou.fit_mle(paths, 1.0 / OU_STEPS),
        "ou_longpath": lambda: ou.simulate_parallel(ou_p, OU["theta"], 4.0, OU_LONG, gen,
                                                    device=dev),
        "hjb_projection_200x200": lambda: hjb.solve_all_boundaries(hjb.HJBParams(),
                                                                   device=dev),
        "hjb_psor_200x200": lambda: hjb.solve_all_boundaries(hjb.HJBParams(method="psor"),
                                                             device=dev),
        "hjb_brennan_schwartz_256x128": lambda: hjb.solve_all_boundaries(
            hjb.HJBParams(**HJB_BENCH, method="brennan_schwartz"), device=dev),
        "hjb_batch64_brennan_schwartz": lambda: hjb.boundaries_batch(**hbook, device=dev),
        "hjb_batch64_projection": lambda: hjb.boundaries_batch(**hbook, method="projection",
                                                               device=dev),
        "heston_pricing_grouped_8192": lambda: heston.price_carr_madan_grouped(
            *pricing, S0, R, Q),
        "heston_calibrate_batch_16": lambda: calibrator.calibrate_batch(*cal_book, R, Q),
        **fourier_profile_rows(torch, dev),
        **rates_profile_rows(torch, dev),
        **mc_profile_rows(torch, dev),
        **mc_desk_profile_rows(torch, dev),
        **pide_profile_rows(torch, dev),
        **signal_profile_rows(torch, dev),
        **backtest_profile_rows(torch, dev),
        **cli_profile_rows(torch, dev),
        **parallel_profile_rows(torch, dev),
    }
    only = [a for a in sys.argv[1:] if not a.startswith("-")]
    for name, fn in rows.items():
        if only and not any(name.startswith(o) for o in only):
            continue
        wall, dev_us = profiled(torch, dev, fn)
        busy = sum(dev_us.values()) * 1e-6
        emit(phase="profile", row=name, wall_s=wall, device_busy_s=busy,
             idle_share=1.0 - busy / wall, n_kernels=len(dev_us),
             top=sorted(((k, v * 1e-3) for k, v in dev_us.items()),
                        key=lambda kv: -kv[1])[:top])


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    from pde_tpu_torch.ops import adi_fused, build, cn1d_fused, cn1d_tv_fused, tridiag
    from pde_tpu_torch.solvers import lcp

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    emit(phase="device", kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t_start = t0 = time.perf_counter()
    sources = dict.fromkeys([k["source"].rsplit("/", 1)[1] for k in KERNELS.values()]
                            + list(build.VARIANTS))
    built = build.load_libraries(*sources)
    nS_nv = (GRID["n_spot"], GRID["n_vol"])
    emit(phase="build", seconds=time.perf_counter() - t0,
         ptxas={src: [ln.strip() for ln in log.splitlines()
                      if "entry function" in ln or "registers" in ln or "spill" in ln]
                for src, (_, log) in built.items()},
         # dynamic shared memory per block of the redesigned routes at the
         # bench shapes (ptxas reports static shared memory only)
         smem_bytes_per_block={
             "K1 (100x50)": adi_fused._smem_plan(*nS_nv, False)[3],
             "K1 (100x50, use_it)": adi_fused._smem_plan(*nS_nv, True)[3],
             **{f"{key} (100x50{it})": adi_fused._route_plan(
                 *nS_nv, bool(it), variant.get("pcr_v", False),
                 variant.get("pcr_s", False))[3]
                for key, variant in PCR_VARIANTS.items() for it in ("", ", use_it")},
             "K2 (100x50)": adi_fused._smem_plan_single(*nS_nv)[4],
             "K3 (n=200)": cn1d_tv_fused._smem_bytes(LV_GRID["n_space"]),
             "K4 (n=200)": cn1d_fused._warp_plan(BS_GRID["n_space"])[1],
             **{f"K5 (n={n})": tridiag._lane_plan(n)[3] for n in (50, 100, 200)}})

    # each kernel's launch count: (wrapper, attribute); the launches of the
    # redesigned routes of K1 (Thomas and PCR sweeps), K2, K3, K4, K5 and K6
    # and of K1's PCR variants are counted apart from their launches of
    # every kind
    k1, k2 = adi_fused.fused_douglas_march_batched, adi_fused.fused_douglas_march
    k3, k5 = cn1d_tv_fused.fused_cn_march_1d_tv, tridiag.thomas_batched
    k4, k6 = cn1d_fused.fused_cn_march_1d, lcp.projected_sor_batched
    counters = {"K1": (k1, "launches"), "K1-smem": (k1, "launches_smem"),
                "K1-pcr_v": (k1, "launches_pcr_v"), "K1-pcr_s": (k1, "launches_pcr_s"),
                "K1-pcr_v-smem": (k1, "launches_pcr_v_smem"),
                "K1-pcr_s-smem": (k1, "launches_pcr_s_smem"),
                "K2": (k2, "launches"), "K2-smem": (k2, "launches_smem"),
                "K3": (k3, "launches"), "K3-smem": (k3, "launches_smem"),
                "K4": (k4, "launches"), "K4-warp": (k4, "launches_warp"),
                "K5": (k5, "launches"), "K5-smem": (k5, "launches_smem"),
                "K6": (k6, "launches"), "K6-warp": (k6, "launches_warp")}
    interp = lv_surface(torch, dev)
    if "--profile" in sys.argv[1:]:
        profile_rows(torch, dev, interp)
        return
    measured = {"K1": phase_kernel(torch, dev), **phase_k1_pcr(torch, dev),
                "K2": phase_k2(torch, dev), "K3": phase_k3(torch, dev, interp),
                "K4": phase_k4(torch, dev)}
    bench_err = {"K5": phase_k5(torch, dev), "K6": phase_k6(torch, dev)}
    phase_grad_guard(torch, dev)

    # the main paths: every count is 0 just before a path and read just
    # after; a path that never launched a kernel it needs fails.  K5's and
    # K6's launchers keep the inputs each path gives them.
    k5_inputs = LaunchInputs(tridiag, "_launch_thomas")
    k6_inputs = LaunchInputs(lcp, "_launch_psor")

    path_seconds = {}
    launches_parallel = {}
    launches_rest = {}

    def path(fn, *args, needs=()):
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        k5_inputs.path = k6_inputs.path = fn.__name__
        t0 = time.perf_counter()
        out = fn(*args)
        counts = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
        path_seconds[fn.__name__] = time.perf_counter() - t0
        emit(phase="launches", path=fn.__name__, seconds=path_seconds[fn.__name__],
             counts={k: n for k, n in counts.items() if n})
        missing = [k for k in needs if counts[k] == 0]
        if missing:
            raise AssertionError(f"{fn.__name__} never launched {missing}")
        return counts, out

    path(phase_calibration, torch, dev, torch.float32)
    # the Heston pricing and batched calibration rows launch no kernel, and
    # their launch lines must say so
    for fn, *args in ((phase_heston_extras,), (phase_calibrate_batch,),
                      *((f,) for f in (*FOURIER_PHASES, *RATES_PHASES, *MC_PHASES,
                                       *MC_DESK_PHASES)),
                      (phase_lv_european_mc, interp)):
        counts = path(fn, torch, dev, *args)[0]
        if any(counts.values()):
            raise AssertionError(f"{fn.__name__} launched a kernel: {counts}")
    launches = {"K1": path(phase_book, torch, dev, needs=("K1", "K1-smem"))[0]["K1"],
                "K3": path(phase_local_vol_book, torch, dev, interp,
                           needs=("K3", "K3-smem"))[0]["K3"],
                "K4": path(phase_bs_book, torch, dev, needs=("K4", "K4-warp"))[0]["K4"]}
    path(phase_sabr, torch, dev)
    counts, scan = path(phase_heston_scan, torch, dev, needs=("K5", "K5-smem"))
    launches["K5"] = counts["K5"]
    launches["K2"] = path(phase_heston_fused, torch, dev, scan,
                          needs=("K2", "K2-smem"))[0]["K2"]
    path(phase_heston_lcp, torch, dev, needs=("K5", "K5-smem", "K2", "K2-smem"))
    path(phase_heston_surface, torch, dev, needs=("K5", "K5-smem", "K1", "K1-smem"))
    path(phase_greeks, torch, dev)
    # each PCR book on its own, so that each variant's launches are its own;
    # K1-pcr_v+s counts its launches of both sweeps
    for key, variant in PCR_VARIANTS.items():
        needs = tuple(f"K1-{v}{tail}" for v in ("pcr_v", "pcr_s") if variant.get(v)
                      for tail in ("", "-smem"))
        counts = path(phase_pcr_book, torch, dev, key, needs=needs)[0]
        launches[key] = counts["K1-pcr_v" if "pcr_v" in variant else "K1-pcr_s"]
    launches["K6"] = path(phase_bs_solve, torch, dev,
                          needs=("K5", "K5-smem", "K6", "K6-warp"))[0]["K6"]
    path(phase_tridiagonal_solve, torch, dev, needs=("K5", "K5-smem"))
    path(phase_projected_sor, torch, dev, needs=("K6", "K6-warp"))
    hjb_launches = run_ou_hjb_paths(torch, dev, path)
    # the Bermudan ladder: one K5 launch a step on the lane route, exactly
    counts = path(phase_hw_bermudan_pde_ladder, torch, dev, needs=("K5", "K5-smem"))[0]
    if counts["K5"] != BERM_STEPS or counts["K5-smem"] != BERM_STEPS:
        raise AssertionError(f"the Bermudan ladder launched K5 {counts['K5']} times "
                             f"({counts['K5-smem']} on its route), not {BERM_STEPS}")
    # the jump-diffusion and barrier solvers: every implicit sweep one K5
    # launch on the lane route, exactly
    for fn, steps in PIDE_PATHS:
        counts = path(fn, torch, dev, needs=("K5", "K5-smem"))[0]
        if counts["K5"] != steps or counts["K5-smem"] != steps:
            raise AssertionError(f"{fn.__name__} launched K5 {counts['K5']} times "
                                 f"({counts['K5-smem']} on its route), not {steps}")
    k5_inputs.close()
    k6_inputs.close()
    measured.update(phase_path_inputs(torch, dev, k5_inputs, k6_inputs,
                                      "phase_heston_scan", "phase_bs_solve",
                                      extra=(("K5", "phase_hjb_projection"),
                                             ("K5", "phase_hjb_batch"),
                                             ("K6", "phase_hjb_psor"),
                                             ("K5", "phase_hw_bermudan_pde_ladder"),
                                             ("K5", "phase_pide_merton_strip"))))
    phase_hjb_rows(torch, dev)
    # the native HJB route runs on the host: it launches nothing
    counts = path(phase_hjb_native, torch, dev)[0]
    if any(counts.values()):
        raise AssertionError(f"phase_hjb_native launched a kernel: {counts}")
    phase_bermudan_rows(torch, dev)
    # the signal, sizing, VaR and serving layer launches no kernel
    for fn in SIGNAL_PHASES:
        counts = path(fn, torch, dev)[0]
        if any(counts.values()):
            raise AssertionError(f"{fn.__name__} launched a kernel: {counts}")
    emit(phase="signal_serving_seconds",
         seconds={fn.__name__: path_seconds[fn.__name__] for fn in SIGNAL_PHASES},
         total_s=sum(path_seconds[fn.__name__] for fn in SIGNAL_PHASES))
    # the backtests, validation statistics, linear algebra and options data
    # launch no kernel
    for fn in BACKTEST_PHASES:
        counts = path(fn, torch, dev)[0]
        if any(counts.values()):
            raise AssertionError(f"{fn.__name__} launched a kernel: {counts}")
    emit(phase="backtest_validation_seconds",
         seconds={fn.__name__: path_seconds[fn.__name__] for fn in BACKTEST_PHASES},
         total_s=sum(path_seconds[fn.__name__] for fn in BACKTEST_PHASES))
    # the command line: only the PDE, PIDE and Bermudan subcommands launch a
    # kernel (K5, on its lane route); the Merton strip exactly as often as
    # phase_pide_merton_strip
    for fn, needs in CLI_PATHS:
        counts = path(fn, torch, dev, needs=needs)[0]
        if not needs and any(counts.values()):
            raise AssertionError(f"{fn.__name__} launched a kernel: {counts}")
        if needs and counts["K5"] != counts["K5-smem"]:
            raise AssertionError(f"{fn.__name__} launched K5 off its lane route: {counts}")
        if fn.__name__ == "phase_cli_pide_merton" and counts["K5"] != PIDE_STEPS:
            raise AssertionError(f"cli pide launched K5 {counts['K5']} times, not {PIDE_STEPS}")
    phase_cli_seconds(torch, dev)
    # the parallel layer on a world-size-1 NCCL group: the sharded solves
    # launch K5 exactly as PERF.md predicts, the rest launch none
    t_par = time.perf_counter()
    par = {}
    for fn, needs in PARALLEL_PATHS:
        counts, par[fn.__name__] = path(fn, torch, dev, needs=needs)
        want = PARALLEL_LAUNCHES.get(fn.__name__, 0)
        if counts["K5"] != want or counts["K5-smem"] != want or any(
                n for k, n in counts.items() if not k.startswith("K5")):
            raise AssertionError(f"{fn.__name__} launched {counts}, not K5 {want} times")
        if want:
            launches_parallel[fn.__name__] = counts["K5"]
    phase_parallel_vs_single(torch, dev, par["phase_parallel_heston"], par["phase_parallel_bs"])
    parallel_rows(torch, dev)
    emit(phase="parallel_seconds",
         seconds={fn.__name__: path_seconds[fn.__name__] for fn, _ in PARALLEL_PATHS},
         total_s=time.perf_counter() - t_par)
    # the collective audit at one rank: the sharded solves it runs launch K5
    counts = path(phase_comm_audit, torch, dev, needs=("K5", "K5-smem"))[0]
    if counts["K5"] != AUDIT_LAUNCHES or counts["K5-smem"] != AUDIT_LAUNCHES or any(
            n for k, n in counts.items() if not k.startswith("K5")):
        raise AssertionError(f"phase_comm_audit launched {counts}, not K5 "
                             f"{AUDIT_LAUNCHES} times")
    launches_rest["phase_comm_audit"] = counts["K5"]
    close_group()
    # the services facade and the health manager launch no kernel
    t_svc = time.perf_counter()
    counts, walls = path(phase_services, torch, dev)
    if any(counts.values()):
        raise AssertionError(f"phase_services launched a kernel: {counts}")
    emit(phase="services_seconds", seconds=walls, total_s=time.perf_counter() - t_svc)
    # the C++ reference's Heston oracle in float64 on the card (no kernel),
    # and the native host bindings against the port's card functions: K5
    # exactly once for the Thomas solve and 200 times for the Heston march
    counts = path(phase_golden_pde, torch, dev)[0]
    if any(counts.values()):
        raise AssertionError(f"phase_golden_pde launched a kernel: {counts}")
    for fn in NATIVE_PATHS:
        want = NATIVE_LAUNCHES[fn.__name__]
        counts = path(fn, torch, dev, needs=("K5", "K5-smem") if want else ())[0]
        if counts["K5"] != want or counts["K5-smem"] != want or any(
                n for k, n in counts.items() if not k.startswith("K5")):
            raise AssertionError(f"{fn.__name__} launched {counts}, not K5 {want} times")
        if want:
            launches_rest[fn.__name__] = counts["K5"]
    rest = ("phase_golden_pde", *(fn.__name__ for fn in NATIVE_PATHS), "phase_comm_audit")
    emit(phase="rest_of_port_seconds", seconds={k: path_seconds[k] for k in rest},
         total_s=sum(path_seconds[k] for k in rest))
    # what the PIDE phases cost against the repeats cut to pay for them
    new_s = {fn.__name__: path_seconds[fn.__name__] for fn, _ in PIDE_PATHS}
    new_s.update(phase_hjb_native=path_seconds["phase_hjb_native"],
                 phase_pide_rows=phase_pide_rows(torch, dev))
    saved = {k: wall * runs for k, (wall, runs) in REPEATS_CUT.items()}
    emit(phase="smoke_budget", new_phases_s=new_s, new_total_s=sum(new_s.values()),
         repeats_cut_s=saved, saved_total_s=sum(saved.values()))
    phase_k1_routes(torch, dev)
    for k, err in bench_err.items():
        measured[k]["max_abs_err"] = max(measured[k]["max_abs_err"], err)

    # K5 on the Bermudan ladder: its launches and its times at (64, 257)
    berm = measured["K5:phase_hw_bermudan_pde_ladder"][0]
    berm_bound_ms, berm_bound_by = berm["bound"]
    # and on the Merton PIDE strip: its launches and its times at (128, 512)
    strip = measured["K5:phase_pide_merton_strip"][0]
    strip_bound_ms, strip_bound_by = strip["bound"]
    on_paths = {"K5": {"launches_bermudan": BERM_STEPS, "bermudan": dict(
        B=berm["B"], n=berm["n"], ms=berm["ms"], plain_ms=berm["plain_ms"],
        bound_ms=berm_bound_ms, bound_by=berm_bound_by, library_ms=berm["library_ms"]),
        "launches_parallel": launches_parallel, "launches_rest_of_port": launches_rest,
        "launches_pide": PIDE_STEPS, "pide": dict(
        B=strip["B"], n=strip["n"], ms=strip["ms"], plain_ms=strip["plain_ms"],
        bound_ms=strip_bound_ms, bound_by=strip_bound_by, library_ms=strip["library_ms"])}}
    rows = []
    for k, info in KERNELS.items():
        m = measured[k]
        bound_ms, bound_by = m["bound"]
        rows.append({**info, "launches": launches[k], "max_abs_err": m["max_abs_err"],
                     "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": m.get("library_ms"),
                     **({"launches_hjb": hjb_launches[k]} if k in hjb_launches else {}),
                     **on_paths.get(k, {})})
    emit(phase="smoke_seconds", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    finally:
        close_group()
    sys.exit(0)

#!/usr/bin/env python3
"""Drive the PyTorch port of the DVFS scheduler on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases (each prints one line; any failed check makes the script exit 1
without the final result line):

1. build — ``nvcc`` compiles every CUDA kernel of the port from
   ``src/repro_torch/kernels/csrc/`` (one process per source, all at once);
2. kernel — the ``dvfs_opt`` CUDA kernel against its plain torch version
   on the card, on a 1,048,576-row fuzz matrix made from ``--seed`` plus the
   app-library rows; then both timed with CUDA events at 300k rows (the
   main path's Algorithm-1 batch) and at 1M rows, beside the least time the
   card could take;
3. online — the main path: ``schedule_online`` on a 100k-task uniform day
   over the three-class fleet (l=4, theta=0.9, EDL, pipelined) with the
   kernel, checked against the same run through the torch grid+golden
   solvers on the card;
4. offline — ``schedule_offline`` on 20k tasks, the same checks.

Before the last line it prints the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them) and a JSON line of kernel measurements; the last line is
``{"ok": true, "device": {...}}``.  It needs one CUDA card and exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The main path's Algorithm-1 batch (100k tasks x 3 classes) and the fuzz size.
MAIN_ROWS = 300_000
FUZZ_ROWS = 1 << 20
CLASSES = ("gtx-1080ti", "tpu-v5e", "v100-sxm2")

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, and
# HBM3 bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

# Float32 operations per task row of csrc/dvfs_opt.cu, counted from the
# source with every add, subtract, multiply, divide, square root, min/max,
# compare and select as one operation (a division is some ten instructions
# on the card, so this count gives a bound the kernel cannot reach).
OPS_UNC_EVAL = 40    # Unconstrained::at: 4 divisions, 1 sqrt
OPS_BND_EVAL = 41    # Boundary::at: 4 divisions
OPS_COARSE_POINT = 2  # i / (G0 - 1) and the running-min compare
OPS_FINE_POINT = 5    # j / (G1 - 1), the bracket lerp, the compare
OPS_BRACKET = 12      # f0_best, f_lo, f_hi, the guard
OPS_ROW = 41          # g1(v_max), t_min, feasibility, pick, p, t, e
BYTES_ROW = 16 * 4 + 8 * 4   # one [16] f32 row read, one [8] f32 row written


def ops_per_row(g0: int, g1: int) -> int:
    """Operations of one row: two hierarchical sweeps of g0 + g1 points plus
    the re-evaluation at each winner, then the decision rule."""
    sweep_extra = g0 * OPS_COARSE_POINT + g1 * OPS_FINE_POINT + OPS_BRACKET
    return ((g0 + g1 + 1) * (OPS_UNC_EVAL + OPS_BND_EVAL)
            + 2 * sweep_extra + OPS_ROW)


def bound_ms(rows: int, g0: int, g1: int) -> tuple:
    """The least time an H100 could take for ``rows`` rows: the larger of the
    operation time and the byte time, and which of the two it is."""
    t_ops = rows * ops_per_row(g0, g1) / PEAK_F32_OPS * 1e3
    t_bytes = rows * BYTES_ROW / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Checks:
    """Collects failed checks; a phase records what it compared."""

    def __init__(self):
        self.failed = []

    def expect(self, ok: bool, what: str):
        if not ok:
            self.failed.append(what)
            print(f"FAILED: {what}", flush=True)


def fuzz_matrix(np, dvfs, tasks, seed: int, n: int):
    """The ``[n, 16]`` fuzz rows of the kernel tests, vectorized: random
    params, mixed scaling boxes including a degenerate single-point one,
    30% readjust rows, windows from half of t_min up to 2 t*; followed by
    the app-library rows on each class box at eight windows each."""
    rng = np.random.default_rng(seed)
    p_star = rng.uniform(120, 260, n)
    gamma = p_star * rng.uniform(0.05, 0.25, n)
    p0 = p_star * rng.uniform(0.1, 0.5, n)
    c = p_star - gamma - p0
    big_d = rng.uniform(1.0, 50.0, n)
    delta = rng.uniform(0.0, 1.0, n)
    t0 = rng.uniform(0.05, 5.0, n)
    boxes = [dvfs.WIDE.bounds(), dvfs.NARROW.bounds(),
             dvfs.TPU_V5E_INTERVAL.bounds()]
    for _ in range(2):
        v_min = float(rng.uniform(0.5, 0.9))
        v_max = float(rng.uniform(v_min + 0.05, 1.24))
        fm_min = float(rng.uniform(0.5, 0.9))
        boxes.append((v_min, v_max, float(rng.uniform(0.5, 0.8)), fm_min,
                      float(rng.uniform(fm_min + 0.05, 1.2))))
    v = float(rng.uniform(0.7, 1.2))
    boxes.append((v, v, dvfs.g1_float(v), 1.0, 1.0))   # one point
    bounds = np.asarray(boxes, np.float64)[rng.integers(0, len(boxes), n)]
    fc_max = np.sqrt(np.maximum(bounds[:, 1] - 0.5, 0.0) / 2.0) + 0.5
    tmin = big_d * (delta / fc_max + (1.0 - delta) / bounds[:, 4]) + t0
    tstar = big_d + t0
    readj = (rng.random(n) < 0.3).astype(np.float64)
    lo = np.where(readj > 0.5, tmin, 0.5 * tmin)
    allowed = lo + (2.0 * tstar - lo) * rng.random(n)
    fuzz = np.concatenate(
        [np.stack([p0, gamma, c, big_d, delta, t0, allowed, readj], axis=1),
         bounds, np.zeros((n, 3))], axis=1)

    lib = tasks.app_library()
    lib_rows = []
    for box in (dvfs.WIDE, dvfs.TPU_V5E_INTERVAL,
                dvfs.ScalingInterval(0.75, 1.2, 0.55, 0.65, 1.1)):
        t_lib = np.asarray(lib.default_time())
        for k in np.linspace(0.6, 2.0, 8):
            m = np.stack([*lib.astuple(), t_lib * k,
                          np.zeros(lib.n)], axis=1)
            lib_rows.append(np.concatenate(
                [m, np.broadcast_to(box.bounds(), (lib.n, 5)),
                 np.zeros((lib.n, 3))], axis=1))
    return np.ascontiguousarray(np.concatenate([fuzz, *lib_rows]), np.float32)


def event_ms(torch, fn, reps: int) -> float:
    """Median over ``reps`` single calls, each bracketed by CUDA events,
    after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def check_schedule(checks, res, n: int, name: str):
    """Eq. 7 conservation, one live record per task, finite energies."""
    run = sum(a.energy for a in res.assignments)
    books = run + res.e_idle + res.e_overhead
    checks.expect(abs(res.e_total - books) <= 1e-9 * abs(res.e_total),
                  f"{name}: Eq. 7 conservation {res.e_total} vs {books}")
    live = [a.task for a in res.assignments if not a.failed]
    checks.expect(len(live) == n and len(set(live)) == n,
                  f"{name}: {len(live)} live records, {len(set(live))} "
                  f"distinct tasks, {n} tasks")
    checks.expect(all(math.isfinite(a.energy) and a.energy >= 0.0
                      for a in res.assignments) and res.e_total > 0,
                  f"{name}: energies finite and positive")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Build the port's CUDA kernels and drive the scheduler "
                    "on one CUDA card; exits non-zero on any failed check.")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the fuzz rows (default 0)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import dvfs, online, scheduling, solver_cache, tasks
    from repro_torch.kernels import build, dvfs_opt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    checks = Checks()
    dev = torch.device("cuda")
    g0, g1 = dvfs_opt.DEFAULT_GRID

    # ---- phase 1: build.
    t = time.perf_counter()
    build.build(verbose=True)
    print(f"phase build: {time.perf_counter() - t:.2f} s for "
          f"{len(build.KERNELS)} kernel(s) {build.KERNELS}", flush=True)

    # ---- phase 2: the kernel against its plain version on the card.
    mat = fuzz_matrix(np, dvfs, tasks, args.seed, FUZZ_ROWS)
    x = torch.from_numpy(mat).to(dev)
    got = dvfs_opt.dvfs_solve_cuda(x)
    want = dvfs_opt.dvfs_solve_plain(x)
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    checks.expect(bool(np.isfinite(got).all()), "kernel: finite output")
    rel = np.abs(got[:, 5] - want[:, 5]) / np.abs(want[:, 5])
    max_rel, med_rel = float(rel.max()), float(np.median(rel))
    max_abs = float(np.abs(got - want).max())
    agree_dp = float(np.mean(got[:, 6] == want[:, 6]))
    agree_feas = float(np.mean(got[:, 7] == want[:, 7]))
    bit_equal = float(np.mean(np.all(got == want, axis=1)))
    fc_hi = np.sqrt(np.maximum(mat[:, 9] - 0.5, 0.0) / 2.0) + 0.5
    in_box = (np.all(got[:, 0] >= mat[:, 8] - 1e-4)
              and np.all(got[:, 0] <= mat[:, 9] + 1e-4)
              and np.all(got[:, 1] >= mat[:, 10] - 1e-4)
              and np.all(got[:, 1] <= fc_hi + 1e-4)
              and np.all(got[:, 2] >= mat[:, 11] - 1e-4)
              and np.all(got[:, 2] <= mat[:, 12] + 1e-4))
    checks.expect(max_rel <= 1e-5, f"kernel: energy max rel {max_rel} <= 1e-5")
    checks.expect(med_rel <= 1e-7, f"kernel: energy median rel {med_rel} <= 1e-7")
    checks.expect(agree_dp >= 0.999, f"kernel: deadline_prior agrees {agree_dp}")
    checks.expect(agree_feas >= 0.999, f"kernel: feasible agrees {agree_feas}")
    checks.expect(bool(in_box), "kernel: v, fc, fm inside each row's box (1e-4)")
    print(f"phase kernel: {mat.shape[0]} rows, energy max rel {max_rel:.3e}, "
          f"median {med_rel:.3e}, max abs err {max_abs:.3e}, rows bit-equal "
          f"{bit_equal:.6f}, deadline_prior agree {agree_dp:.6f}, feasible "
          f"agree {agree_feas:.6f}", flush=True)

    timing = {}
    for rows in (MAIN_ROWS, FUZZ_ROWS):
        xs = x[:rows].contiguous()
        k_ms = event_ms(torch, lambda: dvfs_opt.dvfs_solve_cuda(xs), 20)
        p_ms = event_ms(torch, lambda: dvfs_opt.dvfs_solve_plain(xs), 5)
        b_ms, b_by = bound_ms(rows, g0, g1)
        timing[rows] = (k_ms, p_ms, b_ms, b_by)
        print(f"phase kernel timing: {rows} rows: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
              f"{ops_per_row(g0, g1)} ops and {BYTES_ROW} bytes a row), "
              f"kernel at {b_ms / k_ms:.1%} of the bound", flush=True)
    del x, xs
    torch.cuda.empty_cache()

    # ---- phase 3: the online main path (the kernel) and its grid+golden twin.
    day = tasks.generate_trace(100_000, "uniform", seed=0)
    runs = {}
    for use_kernel in (True, False):
        solver_cache.GLOBAL_CACHE.clear()
        dvfs_opt.dvfs_solve_cuda.launches = 0
        t = time.perf_counter()
        res = online.schedule_online(day, l=4, theta=0.9, algorithm="edl",
                                     classes=CLASSES, use_kernel=use_kernel,
                                     pipeline=True, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        runs[use_kernel] = (res, wall, dvfs_opt.dvfs_solve_cuda.launches)
        check_schedule(checks, res, len(day), f"online use_kernel={use_kernel}")
    (rk, wk, launches_online), (rp, wp, launches_plain) = runs[True], runs[False]
    checks.expect(launches_online > 0,
                  f"online: kernel launched {launches_online} times")
    checks.expect(launches_plain == 0,
                  f"online grid+golden run launched the kernel {launches_plain} times")
    e_rel = abs(rk.e_total - rp.e_total) / rp.e_total
    checks.expect(e_rel <= 2e-3, f"online: e_total rel {e_rel} <= 2e-3")
    checks.expect(rk.violations == rp.violations,
                  f"online: violations {rk.violations} vs {rp.violations}")
    print(f"phase online: {len(day)} tasks, classes {CLASSES}, kernel "
          f"launches {launches_online}, e_total {rk.e_total:.6f} vs "
          f"grid+golden {rp.e_total:.6f} (rel {e_rel:.3e}), violations "
          f"{rk.violations}, pairs {rk.n_pairs}, {len(day) / wk:.1f} tasks/s "
          f"({wk:.3f} s) vs {len(day) / wp:.1f} tasks/s ({wp:.3f} s) "
          f"grid+golden", flush=True)

    # The kernel run once more under both profilers: the device's busy time
    # by kernel and its idle share of the wall (torch.profiler, device
    # activity only), and the host's time by layer (cProfile, which slows
    # Python-heavy layers more than numpy-heavy ones).
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    solver_cache.GLOBAL_CACHE.clear()
    host = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        host.enable()
        online.schedule_online(day, l=4, theta=0.9, algorithm="edl",
                               classes=CLASSES, use_kernel=True,
                               pipeline=True, device=dev)
        torch.cuda.synchronize()
        host.disable()
        wall = time.perf_counter() - t
    spans = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total,
                   reverse=True)
    busy_ms = sum(e.self_device_time_total for e in spans) / 1e3
    top = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in spans[:6])
    print(f"phase online profile: wall {wall:.3f} s under the profilers, "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / 1e3 / wall:.4f}; device top: {top}", flush=True)
    layers = {  # (module file, function) -> layer; cumulative host seconds
        ("online.py", "place_group"): "placement",
        ("online.py", "dispatch"): "solve dispatch (config + readjust)",
        ("online.py", "consume_sync"): "config sync + assembly",
        ("online.py", "flush_sync"): "readjust sync + write-back",
        ("online.py", "_floors_sync"): "t_min floors",
        ("bounds.py", "theoretical_bound"): "e_bound solve",
        ("engine.py", "finalize"): "engine finalize",
        ("solver_cache.py", "get_many"): "  of which cache probe",
        ("solver_cache.py", "_materialize"): "  of which device -> host copy",
    }
    spent = dict.fromkeys(layers.values(), 0.0)
    for (path, _, func), (_, _, _, cum, _) in pstats.Stats(host).stats.items():
        layer = layers.get((Path(path).name, func))
        if layer is not None:
            spent[layer] += cum
    print("phase online host layers (cProfile, cumulative s): "
          + "; ".join(f"{k} {v:.3f}" for k, v in spent.items()), flush=True)

    # ---- phase 4: the offline batch.
    batch = tasks.generate_offline_n(20_000, seed=0)
    runs = {}
    for use_kernel in (True, False):
        solver_cache.GLOBAL_CACHE.clear()
        dvfs_opt.dvfs_solve_cuda.launches = 0
        t = time.perf_counter()
        res = scheduling.schedule_offline(batch, l=4, theta=0.9,
                                          algorithm="edl", classes=CLASSES,
                                          use_kernel=use_kernel, device=dev)
        torch.cuda.synchronize()
        runs[use_kernel] = (res, time.perf_counter() - t,
                            dvfs_opt.dvfs_solve_cuda.launches)
        check_schedule(checks, res, len(batch), f"offline use_kernel={use_kernel}")
    (ok_, wk, launches_offline), (op_, wp, _) = runs[True], runs[False]
    checks.expect(launches_offline > 0,
                  f"offline: kernel launched {launches_offline} times")
    e_rel = abs(ok_.e_total - op_.e_total) / op_.e_total
    checks.expect(e_rel <= 2e-3, f"offline: e_total rel {e_rel} <= 2e-3")
    checks.expect(ok_.violations == op_.violations,
                  f"offline: violations {ok_.violations} vs {op_.violations}")
    print(f"phase offline: {len(batch)} tasks, kernel launches "
          f"{launches_offline}, e_total {ok_.e_total:.6f} vs grid+golden "
          f"{op_.e_total:.6f} (rel {e_rel:.3e}), violations {ok_.violations}, "
          f"{len(batch) / wk:.1f} tasks/s ({wk:.3f} s) vs "
          f"{len(batch) / wp:.1f} tasks/s ({wp:.3f} s) grid+golden", flush=True)

    if checks.failed:
        print(f"chip_smoke: {len(checks.failed)} check(s) failed",
              file=sys.stderr)
        return 1
    k_main, p_main, b_main, by_main = timing[MAIN_ROWS]
    k_1m, p_1m, b_1m, _ = timing[FUZZ_ROWS]
    print(json.dumps({"kernels": [{
        "name": "dvfs_opt", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dvfs_opt.cu",
        "replaces": "src/repro/kernels/dvfs_opt.py:116",
        "launches": launches_online, "launches_offline": launches_offline,
        "max_abs_err": max_abs, "max_rel": max_rel,
        "ms": k_main, "plain_ms": p_main, "bound_ms": b_main,
        "bound_by": by_main, "library_ms": None,
        "ms_300k": k_main, "ms_1m": k_1m, "plain_ms_1m": p_1m,
        "bound_ms_1m": b_1m}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

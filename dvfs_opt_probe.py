#!/usr/bin/env python3
"""Two readings of the ``dvfs_opt`` CUDA kernel on one NVIDIA card that
``chip_smoke.py`` does not take.

    python3 dvfs_opt_probe.py [--parent OTHER.cu]

1. lanes — text copies of ``csrc/dvfs_opt.cu`` with its constant
   ``kLanes`` (the lanes that share a row) set to 1, 2, 4 and 8, and with
   ``--parent`` another source of the same C interface (the kernel of an
   earlier commit, say), all built with ``dvfs_opt``'s own ``nvcc`` flags
   into ``build/kernels/probe/``.  Each is held bit-equal (NaN-aware) to the
   plain version on the edge rows and a slice of chip_smoke.py's fuzz rows
   (seed 0), then timed in turns at every launch size of the online day and
   the offline batch and at 300k and 1M rows: ``queued_ms``, the median of
   the rounds, and the sums over each run's launches.
2. ceiling — the least time that IEEE division and square root leave:
   the fast path of one ``div.rn.f32`` and of one ``sqrt.rn.f32``, read
   with ``cuobjdump -sass`` from probe kernels built with the same flags
   (the instructions on the path to ``EXIT`` that calls no slow path, less
   those of a kernel that adds instead, loads and stores left out), times
   the divisions and roots of a row, over the card's instruction issue (4
   warp instructions a cycle an SM) and its special-function rate (16 a
   cycle an SM) at its maximum SM clock.  The built library's ``dvfs_opt_kernel`` is searched for the
   same sequences' instructions.

Exits non-zero without a card, if a build fails, or if a copy disagrees
with the plain version.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LANES = (1, 2, 4, 8)
# Rows of each dvfs_opt launch on the main path at seed 0, as chip_smoke.py's
# phases "online launches" and "offline launches" print them.
ONLINE_LAUNCHES = (99328, 99328, 99328, 128, 2048, 5120, 128, 256, 128, 8)
OFFLINE_LAUNCHES = (60416, 256, 2048)
LARGE = (300_000, 1 << 20)
CHECK_ROWS = 1 << 16
ROUNDS = 3
REPS = 20
SPIN_CYCLES = 10_000_000   # some 5 ms: longer than the host takes to queue REPS calls
SMS_ISSUE, SFU_LANES = 4 * 32, 16   # thread instructions a cycle an SM

PROBE_SRC = """
extern "C" __global__ void probe_add(const float* a, float* o) {
  o[0] = a[0] + a[1];
}
extern "C" __global__ void probe_div(const float* a, float* o) {
  o[0] = a[0] / a[1] + a[1];
}
extern "C" __global__ void probe_sqrt(const float* a, float* o) {
  o[0] = sqrtf(a[0]) + a[1];
}
"""
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")


def ieee_per_row(g0: int, g1: int) -> tuple:
    """IEEE divisions and square roots of one row of the function: 8 and 1
    for each pair of evaluations (an unconstrained and a boundary point, at
    the g0 + g1 sweep points and the winners), then g1(v_max) (a root),
    t_min and the chosen t (2 divisions each).  The sweep fractions are the
    same for every row and not counted."""
    pairs = g0 + g1 + 1
    return 8 * pairs + 4, pairs + 1


def nvcc_build(build, jobs: dict) -> dict:
    """Compiles ``{name: source path}`` with dvfs_opt's flags, all at once,
    into ``build/kernels/probe/``; returns ``{name: library path}``."""
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in jobs.items():
        lib = out_dir / f"lib{name}.so"
        cmd = [build.nvcc(), *build.flags("dvfs_opt"), "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (_, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
    if failed:
        raise RuntimeError("probe build failed:\n" + "\n".join(failed))
    return {name: lib for name, (lib, _) in procs.items()}


def sass_functions(build, lib: Path) -> dict:
    """``{function name: [(address, predicate, opcode, operands)]}`` from
    ``cuobjdump -sass`` of a built library."""
    tool = Path(build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = SASS_LINE.search(line)
        if cur is None or not m:
            continue
        words = m.group(2).split()
        pred = words.pop(0) if words[0].startswith("@") else ""
        cur.append((int(m.group(1), 16), pred, words[0], " ".join(words[1:])))
    return funcs


def fast_path(instrs: list) -> list:
    """Opcodes on the shortest path from the entry to an ``EXIT`` that
    makes no ``CALL`` (the slow paths of division and square root are
    calls); a predicated branch is followed both ways and counts as issued
    either way."""
    at = {addr: k for k, (addr, *_) in enumerate(instrs)}
    best, stack = None, [(0, ())]
    while stack:
        k, path = stack.pop()
        if k >= len(instrs) or len(path) > 4 * len(instrs):
            continue
        _, pred, op, args = instrs[k]
        path = path + (op,)
        if op.startswith("CALL") or (best and len(path) >= len(best)):
            continue
        if op == "EXIT":
            best = path
            if not pred:
                continue
        elif op.startswith("BRA"):
            stack.append((at.get(int(args.split()[-1], 16), len(instrs)), path))
            if not pred:
                continue
        stack.append((k + 1, path))
    if best is None:
        raise RuntimeError("no path to EXIT without a call")
    return list(best)


def sequence(base: list, probe: list) -> collections.Counter:
    """The opcodes a probe's fast path issues beyond the base kernel's,
    leaving out loads and stores (where the compiler places the parameter
    loads differs from kernel to kernel)."""
    def alu(ops):
        return collections.Counter(op for op in ops
                                   if not op.startswith(("LD", "ST", "ULD", "S2")))
    return alu(probe) - alu(base)


def queued_ms(torch, fn, reps: int) -> float:
    """Device time of one call: ``reps`` calls between two CUDA events,
    queued behind a spin kernel so that the card runs them back to back
    without waiting for the host, over the count."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def describe(seq: collections.Counter) -> str:
    return ", ".join(f"{op} x{n}" if n > 1 else op for op, n in sorted(seq.items()))


def lane_sources(build) -> dict:
    """Text copies of csrc/dvfs_opt.cu at each lane count, under build/."""
    src = (build.CSRC / "dvfs_opt.cu").read_text()
    pattern = re.compile(r"constexpr int kLanes = \d+;")
    if len(pattern.findall(src)) != 1:
        raise RuntimeError("dvfs_opt.cu: no single 'constexpr int kLanes'")
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for lanes in LANES:
        path = out_dir / f"dvfs_opt_l{lanes}.cu"
        path.write_text(pattern.sub(f"constexpr int kLanes = {lanes};", src))
        jobs[f"lanes{lanes}"] = path
    return jobs


def launcher(torch, path: Path):
    """A function that launches the library's dvfs_opt_launch on a
    contiguous [n, 16] CUDA tensor at the default grid."""
    lib = ctypes.CDLL(str(path))
    lib.dvfs_opt_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.dvfs_opt_launch.restype = ctypes.c_int

    def run(x, g0=64, g1=64):
        out = torch.empty((x.shape[0], 8), dtype=torch.float32, device=x.device)
        step0 = float(ctypes.c_float(1.0 / (g0 - 1)).value)
        rc = lib.dvfs_opt_launch(x.data_ptr(), out.data_ptr(), x.shape[0],
                                 g0, g1, step0,
                                 torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{path.name}: launch failed ({rc})")
        return out
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another dvfs_opt.cu of the same C interface to time")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("dvfs_opt_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.core import dvfs, tasks
    from repro_torch.kernels import build, dvfs_opt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    name, limit, clock_mhz = (w.strip() for w in smi.split(","))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{name}, {limit} W; {sms} SMs, max SM clock {clock_mhz} MHz",
          flush=True)
    g0, g1 = dvfs_opt.DEFAULT_GRID

    # ---- the ceiling.
    probe_cu = build.BUILD_DIR / "probe" / "ieee_probe.cu"
    probe_cu.parent.mkdir(parents=True, exist_ok=True)
    probe_cu.write_text(PROBE_SRC)
    jobs = {"ieee_probe": probe_cu, **lane_sources(build)}
    if args.parent is not None:
        jobs["parent"] = args.parent.resolve()
    libs = nvcc_build(build, jobs)
    funcs = sass_functions(build, libs["ieee_probe"])
    base = fast_path(funcs["probe_add"])
    div = sequence(base, fast_path(funcs["probe_div"]))
    root = sequence(base, fast_path(funcs["probe_sqrt"]))
    if div["MUFU.RCP"] != 1 or root["MUFU.RSQ"] != 1:
        print(f"dvfs_opt_probe: unexpected sequences: division {describe(div)}; "
              f"root {describe(root)}", file=sys.stderr)
        return 1
    div_len, root_len = sum(div.values()), sum(root.values())
    print(f"div.rn.f32 fast path: {div_len} instructions ({describe(div)})",
          flush=True)
    print(f"sqrt.rn.f32 fast path: {root_len} instructions ({describe(root)})",
          flush=True)
    kern = next(v for k, v in sass_functions(
        build, build.build(("dvfs_opt",))["dvfs_opt"]).items()
        if "dvfs_opt_kernel" in k)
    ops = collections.Counter(op for _, _, op, _ in kern)
    print(f"built dvfs_opt_kernel: {len(kern)} SASS instructions; MUFU.RCP "
          f"{ops['MUFU.RCP']}, FCHK {ops['FCHK']}, MUFU.RSQ {ops['MUFU.RSQ']}, "
          f"MUFU.SQRT {ops['MUFU.SQRT']}, BSSY {ops['BSSY']}, BSYNC "
          f"{ops['BSYNC']}", flush=True)
    n_div, n_root = ieee_per_row(g0, g1)
    hz = float(clock_mhz) * 1e6
    med = statistics.median_low(ONLINE_LAUNCHES)
    ceiling = {}
    for rows in (med, *LARGE):
        issue = rows * (n_div * div_len + n_root * root_len) / (sms * SMS_ISSUE * hz)
        sfu = rows * (n_div + n_root) / (sms * SFU_LANES * hz)
        ceiling[rows] = (issue * 1e3, sfu * 1e3)
        print(f"IEEE ceiling at {rows} rows: {n_div} divisions and {n_root} "
              f"roots a row; issue {issue * 1e3:.6f} ms, special-function "
              f"unit {sfu * 1e3:.6f} ms", flush=True)

    # ---- the lanes.
    runs = {k: launcher(torch, v) for k, v in libs.items() if k != "ieee_probe"}
    dev = torch.device("cuda")
    mat = chip_smoke.fuzz_matrix(np, dvfs, tasks, 0, LARGE[-1])
    x = torch.from_numpy(mat).to(dev)
    xc = torch.cat([x[:CHECK_ROWS], torch.from_numpy(dvfs_opt.edge_rows()).to(dev)])
    want = dvfs_opt.dvfs_solve_plain(xc).cpu().numpy()
    bad = []
    for key, run in runs.items():
        got = run(xc).cpu().numpy()
        same = np.all((got == want) | (np.isnan(got) & np.isnan(want)), axis=1)
        print(f"{key}: {xc.shape[0]} rows bit-equal (NaN-aware) "
              f"{float(same.mean()):.6f}", flush=True)
        if key != "parent" and not same.all():
            bad.append(key)
    sizes = sorted(set(ONLINE_LAUNCHES) | set(OFFLINE_LAUNCHES) | set(LARGE))
    reads = {(key, rows): [] for key in runs for rows in sizes}
    order = list(runs)
    for r in range(ROUNDS):
        for rows in sizes:
            xs = x[:rows].contiguous()
            for key in (order if r % 2 == 0 else order[::-1]):
                reads[key, rows].append(
                    queued_ms(torch, lambda: runs[key](xs), REPS))
    table = {key: {rows: statistics.median(reads[key, rows]) for rows in sizes}
             for key in runs}
    for rows in sizes:
        print(f"{rows} rows: " + ", ".join(
            f"{key} {table[key][rows]:.5f}" for key in runs) + " ms", flush=True)
    sums = {key: {"online": sum(t[r] for r in ONLINE_LAUNCHES),
                  "offline": sum(t[r] for r in OFFLINE_LAUNCHES)}
            for key, t in table.items()}
    for key, s in sums.items():
        print(f"{key}: summed queued time, online day {s['online']:.4f} ms, "
              f"offline batch {s['offline']:.4f} ms, both "
              f"{s['online'] + s['offline']:.4f} ms", flush=True)
    print(json.dumps({
        "card": f"{name}, {limit} W", "sms": sms, "max_sm_clock_mhz": clock_mhz,
        "div_len": div_len, "sqrt_len": root_len,
        "ieee_per_row": [n_div, n_root],
        "ceiling_ms": {str(k): v for k, v in ceiling.items()},
        "queued_ms": {k: {str(r): v for r, v in t.items()} for k, t in table.items()},
        "sums_ms": sums}), flush=True)
    if bad:
        print(f"dvfs_opt_probe: {bad} disagree with the plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

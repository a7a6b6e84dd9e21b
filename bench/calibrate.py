"""Readings that the limits of ``correct`` are set from: for each seed, the
numbers a sound run of the program compares; on some seeds the control's
(the reference in float8, put in the program's place) and each planted
fault's (``bench/common/faults.py``).  One process reads them all, since a
cell's set-up dominates its readings.

    python bench/calibrate.py --workload danube-train-2k \\
        --seeds 11,12,13 --control-seeds 11,12,13 --fault-seeds 11,12,13

Training readings follow the run's own set-up (the first three steps of
one state); serving readings serve one round of the pool's batches, the
longest among them, and compare as many requests as a run does.  Each
reading is one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def train_side(cell, drivers, fault):
    from bench.common import faults
    from bench.common.cell import free
    train = drivers["train"]
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        state, step, paths, b1 = train.build(cell)
        state, readings = train.program_readings(cell, state, step, paths, b1)
    del state, step
    free(cell.device)
    return readings, paths


def train_seed(cell, drivers, control: bool, fault_names) -> list:
    from bench.common import compare
    from bench.common.cell import CHECK_STEPS
    from bench.reference import follow
    from bench.reference.common import FP32, Prec
    prog, paths = train_side(cell, drivers, None)
    ref = follow.train_readings(cell.family, cell.model, cell.mix, cell.seed,
                                cell.device, FP32, CHECK_STEPS)
    out = []

    def add(side, readings):
        values, worst = compare.train_numbers(readings, ref)
        out.append({"side": side, **values,
                    "loss_steps": ((readings["loss"] - ref["loss"]).abs()
                                   / ref["loss"].abs()).tolist(),
                    "worst": {k: "/".join(map(str, paths[i]))
                              for k, i in worst.items()}})

    add("program", prog)
    if control:
        add("control", follow.train_readings(
            cell.family, cell.model, cell.mix, cell.seed, cell.device,
            Prec("fp8"), CHECK_STEPS))
    for name in fault_names:
        add(f"fault:{name}", train_side(cell, drivers, name)[0])
    return out


def serve_side(cell, drivers, fault):
    from bench.common import faults, traffic
    from bench.common.cell import free
    serve = drivers["serve"]
    mix = cell.mix
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        srv = serve.build(cell)
        batches = traffic.serve_batches(mix, cell.model["vocab_size"],
                                        cell.seed)
        done = [serve.serve(srv, batches, int(mix["new_tokens"]))
                for _ in range(int(mix["pool"]))]
    del srv
    free(cell.device)
    failed = sum(1 for b in done for r in b["requests"]
                 if len(r.out) != r.max_new)
    return serve.rows_of(serve.sample(done, int(mix["check_requests"]),
                                      cell.seed)), failed


def serve_seed(cell, drivers, control: bool, fault_names) -> list:
    from bench.common import compare
    from bench.reference import follow
    from bench.reference.common import FP32, Prec
    out = []
    sides = [("program", None)] + [(f"fault:{f}", f) for f in fault_names]
    for side, fault in sides:
        (rows, positions, tokens), failed = serve_side(cell, drivers, fault)
        precs = [FP32] + ([Prec("fp8")] if control and not fault else [])
        logits = follow.serve_logits(cell.family, cell.model, cell.seed,
                                     cell.device, rows, positions, precs)
        gaps = compare.logit_gaps(logits[0], tokens)
        out.append({"side": side, "logit_gap": max(gaps, default=float("inf")),
                    "failed": failed, "rows": len(rows)})
        if len(precs) > 1:
            ctl = compare.first_choice_gaps(logits[0], logits[1])
            out.append({"side": "control", "logit_gap": max(ctl),
                        "rows": len(rows)})
    return out


def calibrate(root: Path, bench: dict, workload: str, seeds, control_seeds,
              fault_seeds, device, faults_of=None, emit=print) -> list:
    from bench.common import faults
    from bench.common.cell import load_cell, load_file
    lines = []
    drivers = {k: load_file(root / "bench" / "drivers" / f"{k}.py",
                            f"bench_driver_{k}") for k in ("train", "serve")}
    for seed in seeds:
        cell = load_cell(root, bench, workload, seed=seed, seconds=0,
                         trace=False, device=device)
        kind = cell.mix["kind"]
        names = (faults_of or faults.KINDS[kind]) if seed in fault_seeds else ()
        t0 = time.time()
        fn = train_seed if kind == "train" else serve_seed
        for rec in fn(cell, drivers, seed in control_seeds, names):
            line = {"workload": workload, "seed": seed, **rec,
                    "seconds": time.time() - t0}
            lines.append(line)
            emit(json.dumps(line))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("calibration reads the card: no CUDA card here", file=sys.stderr)
        return 2

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    calibrate(ROOT, bench, args.workload, ints(args.seeds),
              set(ints(args.control_seeds)), set(ints(args.fault_seeds)),
              torch.device("cuda", 0), emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())

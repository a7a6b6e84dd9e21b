"""The benchmark of ``repro_torch`` (the port) on NVIDIA cards: one process,
one cell, one run.

    python bench/run.py --workload danube-train-2k --seed 7 --seconds 30 \\
        --trace 0

It reads ``BENCHMARK.json`` at the checkout's root, the cell's configuration
(``bench/configs``), traffic mix (``bench/traffic``) and limits
(``bench/limits``), runs the mix's driver (``bench/drivers/<kind>.py``),
reads each metric of the cell with its own reader (``bench/metrics``) and
prints one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` and, with ``--trace 1``, ``breakdown``; the numbers compared
for ``correct`` come last, under ``checks``, and again as the last lines of
standard error.  With ``--trace 0`` the metrics are the cell's end-to-end
ones, with ``--trace 1`` its per-layer ones (read from a traced sub-window
after the measured one).

It runs only on a CUDA card: without one, or with fewer cards than the cell
asks for, it prints no result and exits 2.  It exits 3, printing no result,
if the process has loaded JAX or the JAX package (``repro``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: Top-level module names a run may not hold (compared whole: the port's
#: name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernels build under ``build/kernels`` there already)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")


def bytecode_cache(root: Path) -> None:
    """Python's compiled modules (torch's among them) under a fixed path
    inside the checkout.  Where the installation ships no ``.pyc`` files and
    the environment forbids writing them (``PYTHONDONTWRITEBYTECODE``), every
    run would compile torch's two thousand modules again: seconds of set-up
    on the host's CPU, which swing with how busy the host is."""
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(root / "build" / "pycache")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (the loaded modules')."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def metric_entries(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries this cell reports in this kind of run."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [e for e in entries
            if "workloads" not in e or workload in e["workloads"]]


def read_metrics(root: Path, entries: list, rec: dict) -> dict:
    from bench.common.cell import load_file
    out = {}
    for e in entries:
        reader = load_file(root / "bench" / "metrics" / f"{e['name']}.py",
                           f"bench_metric_{e['name'].replace('.', '_')}")
        value = reader.read(rec)
        if value is not None:
            out[e["name"]] = {"value": value, "unit": e["unit"]}
    return out


def run_cell(root: Path, bench: dict, workload: str, seed: int,
             seconds: float, trace: bool, device, meter=None,
             started: float = None, marks: dict = None) -> dict:
    """One run of ``workload``; returns the result line as a dict (without
    ``device``'s card fields).  ``marks``: seconds from the process's start
    to the points of the set-up before this call."""
    from bench.common.cell import load_cell, load_file, process_start
    kw = {"meter": meter} if meter is not None else {}
    cell = load_cell(root, bench, workload, seed=seed, seconds=seconds,
                     trace=trace, device=device,
                     started=started or process_start(), **kw)
    cell.marks.update(marks or {})
    cell.mark("torch_ready")
    driver = load_file(root / "bench" / "drivers" / f"{cell.mix['kind']}.py",
                       f"bench_driver_{cell.mix['kind']}")
    rec = driver.run(cell)
    rec["setup_s"] = rec["window_start"] - cell.started
    from bench.common.compare import passed
    ok = (passed(rec["checks"]) and rec["failed"] == 0
          and rec["attempted"] > 0)
    line = {"correct": bool(ok), "attempted": rec["attempted"],
            "failed": rec["failed"],
            "metrics": read_metrics(root, metric_entries(bench, workload,
                                                         trace), rec),
            "device": {"memory_peak_bytes": rec["memory_peak_bytes"]}}
    if trace and rec.get("trace"):
        t = rec["trace"]
        line["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["notes"] = dict(rec.get("notes", {}), setup_marks=cell.marks)
    if trace and rec.get("trace"):
        from bench.common.trace import split_s
        line["notes"]["device_split_s"] = split_s(rec["trace"]["kernels"])
    line["checks"] = rec["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    at = {"main": time.time()}

    cache_dirs(ROOT)
    bytecode_cache(ROOT)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2

    import torch
    at["torch_imported"] = time.time()
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from bench.common import nvml
    from bench.common.cell import process_start
    started = process_start()
    props = torch.cuda.get_device_properties(0)
    at["cuda_ready"] = time.time()
    card = nvml.Card(str(getattr(props, "uuid", "") or ""))
    try:
        meter = nvml.EnergyMeter(card)
        at["nvml_ready"] = time.time()
        line = run_cell(ROOT, bench, args.workload, args.seed, args.seconds,
                        bool(args.trace), torch.device("cuda", 0), meter,
                        started, {k: t - started for k, t in at.items()})
        power_limit = card.power_limit_w()
    finally:
        card.close()
    line["device"] = {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0),
                      "count": wl["chips"], "power_limit_w": power_limit,
                      **line["device"]}

    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures repro_torch "
              "alone", file=sys.stderr)
        return 3
    checks = line.pop("checks")
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

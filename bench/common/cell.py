"""What a driver is given for one run of one cell, and the small helpers the
drivers share."""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import time
from pathlib import Path
from typing import Optional

import torch

#: Steps of a training cell's set-up that the reference follows.
CHECK_STEPS = 3
#: Steps (training) or batches (serving) of the traced sub-window.
TRACE_STEPS = 3
TRACE_BATCHES = 2


class NullMeter:
    """Stands in for the card's energy meter where there is no card (the
    tests on the CPU): reads 0 J."""

    def start(self) -> None:
        pass

    def stop(self) -> float:
        return 0.0


@dataclasses.dataclass
class Cell:
    root: Path
    name: str
    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    meter: object = dataclasses.field(default_factory=NullMeter)
    #: Wall-clock epoch of the process's start (set-up counts from it).
    started: float = dataclasses.field(default_factory=time.time)
    #: Seconds from the start to each named point of the set-up.
    marks: dict = dataclasses.field(default_factory=dict)

    def mark(self, name: str) -> None:
        self.marks[name] = time.time() - self.started

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def family(self) -> str:
        return self.config["reference"]


def load_cell(root: Path, bench: dict, workload: str, **kw) -> Cell:
    """The cell ``workload`` of ``bench`` (BENCHMARK.json), its configuration,
    traffic mix and limits read from their files under ``root/bench``."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == wl["config"])
    from bench.common import traffic
    return Cell(root=root, name=workload,
                config=json.loads((root / cfg["file"]).read_text()),
                mix=traffic.load(root / "bench" / "traffic"
                                 / f"{wl['traffic']}.json"),
                limits=json.loads((root / "bench" / "limits"
                                   / f"{workload}.json").read_text()),
                **kw)


def load_file(path: Path, name: str):
    """Import the module at ``path`` (a driver or a metric's reader)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device: torch.device) -> Optional[int]:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return None


def process_start() -> float:
    """Wall-clock epoch at which this process started (Linux: its start in
    clock ticks since boot, against the uptime); now, where that cannot be
    read."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return time.time()

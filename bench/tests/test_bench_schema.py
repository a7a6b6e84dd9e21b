"""The result line's schema, and the runs that must print none."""

from __future__ import annotations

import json
import subprocess
import sys
import math

import pytest
import torch

from bench import run as bench_run
from bench.tests.bench_helpers import ROOT, TINY_CELLS

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_result_line(tiny_root, cell):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    line = bench_run.run_cell(tiny_root, bench, cell, 2**31 + 11, 0.3, False,
                              torch.device("cpu"))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    kind = "serve" if "serve" in cell else "train"
    # The tiny checkout reports every metric in every cell of its kind.
    want = {"setup_s", "card_j_per_token"} | (
        {"ttft_p95_s"} if kind == "serve"
        else {"train_tokens_per_s", "train_tokens_per_s.ssm"})
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(line, allow_nan=False)


def test_benchmark_json_follows_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{e['name']}.py").exists()
        assert set(e.get("workloads", cells)) <= set(cells)
    for e in BENCH["per_layer"]:
        moved = e2e[e["moves"]]
        assert set(e["workloads"]) <= set(moved.get("workloads", cells))
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "bench" / "limits" / f"{w['name']}.json").exists()
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25


def test_no_card_no_result():
    """Without a CUDA card the run prints nothing and exits 2."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"),
                        "--workload", "danube-train-2k", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""

"""A run with the timed path broken underneath reads ``correct`` false, once
for each fault a cell can have; a sound run reads it true."""

from __future__ import annotations

import json

import pytest
import torch

from bench import run as bench_run
from bench.common import faults
from bench.tests.bench_helpers import TINY_CELLS, TINY_MIXES

CASES = [(cell, fault) for cell, (_, mix) in sorted(TINY_CELLS.items())
         for fault in faults.KINDS[TINY_MIXES[mix]["kind"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(tiny_root, cell, fault):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    with faults.FAULTS[fault]():
        line = bench_run.run_cell(tiny_root, bench, cell, 2**31 + 3, 0.2,
                                  False, torch.device("cpu"))
    assert line["correct"] is False, line["checks"]


def test_the_faults_are_undone(tiny_root):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for fault in faults.FAULTS.values():
        with fault():
            pass
    line = bench_run.run_cell(tiny_root, bench, "dense-serve", 2**31 + 3, 0.2,
                              False, torch.device("cpu"))
    assert line["correct"] is True

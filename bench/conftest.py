"""pytest settings of the benchmark's tests: the checkout's root and ``src`` on
``sys.path``, the ``chip`` marker, and a tiny checkout for whole runs on the
CPU (``tests/bench_helpers.py``)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips inside the test without one")


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny runs are faster on one thread than on a shared host's many."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tiny_root(tmp_path):
    from bench.tests.bench_helpers import make_root
    return make_root(tmp_path)

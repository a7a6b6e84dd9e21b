"""Nothing of the benchmark loads JAX, the JAX package or its benchmarks."""

from __future__ import annotations

import ast

from bench import run as bench_run
from bench.tests.bench_helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "bench").rglob("*.py"))
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path} imports {name}"


def test_no_benchmark_file_reads_the_jax_benchmarks():
    marks = ("benchmarks" + "/", "BENCH" + "_")   # not this file's own text
    for path in (ROOT / "bench").rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json"):
            text = path.read_text()
            assert not any(m in text for m in marks), path


def test_the_run_checks_whole_top_level_names():
    names = ["repro_torch", "repro_torch.models.model", "torch", "jaxtyping"]
    assert bench_run.forbidden_modules(names) == []
    assert bench_run.forbidden_modules(names + ["repro.core.engine"]) == [
        "repro"]
    assert bench_run.forbidden_modules(names + ["jax", "flax.linen"]) == [
        "flax", "jax"]

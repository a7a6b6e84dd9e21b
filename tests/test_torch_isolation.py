"""The port stands alone: importing it loads neither JAX nor the JAX
package, and no file of it (nor ``chip_smoke.py``) imports them."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro\.|"
                       r"from repro import)", re.M)

PROBE = """
import json, sys
import repro_torch, repro_torch.core, repro_torch.kernels.ops, repro_torch.convert
import repro_torch.kernels.ref, repro_torch.kernels.build
mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
              or m == "repro" or m.startswith("repro."))
print(json.dumps(mods))
"""


def test_import_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _sources():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_reference(path):
    assert path.exists()
    assert not FORBIDDEN.search(path.read_text())


def test_port_mirrors_the_reference_tree():
    for rel in ("core/dvfs.py", "core/single_task.py", "core/solver_cache.py",
                "core/machines.py", "core/engine.py", "core/placement.py",
                "core/faults.py", "core/bounds.py", "core/scheduling.py",
                "core/online.py", "core/cluster.py", "core/tasks.py",
                "kernels/layout.py", "kernels/dvfs_opt.py", "kernels/ops.py",
                "kernels/ref.py"):
        assert (ROOT / "src" / "repro" / rel).exists()
        assert (PORT / rel).exists()

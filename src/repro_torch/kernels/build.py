"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers and the
stream as ``void*``), so it compiles in seconds without PyTorch's headers.
The shared library lands in ``build/kernels/`` at the root of the checkout
(``.gitignore`` lists ``build/``), under a name that carries a hash of the
source and the flags: an edited source never loads a stale library.  A
build happens at first use, inside the call that needs the kernel; this
module imports without ``nvcc`` or a card.

    python -m repro_torch.kernels.build        # build every kernel now
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("dvfs_opt",)
DEFAULT_CUDA_HOME = "/usr/local/cuda"

#: sm_90a keeps Hopper-only instructions available; -fmad=false keeps every
#: a*b+c rounded twice, as in the plain torch versions.  No --use_fast_math:
#: division and square root stay IEEE round-to-nearest.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or
    :data:`DEFAULT_CUDA_HOME`.  Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        f"nvcc not found (not on PATH, nor under CUDA_HOME or {DEFAULT_CUDA_HOME}):"
        " the CUDA kernels are built from csrc/ at first use and need the "
        "CUDA toolkit; on a machine without a card use device='cpu'")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to under :data:`NVCC_FLAGS`."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = KERNELS, verbose: bool = False) -> Dict[str, Path]:
    """Compile every source in ``names`` that is not built yet, one ``nvcc``
    process per source, all started together.  ``verbose`` adds
    ``-Xptxas -v`` and prints what the compiler says (registers, spills).
    Returns ``{name: library path}``; raises with ``nvcc``'s output if a
    build fails."""
    extra = ("-Xptxas", "-v") if verbose else ()
    todo = [name for name in names
            if verbose or not library_path(name).exists()]
    if not todo:
        return {name: library_path(name) for name in names}
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler, *NVCC_FLAGS, *extra, "-o", tmp,
               str(CSRC / f"{name}.cu")]
        jobs[name] = (library_path(name), Path(tmp), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (path, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        if verbose and log:
            print(log, end="", file=sys.stderr)
        os.replace(tmp, path)   # atomic: a reader sees all of it or nothing
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build((name,))[name]
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib


if __name__ == "__main__":
    for kernel, lib_path in build(verbose=True).items():
        print(kernel, lib_path)

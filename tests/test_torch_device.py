"""The port's device policy: ``device=None`` is the CUDA card and raises
without one, ``device="cpu"`` runs the plain versions, the CUDA wrapper
refuses a CPU tensor, and the kernel build module imports without
``nvcc`` and says so clearly when asked to build."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import (bounds, machines, online, scheduling,  # noqa: E402
                              single_task, tasks)
from repro_torch.kernels import build, dvfs_opt, ops, ref  # noqa: E402


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small():
    ts = tasks.generate_offline(0.02, seed=1)
    return ts, ts.deadline - ts.arrival


def _mat(n=8):
    ts, allowed = _small()
    cols = [np.asarray(f, np.float32)[:n] for f in ts.params.astuple()]
    m = np.stack(cols + [np.asarray(allowed, np.float32)[:n],
                         np.zeros(n, np.float32)], axis=1)
    return np.concatenate([m, np.broadcast_to(np.asarray(
        single_task.dvfs.WIDE.bounds(), np.float32), (n, 5)),
        np.zeros((n, 3), np.float32)], axis=1)


ENTRY_POINTS = {
    "schedule_online": lambda ts, a: online.schedule_online(ts),
    "schedule_offline": lambda ts, a: scheduling.schedule_offline(ts),
    "online_configs": lambda ts, a: online.online_configs(
        ts, machines.resolve_classes(None)),
    "configure_classes": lambda ts, a: machines.configure_classes(
        ts.params, a, machines.resolve_classes(None)),
    "configure_tasks": lambda ts, a: single_task.configure_tasks(ts.params, a),
    "readjust_batch": lambda ts, a: single_task.readjust_batch(ts.params, a),
    "solve_unconstrained": lambda ts, a: single_task.solve_unconstrained(
        ts.params),
    "solve_with_deadline": lambda ts, a: single_task.solve_with_deadline(
        ts.params, a),
    "solve_on_boundary": lambda ts, a: single_task.solve_on_boundary(
        ts.params, a),
    "dvfs_solve": lambda ts, a: ops.dvfs_solve(ts.params, a),
    "dvfs_solve_matrix": lambda ts, a: ops.dvfs_solve_matrix(_mat()),
    "theoretical_bound": lambda ts, a: bounds.theoretical_bound(ts),
    "dvfs_solve_ref": lambda ts, a: ref.dvfs_solve_ref(_mat()),
}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_default_device_raises_without_cuda(no_cuda, name):
    ts, allowed = _small()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](ts, allowed)


def test_explicit_cuda_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.resolve_device("cuda")
    assert ops.resolve_device("cpu") == torch.device("cpu")


def test_cpu_takes_the_plain_version(monkeypatch):
    calls = []
    plain = dvfs_opt.dvfs_solve_plain

    def spy(t, grid=dvfs_opt.DEFAULT_GRID):
        calls.append(t.device.type)
        return plain(t, grid)

    def no_build(name):
        raise AssertionError("the CPU path must not build a CUDA kernel")

    monkeypatch.setattr(dvfs_opt, "dvfs_solve_plain", spy)
    monkeypatch.setattr(build, "load", no_build)
    before = dvfs_opt.dvfs_solve_cuda.launches
    out = ops.dvfs_solve_matrix(_mat(), device="cpu")
    assert out.shape == (8, 8) and calls == ["cpu"]
    ts, allowed = _small()
    r = scheduling.schedule_offline(ts, l=2, use_kernel=True, device="cpu",
                                    bound=False, dedup=False)
    assert r.e_total > 0 and len(calls) >= 2
    assert dvfs_opt.dvfs_solve_cuda.launches == before


@pytest.mark.parametrize("bad", ["cpu-tensor", "numpy"])
def test_cuda_wrapper_refuses_host_data(bad):
    x = torch.zeros((4, 16)) if bad == "cpu-tensor" else np.zeros((4, 16),
                                                                  np.float32)
    before = dvfs_opt.dvfs_solve_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        dvfs_opt.dvfs_solve_cuda(x)
    assert dvfs_opt.dvfs_solve_cuda.launches == before


def test_kernel_tags_name_the_device():
    assert ops.kernel_tag(torch.device("cpu")) == "k64x64@cpu"
    assert ops.kernel_tag(torch.device("cuda")) == "k64x64@cuda"
    assert ops.kernel_tag(torch.device("cuda"), (8, 4)) == "k8x4@cuda"


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("dvfs_opt")
    assert not (tmp_path / "kernels").exists()


def test_build_paths_follow_the_source():
    assert build.KERNELS == ("dvfs_opt",)
    path = build.library_path("dvfs_opt")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libdvfs_opt-") and path.suffix == ".so"
    assert (build.CSRC / "dvfs_opt.cu").is_file()
    assert "-fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS

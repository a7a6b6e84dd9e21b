"""The port's device policy: ``device=None`` is the CUDA card and raises
without one, ``device="cpu"`` runs the plain versions, the CUDA wrapper
refuses a CPU tensor, and the kernel build module imports without
``nvcc`` and says so clearly when asked to build."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import (bounds, machines, online, scheduling,  # noqa: E402
                              single_task, tasks)
from repro_torch.kernels import (build, dvfs_opt, flash_attention,  # noqa: E402
                                 ops, ref, ssd_scan)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402


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
    "flash_attention": lambda ts, a: ops.flash_attention(
        *(np.zeros((1, 2, 8, 16), np.float32) for _ in range(3))),
    "ssd_scan": lambda ts, a: ops.ssd_scan(
        np.zeros((1, 8, 2, 4), np.float32), np.ones((1, 8, 2), np.float32),
        -np.ones(2, np.float32), *(np.zeros((1, 8, 3), np.float32),) * 2),
    "Model": lambda ts, a: Model(serve.preset_config("mamba2-370m", "smoke")),
    "Server": lambda ts, a: serve.Server(
        Model(serve.preset_config("mamba2-370m", "smoke"), device="cpu"),
        {}, 1, 16),
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


def _attention_operands():
    return [torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
            for _ in range(3)]


def _ssd_operands():
    return (torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16),
            torch.ones((1, 8, 2)), -torch.ones(2),
            torch.zeros((1, 8, 128), dtype=torch.bfloat16),
            torch.zeros((1, 8, 128), dtype=torch.bfloat16))


@pytest.mark.parametrize("which", ["flash_attention", "ssd_scan"])
def test_new_cuda_wrappers_refuse_host_tensors(which):
    if which == "flash_attention":
        fn = flash_attention.flash_attention_cuda
        call = lambda: fn(*_attention_operands(), causal=True)  # noqa: E731
    else:
        fn = ssd_scan.ssd_scan_cuda
        call = lambda: fn(*_ssd_operands())  # noqa: E731
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert fn.launches == before


def test_dispatchers_refuse_other_devices():
    """A meta tensor takes the kernels' custom ops, whose fake
    implementations give the shapes (the dry-run's trace); any device but
    the CPU, the card and meta raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    q = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16, device="meta")
    assert flash_attention.flash_attention_kernel(
        q, q, q, causal=True).shape == q.shape
    x = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16, device="meta")
    b = torch.zeros((1, 8, 8), dtype=torch.bfloat16, device="meta")
    dt = torch.zeros((1, 8, 2), device="meta")
    y, final = ssd_scan.ssd_scan_kernel(x, dt, dt[0, 0], b, b, 8)
    assert y.shape == x.shape and final.shape == (1, 2, 16, 8)
    with FakeTensorMode():
        q = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16, device="mps")
        with pytest.raises(ValueError, match="no flash_attention"):
            flash_attention.flash_attention_kernel(q, q, q, causal=True)
        x = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16, device="mps")
        b = torch.zeros((1, 8, 8), dtype=torch.bfloat16, device="mps")
        dt = torch.zeros((1, 8, 2), device="mps")
        with pytest.raises(ValueError, match="no ssd_scan"):
            ssd_scan.ssd_scan_kernel(x, dt, torch.zeros(2, device="mps"), b,
                                     b, 8)


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
    for name in build.KERNELS:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.load(name)
    assert not (tmp_path / "kernels").exists()


def test_build_paths_follow_the_headers(monkeypatch, tmp_path):
    """An edited header (``csrc/*.cuh``) changes every library's path, so a
    source that includes it never loads a library built before the edit."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path("k")
    assert build.library_path("k") == before
    (csrc / "common.cuh").write_text("// two\n")
    edited = build.library_path("k")
    assert edited != before
    (csrc / "other.cuh").write_text("// a new header\n")
    assert build.library_path("k") not in (before, edited)
    (csrc / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert build.library_path("k") not in (before, edited)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea79flash_fwdILi256ELb0ELb1EEEv14CUtensorMap_stS1_S1_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea79flash_fwdILi256ELb0ELb1EEEv14CUtensorMap_stS1_S1_NS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 205 registers, used 1 barriers
ptxas info    : Compile time = 452.325 ms
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_5534123114flash_bwd_dkdvILi80ELb1EEEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_5534123114flash_bwd_dkdvILi80ELb1EEEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE
    72 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_5534123115flash_bwd_deltaENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_5534123115flash_bwd_deltaENS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
"""


def test_ptxas_table_reads_each_kernel():
    """``chip_smoke.ptxas_table`` (phase "build") names each kernel with its
    template arguments and reads its registers, stack and spills."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.ptxas_table(PTXAS_LOG) == [
        {"kernel": "flash_fwd", "args": "256, no prefix, lse",
         "registers": 205, "stack": 0, "spill_stores": 0, "spill_loads": 0},
        {"kernel": "flash_bwd_dkdv", "args": "80, prefix", "registers": 168,
         "stack": 72, "spill_stores": 8, "spill_loads": 4},
        {"kernel": "flash_bwd_delta", "args": "", "registers": 40,
         "stack": 0, "spill_stores": 0, "spill_loads": 0}]


def test_build_paths_follow_the_source():
    assert build.KERNELS == ("dvfs_opt", "flash_attention",
                             "flash_attention_bwd", "ssd_scan",
                             "ssd_scan_bwd", "adamw", "causal_conv")
    for name in build.KERNELS:
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert (build.CSRC / f"{name}.cu").is_file()
    for name in build.KERNELS:
        flags = build.flags(name)
        assert "arch=compute_90a,code=sm_90a" in flags
        assert "--use_fast_math" not in flags
        # Only the two kernels held bit-equal to their plain versions, the
        # scheduler's and AdamW's, give up FMA contraction.
        assert ("-fmad=false" in flags) == (name in ("dvfs_opt", "adamw"))

"""``kernels/ops.py::dvfs_solve_matrix``'s split across devices, against one
launch and against the JAX package's ``dvfs_solve_matrix(shard=False)``.

The split runs over ``ops.solve_devices``' list, which the tests patch to
list ``"cpu"`` several times: the entries stand in for cards here and run
the padding with ``dvfs_opt.PAD_ROW``, the chunking into whole ``BT``
blocks and the gather for real.  Bars: the split is bit-equal to one launch (rows are
independent); against the reference's Pallas kernel, the kernel tests'
bars (``tests/test_torch_dvfs_kernel.py``): energy rel <= 1e-6 and the two
flags equal on >= 99.9% of rows.  Twin of
``tests/test_solver_cache.py::test_sharded_dispatch_matches_single_device``
(5,000 offline rows, seed 5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import dvfs as rdvfs  # noqa: E402
from repro.core import tasks as rtasks  # noqa: E402
from repro.core.solver_cache import build_keys as rbuild_keys  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.core import dvfs, solver_cache, tasks  # noqa: E402
from repro_torch.kernels import dvfs_opt, ops  # noqa: E402


def _keys(n, seed):
    ts = tasks.generate_offline_n(n, seed=seed, library=tasks.app_library())
    return solver_cache.build_keys(
        ts.params.astuple(), np.asarray(ts.deadline - ts.arrival), False,
        np.asarray(dvfs.WIDE.bounds(), np.float32))


@pytest.fixture
def launches(monkeypatch):
    """The row count of every kernel launch ``dvfs_solve_matrix`` makes."""
    rows = []
    inner = ops.dvfs_solve_kernel

    def recording(tasks, **kw):
        rows.append((int(tasks.shape[0]), str(tasks.device)))
        return inner(tasks, **kw)

    monkeypatch.setattr(ops, "dvfs_solve_kernel", recording)
    return rows


def _list_devices(monkeypatch, n):
    """Make the split see the device ``n`` times, as ``n`` cards."""
    monkeypatch.setattr(ops, "solve_devices", lambda device: [device] * n)


def test_split_over_two_devices_is_bit_equal_to_one(launches, monkeypatch):
    keys = _keys(5000, 5)
    _list_devices(monkeypatch, 2)
    a = ops.dvfs_solve_matrix(keys, device="cpu")
    assert launches == [(2560, "cpu"), (2560, "cpu")]  # 5,120 with 120 pads
    b = ops.dvfs_solve_matrix(keys, device="cpu", shard=False)
    assert launches[2:] == [(5000, "cpu")]
    assert a.shape == (5000, 8) and a.dtype == np.float32
    assert np.array_equal(a, b)


def test_split_matches_the_reference_unsharded(monkeypatch):
    ts = rtasks.generate_offline_n(5000, seed=5, library=rtasks.app_library())
    rkeys = rbuild_keys(ts.params.astuple(),
                        np.asarray(ts.deadline - ts.arrival), False,
                        np.asarray(rdvfs.WIDE.bounds(), np.float32))
    keys = _keys(5000, 5)
    assert np.array_equal(keys, rkeys)
    _list_devices(monkeypatch, 2)
    got = ops.dvfs_solve_matrix(keys, device="cpu")
    want = rops.dvfs_solve_matrix(rkeys, shard=False)
    rel = np.abs(got[:, 5] - want[:, 5]) / np.abs(want[:, 5])
    assert float(rel.max()) <= 1e-6
    for k in (6, 7):
        assert float(np.mean(got[:, k] == want[:, k])) >= 0.999


def test_unblocked_split_is_a_gather_for_materialize(launches, monkeypatch):
    keys = _keys(4500, 6)
    _list_devices(monkeypatch, 2)
    pending = ops.dvfs_solve_matrix(keys, device="cpu", block=False)
    assert callable(pending) and len(launches) == 2
    got = solver_cache._materialize(pending)
    one = ops.dvfs_solve_matrix(keys, device="cpu", shard=False, block=False)
    assert isinstance(one, torch.Tensor)
    assert np.array_equal(got, solver_cache._materialize(one))


@pytest.mark.parametrize("m,n_devices,want", [
    (ops.SHARD_MIN_ROWS - 1, 2, (1, ops.SHARD_MIN_ROWS - 1)),  # too few rows
    (ops.SHARD_MIN_ROWS, 2, (2, 2048)),
    (5000, 3, (2, 2560)),             # not a power of two: 2 of the 3
    (5000, 8, (8, 640)),
    (ops.SHARD_MIN_ROWS, 64, (32, 128)),   # 64 would get 64 rows < BT each
    (5000, 64, (32, 256)),
    (10**6, 1, (1, 10**6)),
])
def test_split_plan(m, n_devices, want):
    assert ops.split_plan(m, n_devices) == want
    nd, chunk = want
    # Whole blocks a device, enough for every row; as in the reference, the
    # last devices may get pad rows only (5,000 over 32: 20 of 256 rows).
    assert nd == 1 or (chunk % dvfs_opt.BT == 0 and nd * chunk >= m)


@pytest.mark.parametrize("m,n_devices,n_launches", [
    (ops.SHARD_MIN_ROWS - 1, 2, 1),
    (5000, 3, 2),
    (ops.SHARD_MIN_ROWS, 64, 32),
    (5000, None, 1),                  # the CPU's own list is [device]
])
def test_fallbacks_launch_and_stay_bit_equal(m, n_devices, n_launches,
                                             launches, monkeypatch):
    keys = _keys(m, 7)
    if n_devices is not None:
        _list_devices(monkeypatch, n_devices)
    got = ops.dvfs_solve_matrix(keys, device="cpu")
    assert len(launches) == n_launches
    assert np.array_equal(got, ops.dvfs_solve_matrix(keys, device="cpu",
                                                     shard=False))


def test_default_devices_are_every_card_or_the_device():
    assert ops.solve_devices(torch.device("cpu")) == [torch.device("cpu")]
    if not torch.cuda.is_available():
        assert ops.solve_devices(torch.device("cuda")) == []


def test_dvfs_solve_splits_across_the_visible_devices(launches, monkeypatch):
    """With two devices visible, ``dvfs_solve`` splits its matrix (as the
    reference does with two local devices); the bits are one device's."""
    ts = tasks.generate_offline_n(5000, seed=8, library=tasks.app_library())
    allowed = np.asarray(ts.deadline - ts.arrival)
    b = ops.dvfs_solve(ts.params, allowed, dedup=False, device="cpu")
    _list_devices(monkeypatch, 2)
    a = ops.dvfs_solve(ts.params, allowed, dedup=False, device="cpu")
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert [n for n, _ in launches] == [5000, 2560, 2560]


def test_kernel_wrappers_refuse_a_dtensor(tmp_path):
    """A DTensor reaching ``dvfs_solve_kernel`` raises; it is not solved by
    the plain version's torch ops."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                                rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device="cpu")
        x = distribute_tensor(torch.zeros(4, 16), mesh,
                              [Replicate(), Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            dvfs_opt.dvfs_solve_kernel(x)
        q = distribute_tensor(torch.zeros(1, 4, 2, 16), mesh,
                              [Replicate(), Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            fa.flash_attention_kernel(q, q, q, causal=True)
        with pytest.raises(TypeError, match="DTensor"):
            ss.ssd_scan_kernel(q, q[..., 0], q[0, 0, :, 0], q[:, :, 0],
                               q[:, :, 0], 4)
    finally:
        if started:
            dist.destroy_process_group()

"""Public wrappers around the port's kernels, and its one device policy.

Every entry point of the port that solves or runs a model takes
``device=None`` and passes it through :func:`resolve_device`: ``None``
means the CUDA card, and without one it raises rather than running quietly
on the host.  The tests pass ``device="cpu"``, which sends every call
through the plain torch versions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import solver_cache
from repro_torch.core.dvfs import WIDE, DvfsParams, ScalingInterval
from repro_torch.kernels import layout
from repro_torch.kernels.dvfs_opt import (BT, DEFAULT_GRID, PAD_ROW,
                                          dvfs_solve_kernel)
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.layout import DvfsSolution
from repro_torch.kernels.ssd_scan import ssd_scan_kernel

#: Below this row count a multi-device split costs more in transfer and
#: launches than it saves in compute.
SHARD_MIN_ROWS = 4096


def faking() -> bool:
    """True while a ``FakeTensorMode`` is active: tensors made then are
    fake, so nothing is allocated and no kernel is launched."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def resolve_device(device=None) -> torch.device:
    """THE ``device=`` policy of every solving entry point: ``None`` is the
    CUDA card; a CUDA device without CUDA, or ``None`` without it, raises,
    except while a ``FakeTensorMode`` is active (a trace: the dry-run
    allocates and launches nothing).  Pass ``device="cpu"`` to run the
    plain versions on the host."""
    if device is None:
        if not torch.cuda.is_available() and not faking():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' to run the plain torch versions on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available() and not faking():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not "
                           "available")
    return dev


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, device=None) -> torch.Tensor:
    """Flash attention in the JAX layout: q ``[B, H, S, dh]``, k/v
    ``[B, KV, Sk, dh]`` (tensors or arrays) -> ``[B, H, S, dh]`` on
    ``device``.  The kernel reads the layout through strides (transposed
    views, no copy) where dh is one it is compiled for (64, 80, 128, 256);
    another dh up to 256 is zero-padded to the next of them, and every dh
    is scaled by the real ``dh ** -0.5``, where the reference's wrapper
    pads dh to 128 for the MXU and rescales q."""
    device = resolve_device(device)
    q, k, v = (torch.as_tensor(t).to(device) for t in (q, k, v))
    out = flash_attention_kernel(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window)
    return out.transpose(1, 2)


def ssd_scan(x, dt, a, b, c, chunk: int = 128, device=None) -> torch.Tensor:
    """The SSD chunked scan without the D-skip term: x ``[B, S, H, P]``,
    dt ``[B, S, H]``, a ``[H]``, b/c ``[B, S, N]`` (tensors or arrays) ->
    y ``[B, S, H, P]`` in x's dtype on ``device``.  ``chunk`` is the plain
    version's; the CUDA kernel takes its own (the same function)."""
    device = resolve_device(device)
    x, dt, a, b, c = (torch.as_tensor(t).to(device) for t in (x, dt, a, b, c))
    y, _ = ssd_scan_kernel(x, dt, a, b, c, chunk)
    return y


def kernel_tag(device: torch.device, grid: tuple = DEFAULT_GRID) -> str:
    """Solve-cache tag of the kernel path: the sweep grid and the device
    type, so the CUDA kernel and its plain version on the CPU never serve
    each other's rows."""
    return f"k{int(grid[0])}x{int(grid[1])}@{device.type}"


def solve_devices(device: torch.device) -> list:
    """The devices a split may use: every visible card when ``device`` is
    CUDA, else ``[device]``."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def split_plan(m: int, n_devices: int) -> tuple:
    """(devices used, rows a device) of a split of ``m`` rows, as the
    reference computes it: the largest power-of-two count of devices,
    halved while a device would get less than one kernel block ``BT``,
    and whole blocks a device; (1, m) under ``SHARD_MIN_ROWS``."""
    nd = 1
    if n_devices > 1 and m >= SHARD_MIN_ROWS:
        nd = 1 << (n_devices.bit_length() - 1)   # pow-2 device count
        while nd > 1 and -(-m // nd) < BT:
            nd //= 2
    if nd == 1:
        return 1, m
    per_dev = -(-m // nd)
    return nd, -(-per_dev // BT) * BT    # whole kernel blocks a device


def dvfs_solve_matrix(mat: np.ndarray, *, grid: tuple = DEFAULT_GRID,
                      device=None, shard: bool = True,
                      block: bool = True):
    """Solve a ``[m, 16]`` (or ``[m, 13]`` key-layout) task matrix with the
    kernel, split across devices when it pays off.  Returns the ``[m, 8]``
    solution matrix as numpy.

    With ``shard`` and at least ``SHARD_MIN_ROWS`` rows, the matrix is
    padded with ``dvfs_opt.PAD_ROW`` to whole kernel blocks, split into
    equal chunks over a power-of-two count of :func:`solve_devices`
    (every visible card when ``device`` is CUDA), launched on each device
    with no host wait in between and concatenated at the gather.  Rows are independent, so the result is bit-equal to one
    launch.  Otherwise the whole matrix goes to ``device``.

    ``block=False`` is the pipelined scheduler's entry point: the kernel is
    launched but the host does NOT wait for it — the return value is the
    solution tensor on the device, still being computed (one launch), or a
    zero-argument callable that gathers the parts (a split), either of
    which ``solver_cache._materialize`` resolves at the pipeline's sync
    point.
    """
    device = resolve_device(device)
    mat = np.asarray(mat, np.float32)
    if mat.shape[1] == layout.KEY_COLS:  # widen key layout -> NCOL
        mat = np.concatenate(
            [mat, np.zeros((mat.shape[0], layout.NCOL - layout.KEY_COLS),
                           np.float32)], axis=1)
    m = mat.shape[0]
    devs = solve_devices(device) if shard else [device]
    nd, chunk = split_plan(m, len(devs))
    if nd == 1:
        tasks = torch.from_numpy(np.ascontiguousarray(mat)).to(device)
        out = dvfs_solve_kernel(tasks, grid=grid)
        return solver_cache.to_numpy(out) if block else out
    if nd * chunk != m:
        pad = np.broadcast_to(PAD_ROW, (nd * chunk - m, layout.NCOL))
        mat = np.concatenate([mat, pad], axis=0)
    parts = [dvfs_solve_kernel(
                 torch.from_numpy(mat[i * chunk:(i + 1) * chunk]).to(devs[i]),
                 grid=grid)
             for i in range(nd)]   # launches are async; the gather waits

    def gather() -> np.ndarray:
        return np.concatenate([solver_cache.to_numpy(p) for p in parts],
                              axis=0)[:m]

    return gather() if block else gather


def dvfs_solve(params: DvfsParams, allowed: np.ndarray,
               interval: ScalingInterval = WIDE,
               readjust: bool = False,
               interval_rows: Optional[np.ndarray] = None,
               dedup: bool = True,
               grid: tuple = DEFAULT_GRID,
               cache: Optional["solver_cache.SolveCache"] = None,
               device=None) -> DvfsSolution:
    """Batched single-task DVFS optimum via the kernel.

    Drop-in for ``single_task.solve_with_deadline`` (same DvfsSolution
    contract, numpy fields; used by ``configure_tasks(use_kernel=True)``).
    With ``readjust=True`` every row is flagged as a theta-readjustment
    (column 7 of the task matrix): the kernel then takes the
    deadline-boundary sweep unconditionally — the drop-in for
    ``single_task.solve_on_boundary`` used by
    ``readjust_batch(use_kernel=True)``.

    ``interval_rows`` (``[n, 5]``: v_min, v_max, fc_min, fm_min, fm_max)
    gives every row its own scaling box — the heterogeneous-class path
    (``machines.configure_classes``) stacks one class block per interval
    and solves them all in this one launch.  When omitted, the static
    ``interval`` applies to every row.

    ``dedup=True`` routes the matrix through the unique-row dedup +
    process-wide LRU solve cache (:mod:`repro_torch.core.solver_cache`) —
    bit identical output, only previously-unseen rows touch the kernel.
    ``grid`` sets the kernel's hierarchical (coarse, fine) sweep sizes;
    ``cache=None`` means the global cache when deduping.  The matrix is
    split across the cards as :func:`dvfs_solve_matrix` splits it (a split
    is bit-equal to one launch, so both share the cache's rows).
    """
    device = resolve_device(device)
    cols = [np.asarray(f, np.float32) for f in params.astuple()]
    n = cols[0].shape[0]
    if interval_rows is not None:
        bounds = np.asarray(interval_rows, np.float32)
        if bounds.shape != (n, layout.N_BOUNDS):
            raise ValueError(f"interval_rows must be [n, {layout.N_BOUNDS}], "
                             f"got {bounds.shape}")
    else:
        bounds = np.asarray(interval.bounds(), np.float32)
    keys = solver_cache.build_keys(cols, allowed, readjust, bounds)

    def solve(km: np.ndarray) -> torch.Tensor:
        return dvfs_solve_matrix(km, grid=grid, device=device, block=False)

    if dedup:
        out = solver_cache.solve_rows(
            keys, solve, tag=kernel_tag(device, grid),
            cache=solver_cache.GLOBAL_CACHE if cache is None else cache)
    else:
        out = solver_cache._materialize(solve(keys))
    return solver_cache.rows_to_solution(out)

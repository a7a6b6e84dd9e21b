"""The paper's scheduler, ported to PyTorch: the DVFS power/performance
models, the single-task optimum, and the EDL theta-readjustment schedulers
(offline + online) over a heterogeneous cluster of machine classes.

Architecture (top to bottom)::

    policies            scheduling.schedule_offline / online.schedule_online
                        (Algorithms 1-6, result assembly incl. the
                        bounds.theoretical_bound e_bound column)
        |
    placement           placement.PlacementContext - the pair-selection
                        subsystem (numpy, host)
        |
    machine classes     machines.MachineClass / REGISTRY; configure_classes
                        runs Algorithm 1 on every class
        |
    ClusterEngine       engine.ClusterEngine - the vectorized pair/server
                        state machine (numpy, host)
        |
    DVFS solvers        single_task.configure_tasks / readjust_batch
                        (Algorithm 1; batched torch grid+golden on the device)
        |
    solve dedup/cache   solver_cache.solve_rows - unique-row dedup + the
                        process-wide LRU solve cache; device results are
                        copied to the host only at AsyncSolve.result()
        |
    CUDA kernel         kernels/dvfs_opt.dvfs_solve_kernel - the use_kernel
                        path: one [n, 16] task matrix per launch (per-row
                        interval bounds -> all classes in one launch)

Every solving entry point takes ``device=None`` (the CUDA card; it raises
without one) or ``device="cpu"`` (the plain torch versions on the host).
"""

from repro_torch.core import (bounds, cluster, dvfs, engine, machines, online,
                              placement, scheduling, single_task, solver_cache,
                              tasks)
from repro_torch.core.bounds import theoretical_bound
from repro_torch.core.dvfs import NARROW, WIDE, DvfsParams, ScalingInterval
from repro_torch.core.engine import ClusterEngine
from repro_torch.core.machines import REGISTRY, MachineClass
from repro_torch.core.online import schedule_online
from repro_torch.core.scheduling import schedule_offline
from repro_torch.core.single_task import (configure_tasks, solve_unconstrained,
                                          solve_with_deadline)
from repro_torch.core.tasks import TaskSet, app_library, generate_offline, generate_online

__all__ = [
    "DvfsParams", "ScalingInterval", "NARROW", "WIDE", "TaskSet",
    "ClusterEngine", "MachineClass", "REGISTRY",
    "app_library", "generate_offline", "generate_online",
    "configure_tasks", "solve_unconstrained", "solve_with_deadline",
    "schedule_offline", "schedule_online", "theoretical_bound",
    "bounds", "cluster", "dvfs", "engine", "machines", "online",
    "placement", "scheduling", "single_task", "solver_cache", "tasks",
]

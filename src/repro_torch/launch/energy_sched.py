"""A day of LM training/serving jobs scheduled on an accelerator fleet with
DVFS and deadlines: the port's twin of the JAX package's
``examples/energy_sched_cluster.py``.

    PYTHONPATH=src python -m repro_torch.launch.energy_sched \\
        [--classes gtx-1080ti,tpu-v5e,v100-sxm2] [--jobs 400] [--device cpu]

Each job is N steps of an (architecture x shape) cell whose DVFS model
parameters come from its roofline terms (``core/jobs.py``): delta is the
compute share of the step, and the collective share joins the
frequency-insensitive t0.  The table here is the example's synthetic
fallback (no dry-run is read).  The day runs through the online EDL
theta-readjustment scheduler with DVFS, beside a no-DVFS baseline at
theta 1, on a homogeneous fleet or on a machine-class mix from
``core/machines.py``, with Algorithm 1 solved by the torch grid+golden
solvers (``schedule_day(use_kernel=True)`` takes the ``dvfs_opt`` kernel
instead).  Without ``--device`` it runs on the CUDA card and raises
without one.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core import online
from repro_torch.core.jobs import (RooflineTerms, jobs_to_task_set,
                                   synth_job_stream)
from repro_torch.kernels.ops import resolve_device

#: Per-step roofline terms (compute, memory, collective seconds) of a few
#: (arch x shape) cells: the example's representative fallback table.
FALLBACK: Dict[str, RooflineTerms] = {
    "qwen2-72b/train_4k": RooflineTerms("qwen2-72b", "train_4k",
                                        3.2, 1.1, 0.6),
    "qwen2-72b/decode_32k": RooflineTerms("qwen2-72b", "decode_32k",
                                          0.02, 0.35, 0.04),
    "mamba2-370m/train_4k": RooflineTerms("mamba2-370m", "train_4k",
                                          0.5, 0.4, 0.05),
    "qwen3-moe-30b-a3b/train_4k": RooflineTerms("qwen3-moe-30b-a3b",
                                                "train_4k", 0.9, 0.7, 0.5),
    "recurrentgemma-2b/long_500k": RooflineTerms("recurrentgemma-2b",
                                                 "long_500k", 0.01, 0.2,
                                                 0.01),
}


def day_jobs(n_jobs: int = 400, horizon: int = 720, seed: int = 0):
    """The day's jobs, drawn from :data:`FALLBACK`, and their task set."""
    jobs = synth_job_stream(FALLBACK, n_jobs=n_jobs, horizon=horizon,
                            seed=seed)
    return jobs, jobs_to_task_set(jobs)


def schedule_day(task_set, *, l: int = 4, theta: float = 0.9,
                 classes: Optional[Sequence[str]] = None,
                 use_kernel: bool = False, device=None, cfgs=None,
                 base_cfgs=None):
    """The day with DVFS (EDL, ``theta``) and the no-DVFS baseline (EDL,
    theta 1); ``cfgs`` / ``base_cfgs`` inject Algorithm-1 output as
    ``schedule_online(cfgs=...)`` does.  Returns (dvfs result, baseline)."""
    device = resolve_device(device)
    mix = list(classes) if classes else None
    r_dvfs = online.schedule_online(task_set, l=l, theta=theta,
                                    algorithm="edl", use_dvfs=True,
                                    classes=mix, use_kernel=use_kernel,
                                    cfgs=cfgs, device=device)
    r_base = online.schedule_online(task_set, l=l, theta=1.0,
                                    algorithm="edl", use_dvfs=False,
                                    classes=mix, use_kernel=use_kernel,
                                    cfgs=base_cfgs, device=device)
    return r_dvfs, r_base


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Schedule a day of LM jobs on a DVFS fleet.")
    ap.add_argument("--jobs", type=int, default=400)
    ap.add_argument("--l", type=int, default=4,
                    help="accelerator slices per power domain")
    ap.add_argument("--theta", type=float, default=0.9)
    ap.add_argument("--horizon", type=int, default=720)
    ap.add_argument("--classes", default=None,
                    help="comma-separated machine-class mix from the "
                         "repro_torch.core.machines registry, e.g. "
                         "gtx-1080ti,tpu-v5e (default: homogeneous)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain torch versions)")
    args = ap.parse_args(argv)
    mix = args.classes.split(",") if args.classes else None

    jobs, ts = day_jobs(args.jobs, args.horizon)
    deltas = np.asarray(ts.params.delta)
    print(f"[fleet] roofline table: {len(FALLBACK)} cells (fallback)")
    print(f"[fleet] {len(ts)} jobs; delta range "
          f"[{deltas.min():.2f}, {deltas.max():.2f}] "
          f"(memory-bound decode ... compute-bound train)")
    if mix:
        print(f"[fleet] heterogeneous mix: {', '.join(mix)}")
    r_dvfs, r_base = schedule_day(ts, l=args.l, theta=args.theta,
                                  classes=mix, device=args.device)
    print(f"[fleet] no-DVFS  : E_run={r_base.e_run:.3e} "
          f"E_idle={r_base.e_idle:.3e} E_ovh={r_base.e_overhead:.3e} "
          f"(pairs={r_base.n_pairs})")
    print(f"[fleet] DVFS+EDL : E_run={r_dvfs.e_run:.3e} "
          f"E_idle={r_dvfs.e_idle:.3e} E_ovh={r_dvfs.e_overhead:.3e} "
          f"(pairs={r_dvfs.n_pairs}, violations={r_dvfs.violations})")
    print(f"[fleet] runtime-energy saving: "
          f"{1 - r_dvfs.e_run / r_base.e_run:.1%}")
    print(f"[fleet] total-energy saving:   "
          f"{1 - r_dvfs.e_total / r_base.e_total:.1%}")

    # What the scheduler dialed in, per kind of job.
    by_cell = {}
    for a in r_dvfs.assignments:
        j = jobs[a.task]
        by_cell.setdefault(f"{j.arch}/{j.shape}", []).append(
            (a.fc, a.fm, a.v))
    print("[fleet] mean chosen (fc, fm) per cell kind:")
    for cell, rows in sorted(by_cell.items()):
        rows = np.asarray(rows)
        print(f"    {cell:34s} fc={rows[:, 0].mean():.2f} "
              f"fm={rows[:, 1].mean():.2f} (n={len(rows)})")
    if mix:
        counts = np.bincount([a.class_id for a in r_dvfs.assignments],
                             minlength=len(mix))
        print("[fleet] jobs per machine class:")
        for name, cnt in zip(mix, counts):
            print(f"    {name:20s} {int(cnt)}")
    return r_dvfs, r_base


if __name__ == "__main__":
    main()

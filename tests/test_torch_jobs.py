"""The port's ``core/jobs.py`` and its ``launch/energy_sched.py`` twin of the
JAX package's ``examples/energy_sched_cluster.py``, on the CPU.

``jobs`` is numpy plus ``core/dvfs.py`` in both packages, so the job
stream, the Python-float ``DvfsParams`` of ``to_params`` and the task set
are bit-equal.  The twin's day then runs with the reference's Algorithm-1
output injected (``cfgs=``): at theta 0.9 the readjusted rows are re-priced
by the port's own boundary solver, so layouts and violations are identical
and energies agree to rel 1e-6 (``tests/test_torch_schedule.py``'s bar);
the no-DVFS baseline is bit-identical."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import jobs as rjobs  # noqa: E402
from repro.core import machines as rmachines  # noqa: E402
from repro.core import online as ronline  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dvfs, jobs  # noqa: E402
from repro_torch.launch import energy_sched  # noqa: E402

CLASSES = ("gtx-1080ti", "tpu-v5e", "v100-sxm2")
E_REL = 1e-6


def _ref_table():
    """The example's fallback table as the reference's records."""
    return {k: rjobs.RooflineTerms(*dataclasses.astuple(t))
            for k, t in energy_sched.FALLBACK.items()}


def _params_equal(got, want):
    for name, a, b in zip(("p0", "gamma", "c", "big_d", "delta", "t0"),
                          got.astuple(), want.astuple()):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed,n_jobs", [(0, 400), (3, 57)])
def test_synth_job_stream_matches_reference(seed, n_jobs):
    got = jobs.synth_job_stream(energy_sched.FALLBACK, n_jobs, horizon=720,
                                seed=seed)
    want = rjobs.synth_job_stream(_ref_table(), n_jobs, horizon=720,
                                  seed=seed)
    assert ([dataclasses.astuple(j) for j in got]
            == [dataclasses.astuple(j) for j in want])


@pytest.mark.parametrize("cell", sorted(energy_sched.FALLBACK))
@pytest.mark.parametrize("t0_frac", [0.10, 0.5])
def test_to_params_is_bit_equal(cell, t0_frac):
    """``tpu_task_params`` builds ``DvfsParams`` from Python floats (the
    collective share joins t0 when it is the larger)."""
    terms = energy_sched.FALLBACK[cell]
    job = jobs.AcceleratorJob(terms.arch, terms.shape, 123, 7.0, 1.7, terms,
                              t0_frac=t0_frac)
    rjob = rjobs.AcceleratorJob(terms.arch, terms.shape, 123, 7.0, 1.7,
                                _ref_table()[cell], t0_frac=t0_frac)
    got, want = job.to_params(), rjob.to_params()
    assert all(isinstance(f, float) for f in got.astuple())
    _params_equal(got, want)
    assert job.t_star == rjob.t_star
    assert terms.delta == rjob.terms.delta
    assert terms.bottleneck == rjob.terms.bottleneck


def test_tpu_task_params_is_the_references():
    from repro.core import dvfs as rdvfs
    for dur, delta, frac in ((12.5, 0.3, 0.1), (400.0, 0.91, 0.45)):
        _params_equal(dvfs.tpu_task_params(dur, delta, frac),
                      rdvfs.tpu_task_params(dur, delta, frac))


def test_jobs_to_task_set_is_bit_equal():
    got_jobs, got = energy_sched.day_jobs(n_jobs=200, horizon=360, seed=2)
    want = rjobs.jobs_to_task_set(rjobs.synth_job_stream(
        _ref_table(), 200, horizon=360, seed=2))
    for name in ("arrival", "deadline", "utilization"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype == np.float64, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    _params_equal(got.params, want.params)
    assert len(got_jobs) == len(got) == 200


def _layout(result):
    return [(a.task, a.pair, a.start, a.finish, a.class_id, a.failed)
            for a in result.assignments]


@pytest.mark.parametrize("classes", [None, CLASSES],
                         ids=["homogeneous", "three-class"])
def test_scheduled_day_matches_reference_with_injected_configs(classes):
    _, ts = energy_sched.day_jobs(n_jobs=160, horizon=360)
    rts = rjobs.jobs_to_task_set(rjobs.synth_job_stream(
        _ref_table(), 160, horizon=360, seed=0))
    mcs = rmachines.resolve_classes(list(classes) if classes else None)
    inject = [[convert.task_config_from_arrays(c._asdict())
               for c in ronline.online_configs(rts, mcs, use_dvfs=dvfs_on)]
              for dvfs_on in (True, False)]
    got, got_base = energy_sched.schedule_day(
        ts, l=4, theta=0.9, classes=classes, device="cpu", cfgs=inject[0],
        base_cfgs=inject[1])
    mix = list(classes) if classes else None
    want = ronline.schedule_online(rts, l=4, theta=0.9, algorithm="edl",
                                   use_dvfs=True, classes=mix)
    want_base = ronline.schedule_online(rts, l=4, theta=1.0, algorithm="edl",
                                        use_dvfs=False, classes=mix)
    for g, w in ((got, want), (got_base, want_base)):
        assert _layout(g) == _layout(w)
        assert g.violations == w.violations
        assert (g.n_pairs, g.n_servers) == (w.n_pairs, w.n_servers)
        np.testing.assert_allclose([a.energy for a in g.assignments],
                                   [a.energy for a in w.assignments],
                                   rtol=E_REL)
        assert g.e_total == pytest.approx(w.e_total, rel=E_REL)
    assert got_base.e_total == want_base.e_total


def test_main_prints_the_day(capsys):
    r_dvfs, r_base = energy_sched.main(["--jobs", "60", "--horizon", "120",
                                        "--classes", ",".join(CLASSES),
                                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[fleet] 60 jobs" in out and "jobs per machine class" in out
    assert len({a.task for a in r_dvfs.assignments}) == 60
    assert r_dvfs.e_total < r_base.e_total

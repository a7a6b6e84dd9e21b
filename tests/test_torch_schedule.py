"""The whole slice: the port's offline and online schedulers against the
JAX package's, on the CPU.

* With the reference's Algorithm-1 output injected (``cfgs=``, carried
  across by ``repro_torch.convert``) the host layers (engine, placement,
  faults, drivers) are copies, so at theta = 1.0 the assignments and
  ``e_total`` are bit-identical.  At theta = 0.7, and under a fault trace
  (an orphaned task is re-placed with a shrunken window), readjusted rows
  are re-priced by the port's own boundary solver: pair ids, starts and
  finishes stay identical, energies agree to rel 1e-6 (solver tolerance)
  and ``e_total`` to rel 1e-6.
* Without injection each package solves for itself: ``e_total`` within rel
  2e-3 (the bar of ``tests/test_kernels.py`` for the kernel path; tiny
  solver differences flip packing decisions).
* Inside the port: pipelined and synchronous runs are bit-identical, scalar
  and vector placement are bit-identical, and Eq. 7 conservation holds.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import bounds as rbounds  # noqa: E402
from repro.core import faults as rfaults  # noqa: E402
from repro.core import machines as rmachines  # noqa: E402
from repro.core import online as ronline  # noqa: E402
from repro.core import scheduling as rsched  # noqa: E402
from repro.core import tasks as rtasks  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bounds, faults, online, scheduling, tasks  # noqa: E402

CLASS_MIXES = {"homogeneous": None, "two-class": ("gtx-1080ti", "tpu-v5e")}
E_REL = 1e-6


@pytest.fixture(scope="module")
def offline_sets():
    return rtasks.generate_offline(0.3, seed=5), tasks.generate_offline(0.3, seed=5)


@pytest.fixture(scope="module")
def online_sets():
    return (rtasks.generate_online(0.1, 0.3, seed=2),
            tasks.generate_online(0.1, 0.3, seed=2))


def _inject(cfgs):
    return [convert.task_config_from_arrays(c._asdict()) for c in cfgs]


def _layout(result):
    return [(a.task, a.pair, a.start, a.finish, a.class_id, a.failed)
            for a in result.assignments]


def _energies(result):
    return np.asarray([a.energy for a in result.assignments])


def _conserved(result):
    run = sum(a.energy for a in result.assignments)
    assert result.e_total == pytest.approx(
        run + result.e_idle + result.e_overhead, rel=1e-12)
    live = [a.task for a in result.assignments if not a.failed]
    assert sorted(live) == sorted(set(live))


def _check_injected(want, got, exact):
    assert _layout(got) == _layout(want)
    assert got.violations == want.violations
    assert (got.n_pairs, got.n_servers) == (want.n_pairs, want.n_servers)
    if exact:
        assert got.e_total == want.e_total
        np.testing.assert_array_equal(_energies(got), _energies(want))
    else:
        np.testing.assert_allclose(_energies(got), _energies(want), rtol=E_REL)
        assert got.e_total == pytest.approx(want.e_total, rel=E_REL)
    _conserved(got)


@pytest.mark.parametrize("mix", CLASS_MIXES)
@pytest.mark.parametrize("theta", [1.0, 0.7])
@pytest.mark.parametrize("algorithm", ["edl", "edf-wf", "edf-bf", "lpt-ff"])
def test_offline_injected(offline_sets, mix, theta, algorithm):
    ts_r, ts_p = offline_sets
    classes = CLASS_MIXES[mix]
    cfgs = rsched.configure_all(ts_r, True, rmachines.resolve_classes(classes))
    kw = dict(l=2, theta=theta, algorithm=algorithm, classes=classes,
              bound=False)
    want = rsched.schedule_offline(ts_r, cfgs=cfgs, **kw)
    got = scheduling.schedule_offline(ts_p, cfgs=_inject(cfgs), device="cpu",
                                      **kw)
    _check_injected(want, got, exact=(theta == 1.0))


def _fault_traces(ts_r, l):
    n = max(1, rtasks.peak_pair_estimate(ts_r) // l)
    return (rfaults.FaultTrace.sample(n, 400.0, mtbf=300.0, mttr=20.0, seed=4),
            faults.FaultTrace.sample(n, 400.0, mtbf=300.0, mttr=20.0, seed=4))


@pytest.mark.parametrize("mix", CLASS_MIXES)
@pytest.mark.parametrize("theta", [1.0, 0.7])
@pytest.mark.parametrize("algorithm", ["edl", "bin"])
@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("with_faults", [False, True])
def test_online_injected(online_sets, mix, theta, algorithm, pipeline,
                         with_faults):
    ts_r, ts_p = online_sets
    classes = CLASS_MIXES[mix]
    cfgs = ronline.online_configs(ts_r, rmachines.resolve_classes(classes))
    tr_r, tr_p = _fault_traces(ts_r, 2) if with_faults else (None, None)
    kw = dict(l=2, theta=theta, algorithm=algorithm, classes=classes,
              pipeline=pipeline, bound=False)
    want = ronline.schedule_online(ts_r, cfgs=cfgs, faults=tr_r, **kw)
    got = online.schedule_online(ts_p, cfgs=_inject(cfgs), faults=tr_p,
                                 device="cpu", **kw)
    _check_injected(want, got, exact=(theta == 1.0 and not with_faults))
    assert got.fault_stats == want.fault_stats


@pytest.mark.parametrize("mix", CLASS_MIXES)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_offline_self_solved_close_to_reference(offline_sets, mix, use_kernel):
    ts_r, ts_p = offline_sets
    kw = dict(l=2, theta=0.9, algorithm="edl", classes=CLASS_MIXES[mix],
              use_kernel=use_kernel)
    want = rsched.schedule_offline(ts_r, **kw)
    got = scheduling.schedule_offline(ts_p, device="cpu", **kw)
    assert got.e_total == pytest.approx(want.e_total, rel=2e-3)
    assert got.violations == want.violations
    assert got.e_bound == pytest.approx(want.e_bound, rel=E_REL)
    _conserved(got)


@pytest.mark.parametrize("mix", CLASS_MIXES)
def test_online_self_solved_close_to_reference(online_sets, mix):
    ts_r, ts_p = online_sets
    kw = dict(l=2, theta=0.9, algorithm="edl", classes=CLASS_MIXES[mix])
    want = ronline.schedule_online(ts_r, **kw)
    got = online.schedule_online(ts_p, device="cpu", **kw)
    assert got.e_total == pytest.approx(want.e_total, rel=2e-3)
    assert got.e_bound == pytest.approx(want.e_bound, rel=E_REL)
    _conserved(got)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_faults", [False, True])
def test_online_pipelined_equals_synchronous(online_sets, use_kernel,
                                             with_faults):
    _, ts = online_sets
    tr = _fault_traces(online_sets[0], 2)[1] if with_faults else None
    kw = dict(l=2, theta=0.8, classes=("gtx-1080ti", "tpu-v5e", "v100-sxm2"),
              use_kernel=use_kernel, faults=tr, device="cpu")
    a = online.schedule_online(ts, pipeline=True, **kw)
    b = online.schedule_online(ts, pipeline=False, **kw)
    assert _layout(a) == _layout(b)
    np.testing.assert_array_equal(_energies(a), _energies(b))
    assert (a.e_total, a.violations, a.fault_stats) == \
        (b.e_total, b.violations, b.fault_stats)
    _conserved(a)


@pytest.mark.parametrize("algorithm", ["edl", "bin"])
@pytest.mark.parametrize("with_faults", [False, True])
def test_online_scalar_equals_vector(online_sets, algorithm, with_faults):
    _, ts = online_sets
    tr = _fault_traces(online_sets[0], 2)[1] if with_faults else None
    kw = dict(l=2, theta=0.8, algorithm=algorithm, classes=("gtx-1080ti",
              "tpu-v5e"), faults=tr, device="cpu", bound=False)
    a = online.schedule_online(ts, placement="vector", **kw)
    b = online.schedule_online(ts, placement="scalar", **kw)
    assert _layout(a) == _layout(b)
    assert (a.e_total, a.violations, a.fault_stats) == \
        (b.e_total, b.violations, b.fault_stats)


@pytest.mark.parametrize("algorithm", ["edl", "edf-bf", "lpt-ff"])
def test_offline_scalar_equals_vector(offline_sets, algorithm):
    _, ts = offline_sets
    kw = dict(l=3, theta=0.8, algorithm=algorithm, device="cpu", bound=False)
    a = scheduling.schedule_offline(ts, placement="vector", **kw)
    b = scheduling.schedule_offline(ts, placement="scalar", **kw)
    assert _layout(a) == _layout(b)
    assert (a.e_total, a.violations) == (b.e_total, b.violations)


def test_theoretical_bound_anchor():
    """The §5 wide-interval savings ceiling of the app library (the 0.3646
    anchor of ``tests/test_placement.py``), and the reference's value to
    rel 1e-6."""
    lib = rtasks.app_library()
    n = lib.n
    mk = dict(arrival=np.zeros(n), deadline=np.full(n, 1e9),
              params=dataclasses.asdict(lib), utilization=np.full(n, 0.5))
    ts_r = rtasks.TaskSet(mk["arrival"], mk["deadline"], lib, mk["utilization"])
    ts_p = convert.task_set_from_arrays(mk)
    got = bounds.theoretical_bound(ts_p, device="cpu")
    assert got.savings_ceiling == pytest.approx(0.3646, abs=0.01)
    want = rbounds.theoretical_bound(ts_r)
    assert got.e_run == pytest.approx(want.e_run, rel=E_REL)
    assert got.e_baseline == want.e_baseline
    online_bound = bounds.theoretical_bound(ts_p, classes=("gtx-1080ti",
                                            "tpu-v5e"), l=4, rho=5,
                                            device="cpu", dedup=False)
    assert online_bound.e_idle > 0 and online_bound.e_overhead > 0


def test_online_configs_close_to_reference(online_sets):
    ts_r, ts_p = online_sets
    mcs_r = rmachines.resolve_classes(("gtx-1080ti", "v100-sxm2"))
    mcs_p = online.machines.resolve_classes(("gtx-1080ti", "v100-sxm2"))
    for use_kernel in (False, True):
        want = ronline.online_configs(ts_r, mcs_r, use_kernel=use_kernel)
        got = online.online_configs(ts_p, mcs_p, use_kernel=use_kernel,
                                    device="cpu")
        for w, g in zip(want, got):
            rel = np.abs(g.e_hat - w.e_hat) / w.e_hat
            assert float(rel.max()) <= E_REL
            assert float(np.mean(g.deadline_prior == w.deadline_prior)) >= 0.999
            np.testing.assert_array_equal(g.t_min, w.t_min)

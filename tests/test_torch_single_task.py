"""Algorithm 1 of the port (``core/single_task.py``, the grid+golden
solvers in torch on the CPU) against the JAX package's jitted solvers.

Tolerances: energy rel <= 1e-6, and ``deadline_prior`` / ``feasible``
identical on the app-library task sets and on >= 99.9% of fuzz rows.  The
settings themselves (v, fc, fm) may move further: the JAX solvers run
under XLA, which contracts a*b+c into one rounding, so the two searches can
land on neighbouring points of an almost flat energy minimum.  The host
helpers (no search) are held bit-equal."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import dvfs as rdvfs  # noqa: E402
from repro.core import single_task as ref  # noqa: E402
from repro.core import solver_cache as rcache  # noqa: E402
from repro.core import tasks as rtasks  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dvfs, single_task, solver_cache  # noqa: E402

E_REL = 1e-6


def _pp(params):
    return convert.dvfs_params_from_arrays(dataclasses.asdict(params))


def _iv(name):
    return getattr(rdvfs, name), getattr(dvfs, name)


def _library_case(seed=9, util=0.2):
    ts = rtasks.generate_offline(util, seed=seed)
    return ts.params, ts.deadline - ts.arrival


def _fuzz_case(seed, n=256):
    rng = np.random.default_rng(seed)
    p_star = rng.uniform(120, 260, n)
    gamma = p_star * rng.uniform(0.05, 0.25, n)
    p0 = p_star * rng.uniform(0.1, 0.5, n)
    params = rdvfs.DvfsParams(p0=p0, gamma=gamma, c=p_star - gamma - p0,
                              big_d=rng.uniform(1.0, 50.0, n),
                              delta=rng.uniform(0.0, 1.0, n),
                              t0=rng.uniform(0.05, 5.0, n))
    tstar = np.asarray(params.default_time())
    tmin = np.asarray(rdvfs.min_time(params, rdvfs.WIDE))
    allowed = 0.5 * tmin + (2.0 * tstar - 0.5 * tmin) * rng.random(n)
    return params, allowed


def _check(want, got, min_flag_agreement):
    got = [solver_cache.to_numpy(f) for f in got]
    want = [np.asarray(f) for f in want]
    e_w, e_g = want[5], got[5]
    rel = np.abs(e_g - e_w) / np.abs(e_w)
    assert float(rel.max()) <= E_REL
    for k in (6, 7):
        agree = float(np.mean(want[k] == got[k]))
        assert agree >= min_flag_agreement
    assert all(np.all(np.isfinite(f)) for f in got[:6])


@pytest.mark.parametrize("iv", ["WIDE", "NARROW"])
@pytest.mark.parametrize("solver", ["solve_with_deadline", "solve_on_boundary"])
def test_deadline_solvers_library(iv, solver):
    params, allowed = _library_case()
    a, b = _iv(iv)
    want = getattr(ref, solver)(params, allowed, a)
    got = getattr(single_task, solver)(_pp(params), allowed, b, device="cpu")
    _check(want, got, 1.0)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("solver", ["solve_with_deadline", "solve_on_boundary"])
def test_deadline_solvers_fuzz(seed, solver):
    params, allowed = _fuzz_case(seed)
    want = getattr(ref, solver)(params, allowed, rdvfs.WIDE)
    got = getattr(single_task, solver)(_pp(params), allowed, dvfs.WIDE,
                                       device="cpu")
    _check(want, got, 0.999)


@pytest.mark.parametrize("iv", ["WIDE", "NARROW", "TPU_V5E_INTERVAL"])
def test_unconstrained_library(iv):
    params = rtasks.app_library()
    a, b = _iv(iv)
    _check(ref.solve_unconstrained(params, a),
           single_task.solve_unconstrained(_pp(params), b, device="cpu"), 1.0)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("iv", ["WIDE", "NARROW"])
def test_configure_tasks(dedup, iv):
    params, allowed = _library_case(seed=4, util=0.15)
    a, b = _iv(iv)
    want = ref.configure_tasks(params, allowed, a, dedup=dedup)
    got = single_task.configure_tasks(_pp(params), allowed, b, dedup=dedup,
                                      device="cpu")
    rel = np.abs(got.e_hat - want.e_hat) / want.e_hat
    assert float(rel.max()) <= E_REL
    np.testing.assert_array_equal(got.deadline_prior, want.deadline_prior)
    np.testing.assert_array_equal(got.feasible, want.feasible)
    assert got.n_deadline_prior == want.n_deadline_prior
    # t_min is host math: bit-equal, float64 as in the reference
    assert got.t_min.dtype == want.t_min.dtype
    np.testing.assert_array_equal(got.t_min, want.t_min)
    for f in ("v", "fc", "fm", "t_hat", "p_hat", "e_hat"):
        assert getattr(got, f).dtype == getattr(want, f).dtype


def test_dedup_is_bit_transparent_inside_the_port():
    params, allowed = _library_case(seed=6, util=0.15)
    solver_cache.GLOBAL_CACHE.clear()
    a = single_task.configure_tasks(_pp(params), allowed, dedup=True,
                                    device="cpu")
    b = single_task.configure_tasks(_pp(params), allowed, dedup=False,
                                    device="cpu")
    c = single_task.configure_tasks(_pp(params), allowed, dedup=True,
                                    device="cpu")    # served from the cache
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(getattr(a, f), getattr(c, f))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("boundary", [False, True])
def test_async_rows_equal_sync_solve(use_kernel, boundary):
    params, allowed = _library_case(seed=8, util=0.1)
    pp = _pp(params)
    h = single_task.solve_rows_async(pp, allowed, dvfs.WIDE,
                                     boundary=boundary, use_kernel=use_kernel,
                                     dedup=False, device="cpu")
    rows = h.result()
    if boundary:
        sync = single_task.readjust_batch(pp, allowed, use_kernel=use_kernel,
                                          dedup=False, device="cpu")
        np.testing.assert_array_equal(rows[:, 4].astype(np.float64), sync[4])
    else:
        cfg = single_task.configure_tasks(pp, allowed, use_kernel=use_kernel,
                                          dedup=False, device="cpu")
        np.testing.assert_array_equal(rows[:, 4], cfg.p_hat)
        np.testing.assert_array_equal(rows[:, 6] > 0.5, cfg.deadline_prior)


@pytest.mark.parametrize("dedup", [True, False])
def test_readjust_batch(dedup):
    lib = rtasks.app_library()
    params = rdvfs.DvfsParams.stack([lib[i] for i in range(12)])
    tstar = np.asarray(params.default_time())
    tmin = np.asarray(rdvfs.min_time(params, rdvfs.WIDE))
    windows = tmin + (tstar - tmin) * np.linspace(0.15, 0.9, 12)
    want = ref.readjust_batch(params, windows, dedup=dedup)
    got = single_task.readjust_batch(_pp(params), windows, dedup=dedup,
                                     device="cpu")
    rel = np.abs(got[5] - want[5]) / want[5]
    assert float(rel.max()) <= E_REL
    assert np.all(got[3] <= windows)
    scalar = single_task.readjust(_pp(params)[2], float(windows[2]),
                                  device="cpu")
    assert abs(scalar[5] - got[5][2]) / got[5][2] <= E_REL


def test_host_helpers_bit_equal():
    ts = rtasks.generate_offline(0.1, seed=3)
    allowed = ts.deadline - ts.arrival
    pp = _pp(ts.params)
    for iv in ("WIDE", "NARROW"):
        a, b = _iv(iv)
        for x, y in zip(ref.max_speed_setting(ts.params, a),
                        single_task.max_speed_setting(pp, b)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    want, got = ref.no_dvfs_config(ts.params, allowed), \
        single_task.no_dvfs_config(pp, allowed)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f))
    # pad_pow2 pads identically
    pw, aw, _, nw = ref.pad_pow2(ts.params, allowed)
    pg, ag, _, ng = single_task.pad_pow2(pp, allowed)
    assert nw == ng
    np.testing.assert_array_equal(aw, ag)
    for x, y in zip(pw.astuple(), pg.astuple()):
        np.testing.assert_array_equal(x, y)


def test_config_from_solution_bit_equal_on_the_same_rows():
    """Given the same solution rows, the TaskConfig assembly (t_min floor,
    the deadline snap) is host math and must match bit for bit."""
    params, allowed = _library_case(seed=2, util=0.1)
    rows = rcache.solution_to_rows(ref.solve_with_deadline(params, allowed))
    want = ref.config_from_solution(rcache.rows_to_solution(rows), params,
                                    allowed, rdvfs.WIDE)
    got = single_task.config_from_solution(
        solver_cache.rows_to_solution(rows), _pp(params), allowed, dvfs.WIDE)
    for f in want._fields:
        x, y = getattr(want, f), getattr(got, f)
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)

"""The ``dvfs_opt`` kernel's plain torch version against the JAX package's
Pallas kernel (run in interpret mode, as its own tests run it on the CPU)
and against the grid+golden oracles of both packages.

Tolerances: against the Pallas kernel at the same grid, energy rel <= 1e-6
and ``deadline_prior`` / ``feasible`` equal on >= 99.9% of rows (the Pallas
body runs under XLA, which contracts a*b+c, so a sweep can pick the
neighbouring grid point of an almost flat minimum).  Against the oracles,
the bounds of ``tests/test_kernels.py``: max rel < 1e-5 and > 99%
deadline-prior agreement on the library, and on the fuzz rows median rel
< 2e-3, mean < 1e-2, >= 90% agreement, every setting inside its box.  On
the edge rows (NaN and inf inputs), NaN in the same places as the Pallas
kernel's, equal flags, finite values within rel 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import dvfs as rdvfs  # noqa: E402
from repro.core import tasks as rtasks  # noqa: E402
from repro.kernels import dvfs_opt as rkernel  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.core import dvfs  # noqa: E402
from repro_torch.kernels import dvfs_opt, ops, ref  # noqa: E402


def fuzz_matrix(seed: int, n: int) -> np.ndarray:
    """The widened ``[n, 16]`` fuzz matrix of ``tests/test_kernels.py``:
    random params and windows (below t_min up to 2 t*), 30% readjust rows,
    mixed boxes including a degenerate single-point one."""
    rng = np.random.default_rng(seed)
    p_star = rng.uniform(120, 260, n)
    gamma = p_star * rng.uniform(0.05, 0.25, n)
    p0 = p_star * rng.uniform(0.1, 0.5, n)
    params = rdvfs.DvfsParams(p0=p0, gamma=gamma, c=p_star - gamma - p0,
                              big_d=rng.uniform(1.0, 50.0, n),
                              delta=rng.uniform(0.0, 1.0, n),
                              t0=rng.uniform(0.05, 5.0, n))
    boxes = [rdvfs.WIDE.bounds(), rdvfs.NARROW.bounds()]
    for _ in range(2):
        v_min = float(rng.uniform(0.5, 0.9))
        v_max = float(rng.uniform(v_min + 0.05, 1.24))
        fm_min = float(rng.uniform(0.5, 0.9))
        boxes.append((v_min, v_max, float(rng.uniform(0.5, 0.8)),
                      fm_min, float(rng.uniform(fm_min + 0.05, 1.2))))
    v = float(rng.uniform(0.7, 1.2))
    boxes.append((v, v, rdvfs.g1_float(v), 1.0, 1.0))
    bounds = np.asarray([boxes[i] for i in rng.integers(0, len(boxes), n)],
                        np.float32)
    tstar = np.asarray(params.default_time())
    fc_max = np.sqrt(np.maximum(bounds[:, 1].astype(np.float64) - 0.5, 0) / 2) + 0.5
    tmin = (params.big_d * (params.delta / fc_max + (1 - params.delta)
                            / bounds[:, 4].astype(np.float64)) + params.t0)
    readj = (rng.random(n) < 0.3).astype(np.float32)
    lo = np.where(readj > 0.5, tmin, 0.5 * tmin)
    allowed = lo + (2.0 * tstar - lo) * rng.random(n)
    mat = np.stack([np.asarray(f, np.float32) for f in params.astuple()]
                   + [allowed.astype(np.float32), readj], axis=1)
    return np.concatenate([mat, bounds, np.zeros((n, 3), np.float32)], axis=1)


def library_matrix() -> np.ndarray:
    """The generated offline library set as ``[n, 16]`` rows on WIDE."""
    lib = rtasks.generate_offline(0.08, seed=9)
    allowed = lib.deadline - lib.arrival
    n = len(lib)
    mat = np.stack([np.asarray(f, np.float32) for f in lib.params.astuple()]
                   + [np.asarray(allowed, np.float32), np.zeros(n, np.float32)],
                   axis=1)
    bounds = np.broadcast_to(np.asarray(rdvfs.WIDE.bounds(), np.float32), (n, 5))
    return np.concatenate([mat, bounds, np.zeros((n, 3), np.float32)], axis=1)


def _plain(mat):
    return dvfs_opt.dvfs_solve_plain(torch.from_numpy(mat)).numpy()


def _pallas(mat):
    return np.asarray(rkernel.dvfs_solve_kernel(jnp.asarray(mat),
                                                interpret=True))


def _agree(a, b, min_flags, max_rel):
    rel = np.abs(a[:, 5] - b[:, 5]) / np.abs(b[:, 5])
    assert float(rel.max()) <= max_rel
    for k in (6, 7):
        assert float(np.mean(a[:, k] == b[:, k])) >= min_flags


@pytest.mark.parametrize("seed,n", [(0, 64), (1, 128), (2, 200), (3, 384),
                                    (4, 512)])
def test_plain_matches_pallas_fuzz(seed, n):
    mat = fuzz_matrix(seed, n)
    got = _plain(mat)
    assert got.shape == (n, 8) and got.dtype == np.float32
    _agree(got, _pallas(mat), 0.999, 1e-6)


def test_plain_matches_pallas_library():
    mat = library_matrix()
    _agree(_plain(mat), _pallas(mat), 0.999, 1e-6)
    app = rtasks.app_library()
    rows = np.stack([np.asarray(f, np.float32) for f in app.astuple()]
                    + [np.asarray(app.default_time(), np.float32) * 1.1,
                       np.zeros(app.n, np.float32)], axis=1)   # legacy [n, 8]
    got = dvfs_opt.dvfs_solve_kernel(torch.from_numpy(rows)).numpy()
    _agree(got, np.asarray(rkernel.dvfs_solve_kernel(jnp.asarray(rows),
                                                     interpret=True)),
           1.0, 1e-6)


@pytest.mark.parametrize("grid", [(64, 64), (8, 8)])
def test_plain_matches_pallas_edge_rows(grid):
    """The edge rows (a NaN in each input column, infinite and just-feasible
    windows, gamma 0, delta 0 and 1, a one-point box, an empty core range):
    NaN in the same places, equal flags, finite values within rel 1e-6."""
    mat = dvfs_opt.edge_rows()
    assert all(np.isnan(mat[:, c]).any() for c in range(13))
    assert set(mat[:, 7][~np.isnan(mat[:, 7])]) == {0.0, 1.0}
    got = dvfs_opt.dvfs_solve_plain(torch.from_numpy(mat), grid).numpy()
    want = np.asarray(rkernel.dvfs_solve_kernel(jnp.asarray(mat), grid=grid,
                                                interpret=True))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[:, 6:], want[:, 6:])
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert np.all(np.abs(got[fin] - want[fin]) <= 1e-6 * np.abs(want[fin]))


@pytest.mark.parametrize("grid", [(8, 8), (16, 4)])
def test_plain_matches_pallas_other_grids(grid):
    mat = fuzz_matrix(7, 128)
    got = dvfs_opt.dvfs_solve_plain(torch.from_numpy(mat), grid).numpy()
    want = np.asarray(rkernel.dvfs_solve_kernel(jnp.asarray(mat), grid=grid,
                                                interpret=True))
    _agree(got, want, 0.999, 1e-6)


def test_library_against_oracles():
    mat = library_matrix()
    sol = ops.dvfs_solve_matrix(mat, device="cpu")
    for expect in (ref.dvfs_solve_ref(mat[:, :8], device="cpu"),
                   rref.dvfs_solve_ref(mat[:, :8])):
        rel = np.abs(sol[:, 5] - expect[:, 5]) / expect[:, 5]
        assert float(np.max(rel)) < 1e-5
        assert float(np.mean((sol[:, 6] > .5) == (expect[:, 6] > .5))) > 0.99
    ok = sol[:, 7] > .5
    assert np.all(sol[ok, 3] <= mat[ok, 6] * (1 + 1e-4))


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_against_oracles(seed):
    mat = fuzz_matrix(seed, 64)
    got = ops.dvfs_solve_matrix(mat, device="cpu")
    for expect in (ref.dvfs_solve_ref(mat, device="cpu"),
                   rref.dvfs_solve_ref(mat)):
        e_got, e_exp = got[:, 5], expect[:, 5]
        rel = np.abs(e_got - e_exp) / np.maximum(e_exp, 1e-9)
        assert float(np.median(rel)) < 2e-3
        assert float(np.mean(rel)) < 1e-2
        assert float(np.mean((got[:, 6] > .5) == (expect[:, 6] > .5))) >= 0.9
    for j, (lo_c, hi_c) in ((0, (8, 9)), (2, (11, 12))):   # v, fm
        assert np.all(got[:, j] >= mat[:, lo_c] - 1e-4)
        assert np.all(got[:, j] <= mat[:, hi_c] + 1e-4)
    assert np.all(got[:, 1] >= mat[:, 10] - 1e-4)          # fc >= fc_min
    ok = (got[:, 7] > .5) & (got[:, 6] > .5)
    assert np.all(got[ok, 3] <= mat[ok, 6] * (1 + 1e-3))


def test_port_oracle_matches_reference_oracle():
    """Tolerance: energy rel <= 1e-6, flags equal (both are the grid+golden
    solver, the reference's under XLA)."""
    mat = fuzz_matrix(11, 256)
    _agree(ref.dvfs_solve_ref(mat, device="cpu"), rref.dvfs_solve_ref(mat),
           0.999, 1e-6)


def test_matrix_layouts_and_in_flight_return():
    mat = fuzz_matrix(3, 100)
    full = ops.dvfs_solve_matrix(mat, device="cpu")
    # the [m, 13] key layout is widened with zero pad columns
    np.testing.assert_array_equal(
        ops.dvfs_solve_matrix(mat[:, :13], device="cpu"), full)
    pending = ops.dvfs_solve_matrix(mat, device="cpu", block=False)
    assert isinstance(pending, torch.Tensor)
    np.testing.assert_array_equal(pending.numpy(), full)
    # legacy [n, 8] rows are widened from the static interval
    wide = mat.copy()
    wide[:, 8:13] = np.asarray(dvfs.NARROW.bounds(), np.float32)
    np.testing.assert_array_equal(
        dvfs_opt.dvfs_solve_kernel(torch.from_numpy(mat[:, :8]),
                                   interval=dvfs.NARROW).numpy(),
        _plain(wide))


def test_rows_are_independent():
    """A row's solution does not depend on its batch: the property the
    solve cache's dedup and the pipelined chunks rely on."""
    mat = fuzz_matrix(5, 96)
    full = _plain(mat)
    np.testing.assert_array_equal(_plain(mat[17:40]), full[17:40])


def test_dvfs_solve_readjust_and_interval_rows():
    lib = rtasks.app_library()
    params = rdvfs.DvfsParams.stack([lib[i] for i in range(8)])
    tstar = np.asarray(params.default_time())
    tmin = np.asarray(rdvfs.min_time(params, rdvfs.WIDE))
    windows = tmin + (tstar - tmin) * np.linspace(0.15, 0.9, 8)
    pp = dvfs.DvfsParams(*params.astuple())
    sol = ops.dvfs_solve(pp, windows, readjust=True, device="cpu")
    assert np.all(sol.deadline_prior)
    assert np.all(sol.time <= windows * (1 + 1e-4))
    rows = np.broadcast_to(np.asarray(dvfs.NARROW.bounds()), (8, 5))
    a = ops.dvfs_solve(pp, tstar * 2, interval_rows=rows, device="cpu",
                       dedup=False)
    b = ops.dvfs_solve(pp, tstar * 2, interval=dvfs.NARROW, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="interval_rows"):
        ops.dvfs_solve(pp, tstar, interval_rows=rows[:3], device="cpu")


@pytest.mark.parametrize("grid", [(1, 64), (64, 0)])
def test_bad_grid_raises(grid):
    with pytest.raises(ValueError, match="grid"):
        dvfs_opt.dvfs_solve_plain(torch.zeros((4, 16)), grid)


def test_bad_width_raises():
    with pytest.raises(ValueError, match="columns"):
        dvfs_opt.dvfs_solve_kernel(torch.zeros((4, 12)))

"""The port's task generators return TaskSets bit-equal to the JAX
package's for the same seed (tolerance: exact, dtypes included)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import tasks as ref  # noqa: E402
from repro_torch.core import tasks  # noqa: E402


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_params(a, b):
    for x, y in zip(a.astuple(), b.astuple()):
        _same(x, y)


def _same_set(a, b):
    _same(a.arrival, b.arrival)
    _same(a.deadline, b.deadline)
    _same(a.utilization, b.utilization)
    _same_params(a.params, b.params)
    _same(a.t_star, b.t_star)
    _same(a.p_star, b.p_star)
    assert a.total_utilization == b.total_utilization
    assert ref.peak_pair_estimate(a) == tasks.peak_pair_estimate(b)


@pytest.mark.parametrize("kw", [{}, {"seed": 3}, {"n_apps": 7},
                                {"p0_frac": ref.REALISTIC_P0}])
def test_app_library(kw):
    _same_params(ref.app_library(**kw), tasks.app_library(**kw))


@pytest.mark.parametrize("util,seed", [(0.1, 0), (0.4, 5)])
def test_generate_offline(util, seed):
    _same_set(ref.generate_offline(util, seed=seed),
              tasks.generate_offline(util, seed=seed))


@pytest.mark.parametrize("seed", [0, 2])
def test_generate_online(seed):
    _same_set(ref.generate_online(0.1, 0.3, seed=seed),
              tasks.generate_online(0.1, 0.3, seed=seed))


@pytest.mark.parametrize("n,seed", [(1, 0), (500, 4)])
def test_generate_offline_n(n, seed):
    _same_set(ref.generate_offline_n(n, seed=seed),
              tasks.generate_offline_n(n, seed=seed))


@pytest.mark.parametrize("pattern", ["uniform", "sparse", "bursty", "diurnal"])
def test_generate_trace(pattern):
    assert tasks.TRACE_PATTERNS == ref.TRACE_PATTERNS
    _same_set(ref.generate_trace(2000, pattern, seed=7),
              tasks.generate_trace(2000, pattern, seed=7))


def test_subset_and_concat():
    a, b = ref.generate_offline(0.1, seed=1), tasks.generate_offline(0.1, seed=1)
    idx = np.arange(0, len(a), 3)
    _same_set(a.subset(idx), b.subset(idx))
    _same_set(a.concat(a.subset(idx)), b.concat(b.subset(idx)))


def test_unknown_pattern_raises():
    with pytest.raises(ValueError, match="pattern"):
        tasks.generate_trace(10, "weekly")

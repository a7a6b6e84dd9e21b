"""Eq. 1-4 of the port against the JAX package on random inputs.

Tolerance: bit-equal.  The port follows the reference's dtype flow (numpy
float64 expressions stay float64, ``jnp`` functions are float32), and its
CPU square root is correctly rounded like ``jnp.sqrt``; both evaluate each
operation eagerly with IEEE rounding, so every result matches exactly."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import dvfs as ref  # noqa: E402
from repro_torch.core import dvfs  # noqa: E402

N = 4096
INTERVALS = ("WIDE", "NARROW", "TPU_V5E_INTERVAL")


def _draw(seed):
    rng = np.random.default_rng(seed)
    p_star = rng.uniform(120, 260, N)
    gamma = p_star * rng.uniform(0.05, 0.25, N)
    p0 = p_star * rng.uniform(0.1, 0.5, N)
    kw = dict(p0=p0, gamma=gamma, c=p_star - gamma - p0,
              big_d=rng.uniform(1.0, 50.0, N), delta=rng.uniform(0.0, 1.0, N),
              t0=rng.uniform(0.05, 5.0, N))
    kw["gamma"][:16] = 0.0   # the gamma == 0 branch of optimal_fm
    x = dict(v=rng.uniform(0.5, 1.24, N), fc=rng.uniform(0.5, 1.1, N),
             fm=rng.uniform(0.5, 1.2, N))
    return kw, x


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def _f32(kw, x, module, as_array):
    p = module.DvfsParams(**{k: as_array(np.asarray(v, np.float32))
                             for k, v in kw.items()})
    return p, {k: as_array(np.asarray(v, np.float32)) for k, v in x.items()}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("fn", ["power", "exec_time", "energy", "optimal_fm"])
def test_model_functions_bit_equal(seed, fn):
    import jax.numpy as jnp

    kw, x = _draw(seed)
    args = {"power": ("v", "fc", "fm"), "exec_time": ("fc", "fm"),
            "energy": ("v", "fc", "fm"), "optimal_fm": ("v", "fc")}[fn]
    extra = {"optimal_fm": (ref.WIDE,)}.get(fn, ())
    extra_p = {"optimal_fm": (dvfs.WIDE,)}.get(fn, ())
    # float64 numpy inputs (the host layers' types) ...
    got = getattr(dvfs, fn)(dvfs.DvfsParams(**kw), *(x[a] for a in args),
                            *extra_p)
    want = getattr(ref, fn)(ref.DvfsParams(**kw), *(x[a] for a in args),
                            *extra)
    _same(want, got)
    # ... and float32 arrays (the solvers' types).
    pr, xr = _f32(kw, x, ref, jnp.asarray)
    pp, xp = _f32(kw, x, dvfs, torch.from_numpy)
    _same(getattr(ref, fn)(pr, *(xr[a] for a in args), *extra),
          getattr(dvfs, fn)(pp, *(xp[a] for a in args), *extra_p))


@pytest.mark.parametrize("name", INTERVALS)
def test_interval_constants_equal(name):
    a, b = getattr(ref, name), getattr(dvfs, name)
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert a.fc_max == b.fc_max
    assert a.bounds() == b.bounds()


def test_chip_constants_and_curve_constants_equal():
    assert ref.TPU_V5E_CHIP == dvfs.TPU_V5E_CHIP
    assert (ref.G1_A, ref.G1_B, ref.G1_C) == (dvfs.G1_A, dvfs.G1_B, dvfs.G1_C)
    assert ref.DEFAULT_SETTING == dvfs.DEFAULT_SETTING


@pytest.mark.parametrize("name", INTERVALS)
@pytest.mark.parametrize("seed", range(2))
def test_min_time_and_max_speed_power_bit_equal(name, seed):
    """The host helpers whose results the schedulers widen to float64
    (``online._floors_sync``, ``config_from_solution``, ``max_speed_setting``)."""
    kw, _ = _draw(seed)
    a, b = getattr(ref, name), getattr(dvfs, name)
    pr, pp = ref.DvfsParams(**kw), dvfs.DvfsParams(**kw)
    _same(ref.min_time(pr, a), dvfs.min_time(pp, b))
    _same(np.asarray(ref.min_time(pr, a), np.float64),
          np.asarray(dvfs.min_time(pp, b), np.float64))
    _same(ref.power(pr, a.v_max, a.fc_max, a.fm_max),
          dvfs.power(pp, b.v_max, b.fc_max, b.fm_max))


@pytest.mark.parametrize("seed", range(2))
def test_default_point_bit_equal(seed):
    kw, _ = _draw(seed)
    pr, pp = ref.DvfsParams(**kw), dvfs.DvfsParams(**kw)
    _same(pr.default_power(), pp.default_power())
    _same(pr.default_time(), pp.default_time())
    _same(pr.default_energy(), pp.default_energy())


@pytest.mark.parametrize("seed", range(2))
def test_curve_bit_equal(seed):
    _, x = _draw(seed)
    _same(ref.g1(x["v"]), dvfs.g1(x["v"]))
    _same(ref.g1_inv(x["fc"]), dvfs.g1_inv(x["fc"]))
    assert ref.g1_float(1.2) == dvfs.g1_float(1.2)


def test_clamp_bit_equal():
    _, x = _draw(0)
    for got, want in zip(dvfs.NARROW.clamp(x["v"], x["fc"], x["fm"]),
                         ref.NARROW.clamp(x["v"], x["fc"], x["fm"])):
        _same(want, got)


def test_params_indexing_and_stack():
    kw, _ = _draw(1)
    pp = dvfs.DvfsParams(**kw)
    assert pp.n == N
    row = pp[3]
    assert row.astuple() == tuple(np.asarray(v)[3] for v in kw.values())
    st = dvfs.DvfsParams.stack([pp[0], pp[1]])
    ref_st = ref.DvfsParams.stack([ref.DvfsParams(**kw)[0],
                                   ref.DvfsParams(**kw)[1]])
    for a, b in zip(st.astuple(), ref_st.astuple()):
        _same(b, a)

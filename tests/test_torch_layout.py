"""The port's matrix schema and kernel constants equal the JAX package's
(exact equality: these are integers, slices and f32 constants)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels import dvfs_opt as ref_dvfs_opt  # noqa: E402
from repro.kernels import layout as ref_layout  # noqa: E402
from repro_torch.kernels import dvfs_opt, layout  # noqa: E402

SCHEMA = ("P0", "GAMMA", "C_COEF", "BIG_D", "DELTA", "T0", "ALLOWED",
          "READJUST", "V_MIN", "V_MAX", "FC_MIN", "FM_MIN", "FM_MAX",
          "N_PARAMS", "N_BOUNDS", "LEGACY_NCOL", "KEY_COLS", "NCOL",
          "PARAMS_SLICE", "BOUNDS_SLICE", "SOL_V", "SOL_FC", "SOL_FM",
          "SOL_T", "SOL_P", "SOL_E", "SOL_DP", "SOL_FEASIBLE", "SOL_COLS")


@pytest.mark.parametrize("name", SCHEMA)
def test_schema_constant_equals_reference(name):
    assert getattr(layout, name) == getattr(ref_layout, name)


def test_every_reference_constant_is_ported():
    upper = {k for k in vars(ref_layout) if k.isupper()}
    assert upper == set(SCHEMA)


def test_solution_fields_equal_reference():
    assert layout.DvfsSolution._fields == ref_layout.DvfsSolution._fields


@pytest.mark.parametrize("i", [0, 7, 12])
def test_col_is_keepdims_slice(i):
    assert layout.col(i) == ref_layout.col(i) == slice(i, i + 1)


@pytest.mark.parametrize("name", ["BT", "DEFAULT_GRID", "INF"])
def test_kernel_constant_equals_reference(name):
    assert getattr(dvfs_opt, name) == getattr(ref_dvfs_opt, name)


def test_pad_row_equals_reference():
    assert dvfs_opt.PAD_ROW.dtype == ref_dvfs_opt.PAD_ROW.dtype == np.float32
    np.testing.assert_array_equal(dvfs_opt.PAD_ROW, ref_dvfs_opt.PAD_ROW)

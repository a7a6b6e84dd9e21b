"""Carry state across from the JAX package into the port.

The reference's ``DvfsParams``, ``TaskSet`` and ``TaskConfig`` are plain
records of numpy arrays.  These functions take those fields as numpy arrays
— a mapping of field name to array, or the fields in order — and build the
port's records, so a caller can, for example, inject the reference's
Algorithm-1 output into the port's schedulers (``cfgs=`` of
``schedule_offline`` / ``schedule_online``) and compare the host layers bit
for bit.  Nothing here imports the reference: pass
``dataclasses.asdict(x)`` or ``x._asdict()`` of its records, or their
``astuple()`` / tuple form.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np

from repro_torch.core.dvfs import DvfsParams
from repro_torch.core.single_task import TaskConfig
from repro_torch.core.tasks import TaskSet

Fields = Union[Mapping, Sequence]

_PARAMS = ("p0", "gamma", "c", "big_d", "delta", "t0")
_TASK_SET = ("arrival", "deadline", "params", "utilization")


def _fields(x: Fields, names: Sequence[str]) -> dict:
    if isinstance(x, Mapping):
        missing = [k for k in names if k not in x]
        if missing:
            raise KeyError(f"missing fields {missing}; need {list(names)}")
        return {k: x[k] for k in names}
    x = tuple(x)
    if len(x) != len(names):
        raise ValueError(f"need {len(names)} fields {list(names)}, got {len(x)}")
    return dict(zip(names, x))


def dvfs_params_from_arrays(fields: Fields) -> DvfsParams:
    """``DvfsParams`` from ``p0, gamma, c, big_d, delta, t0`` (values kept
    exactly: arrays are copied, not cast)."""
    return DvfsParams(**{k: np.array(v) for k, v in
                         _fields(fields, _PARAMS).items()})


def task_set_from_arrays(fields: Fields) -> TaskSet:
    """``TaskSet`` from ``arrival, deadline, params, utilization``; ``params``
    is itself a mapping or sequence of the six ``DvfsParams`` fields."""
    f = _fields(fields, _TASK_SET)
    return TaskSet(arrival=np.array(f["arrival"]),
                   deadline=np.array(f["deadline"]),
                   params=dvfs_params_from_arrays(f["params"]),
                   utilization=np.array(f["utilization"]))


def task_config_from_arrays(fields: Fields) -> TaskConfig:
    """``TaskConfig`` from its ten fields in ``TaskConfig._fields`` order
    (``n_deadline_prior`` an int, the rest arrays, copied with their
    dtypes)."""
    f = _fields(fields, TaskConfig._fields)
    return TaskConfig(**{k: (int(v) if k == "n_deadline_prior" else np.array(v))
                         for k, v in f.items()})

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

:func:`model_params_from_arrays` does the same for a model: the reference's
``Model.init`` pytree with numpy leaves becomes the port's parameter dict.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np
import torch

from repro_torch.core.dvfs import DvfsParams
from repro_torch.core.single_task import TaskConfig
from repro_torch.core.tasks import TaskSet
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import FAMILIES

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


def _tensors(tree, device):
    if isinstance(tree, Mapping):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def model_params_from_arrays(cfg: ModelConfig, tree: Mapping,
                             device="cpu") -> dict:
    """The port's parameters from the reference's ``Model.init`` pytree
    with numpy leaves (``jax.tree.map(np.asarray, params)``): the same keys
    and values (copied, dtypes kept), with the stacked ``[L, ...]`` leaves of
    ``tree["layers"]`` split into a list of ``L`` per-layer dicts."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    out = {k: _tensors(v, device) for k, v in tree.items() if k != "layers"}

    def layer(sub, i):
        if isinstance(sub, Mapping):
            return {k: layer(v, i) for k, v in sub.items()}
        return sub[i]

    stacked = _tensors(tree["layers"], device)
    n = {len(v) for v in _leaves(stacked)}
    if n != {cfg.n_layers}:
        raise ValueError(f"layer stacks of lengths {sorted(n)}, config has "
                         f"{cfg.n_layers} layers")
    out["layers"] = [layer(stacked, i) for i in range(cfg.n_layers)]
    return out


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree

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
``Model.init`` pytree with numpy leaves becomes the port's parameter dict;
:func:`model_params_to_arrays` is its inverse (tests compare gradients leaf
by leaf with it), and :func:`train_state_from_arrays` carries a training
state (parameters, AdamW moments, counts) across.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np
import torch

from repro_torch.core.dvfs import DvfsParams
from repro_torch.core.single_task import TaskConfig
from repro_torch.core.tasks import TaskSet
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import FAMILIES
from repro_torch.optim.adamw import OptState
from repro_torch.train.trainer import TrainState

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
    if isinstance(tree, (tuple, list)):
        return tuple(_tensors(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def _unstack(tree, n: int, name: str) -> list:
    """A tree of stacked ``[n, ...]`` leaves as a list of ``n`` trees."""
    lengths = {len(v) for v in _leaves(tree)}
    if lengths != {n}:
        raise ValueError(f"{name}: layer stacks of lengths {sorted(lengths)}, "
                         f"the config has {n}")

    def one(sub, i):
        if isinstance(sub, Mapping):
            return {k: one(v, i) for k, v in sub.items()}
        if isinstance(sub, tuple):
            return tuple(one(v, i) for v in sub)
        return sub[i]

    return [one(tree, i) for i in range(n)]


def _stacks(cfg: ModelConfig) -> dict:
    """The stacked groups of the family's parameter tree and their depth."""
    if cfg.family == "hybrid":
        return {"layers": cfg.n_layers // len(cfg.block_pattern)}
    if cfg.family == "encdec":
        return {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers}
    return {"layers": cfg.n_layers}


def model_params_from_arrays(cfg: ModelConfig, tree: Mapping,
                             device=None) -> dict:
    """The port's parameters from the reference's ``Model.init`` pytree
    with numpy leaves (``jax.tree.map(np.asarray, params)``): the same keys
    and values (copied, dtypes kept, tuples kept), with each stacked
    ``[L, ...]`` group split into a list of ``L`` per-layer trees:
    ``layers`` (for ``hybrid`` a list of pattern units, each a tuple of
    layers) and the encdec's ``enc_layers``.  The hybrid's ``rem_layers``
    tuple and ``enc_norm`` carry across as they are.  ``device`` as every
    entry point takes it (``kernels/ops.py::resolve_device``: None is the
    card).  Raises on a key the config's family does not have, and on
    stacks of the wrong depth."""
    device = resolve_device(device)
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is none of {FAMILIES}")
    stacks = _stacks(cfg)
    known = {"embed", "head", "final_norm", *stacks}
    if cfg.family == "hybrid":
        known.add("rem_layers")
    if cfg.family == "encdec":
        known.add("enc_norm")
    unknown = sorted(set(tree) - known)
    if unknown:
        raise ValueError(f"keys {unknown} are no part of a {cfg.family!r} "
                         f"model's parameters {sorted(known)}")
    out = {k: _tensors(v, device) for k, v in tree.items()}
    for name, n in stacks.items():
        out[name] = _unstack(out[name], n, name)
    return out


def _stack(trees: list):
    """A list of congruent trees as one tree of stacked ``[n, ...]`` numpy
    leaves (the inverse of :func:`_unstack`)."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([t[i] for t in trees]) for i in range(len(first)))
    return np.stack([_array(t) for t in trees])


def _array(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _arrays(tree):
    if isinstance(tree, Mapping):
        return {k: _arrays(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_arrays(v) for v in tree)
    return _array(tree)


def model_params_to_arrays(cfg: ModelConfig, params: Mapping) -> dict:
    """The reference's ``Model.init`` layout of the port's parameters (or
    of a tree shaped as them, such as their gradients): numpy leaves, each
    per-layer list stacked into ``[L, ...]`` (the hybrid's units tuple by
    tuple), the other keys as they are.  The inverse of
    :func:`model_params_from_arrays`; bfloat16 leaves come back as
    float32."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is none of {FAMILIES}")
    stacks = _stacks(cfg)
    out = {}
    for k, v in params.items():
        if k in stacks:
            if len(v) != stacks[k]:
                raise ValueError(f"{k}: {len(v)} layers, the config has "
                                 f"{stacks[k]}")
            out[k] = _stack(list(v))
        else:
            out[k] = _arrays(v)
    return out


def train_state_from_arrays(cfg: ModelConfig, state, device=None):
    """The port's ``TrainState`` from the reference's (``params``, ``opt``
    with ``m``, ``v`` and ``count``, and ``step``; numpy leaves, e.g.
    ``jax.tree.map(np.asarray, state)``): parameters and both moments
    through :func:`model_params_from_arrays`, the counts as int32
    scalars, all on ``device`` (None is the card)."""
    device = resolve_device(device)

    def count(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32,
                               device=device)

    return TrainState(
        params=model_params_from_arrays(cfg, state.params, device),
        opt=OptState(m=model_params_from_arrays(cfg, state.opt.m, device),
                     v=model_params_from_arrays(cfg, state.opt.v, device),
                     count=count(state.opt.count)),
        step=count(state.step))


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree

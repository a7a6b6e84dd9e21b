"""AdamW with global-norm clipping and a warmup + cosine schedule.

Port of the JAX package's ``optim/adamw.py`` over the port's parameter
trees (nested dicts, lists and tuples of tensors), with float32 moments and
the reference's arithmetic in its order.  One difference: :meth:`AdamW.
update` writes the new parameters and moments into the tensors it is given
(under ``torch.no_grad``) where the reference returns new arrays, so a
step holds one copy of the state, not two: at h2o-danube-1.8b's size the
float32 parameters and both moments are some 22 GB.

On ``DTensor`` parameters (``repro_torch.partition``) the moments inherit
each parameter's placements and the count is replicated on its mesh; the
update is the same arithmetic on each rank's shards.

Where the leaves lie decides the path, with no fallback between them: CPU
tensors take the plain loop over the leaves (``kernels.adamw.
update_plain``); CUDA tensors, or a ``DTensor``'s local CUDA shards, the
multi-tensor kernel ``csrc/adamw.cu`` (``kernels/adamw.py``): the per-leaf
sums of squares in two launches, the scalar prologue in torch on the card,
then the update of every leaf in one launch, bit-equal to the plain loop
for the same scalars.  Fake and ``meta`` tensors take the kernel's custom
ops, which launch nothing (the dry-run).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch import partition
from repro_torch.kernels import OP_DEVICES
from repro_torch.kernels import adamw as kernel


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor  # int32 step counter


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """lr(step) as a float32 tensor: linear warmup, then cosine decay to
    ``min_frac * base_lr``."""

    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr


def _local(x) -> torch.Tensor:
    return x.to_local() if partition.is_dtensor(x) else x


def _mesh_key(x) -> tuple:
    """The mesh dims (of more than one rank) that shard a ``DTensor`` leaf;
    () for a plain tensor or a replicated one."""
    if not partition.is_dtensor(x):
        return ()
    mesh = x.device_mesh
    return tuple((mesh, i) for i, p in enumerate(x.placements)
                 if not p.is_replicate() and mesh.size(i) > 1)


def _gradients(leaves) -> tuple:
    """(fused, mesh keys, local tensors) of gradient leaves.  ``fused``:
    they go to the kernel's ops (CUDA tensors, or the fake or meta tensors
    of a trace), and their local tensors are then contiguous."""
    local = [_local(x) for x in leaves]
    fused = bool(local) and local[0].device.type in OP_DEVICES
    if fused:
        local = kernel.contiguous_grads(local)
    return fused, [_mesh_key(x) for x in leaves], local


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the sum of squares, in float32, as a
    plain tensor.  A ``DTensor`` leaf's squares are summed on its local
    shard, then over the mesh dims (of more than one rank) that shard it:
    a sharded leaf counts each element once across its shards, a
    replicated one once in all.  The leaves' sums add within each set of
    such dims (in leaf order on the CPU; on the card as the kernel's
    vector of per-leaf sums), and one all-reduce a mesh dim sums the
    sets."""
    return _global_norm(*_gradients(pytree.tree_leaves(tree)))


def _global_norm(fused: bool, keys, local) -> torch.Tensor:
    """:func:`global_norm` of what :func:`_gradients` returns."""
    groups = {}
    for i, key in enumerate(keys):
        groups.setdefault(key, []).append(i)
    sums = {}
    if fused:
        order = [i for idx in groups.values() for i in idx]
        sq = kernel.sq_norms_cuda([local[i] for i in order])
        parts = ([sq] if len(groups) == 1
                 else torch.split(sq, [len(idx) for idx in groups.values()]))
        sums = {key: part.sum() for key, part in zip(groups, parts)}
    else:
        for key, idx in groups.items():
            for s in kernel.sq_norms_plain([local[i] for i in idx]):
                sums[key] = s if key not in sums else sums[key] + s
    total = 0
    for key, s in sums.items():
        if key:
            import torch.distributed as dist
            s = s.clone()
            for mesh, i in key:
                dist.all_reduce(s, group=mesh.get_group(i))
        total = total + s
    return torch.sqrt(total)


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Any = 3e-4      # float or callable(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> OptState:
        zeros = pytree.tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        first = pytree.tree_leaves(params)[0]
        count = torch.zeros((), dtype=torch.int32, device=first.device)
        if partition.is_dtensor(first):
            from torch.distributed.tensor import Replicate, distribute_tensor
            mesh = first.device_mesh
            count = distribute_tensor(count, mesh, [Replicate()] * mesh.ndim)
        return OptState(m=zeros, v=pytree.tree_map(torch.clone, zeros),
                        count=count)

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        """Returns (new_params, new_state, metrics): ``params``, ``state.m``
        and ``state.v`` updated in place, and the new count."""
        count = state.count + 1
        flat_g, flat_m, flat_v, flat_p = (pytree.tree_leaves(t) for t in (
            grads, state.m, state.v, params))
        if not len(flat_g) == len(flat_m) == len(flat_v) == len(flat_p):
            raise ValueError("grads, moments and params are different trees")
        fused, keys, local_g = _gradients(flat_g)
        gnorm = _global_norm(fused, keys, local_g)
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
        lr = (self.learning_rate(count) if callable(self.learning_rate)
              else torch.tensor(self.learning_rate, dtype=torch.float32))
        lr = lr.to(gnorm.device)
        c = count.float()
        bc1 = 1.0 - self.b1 ** c
        bc2 = 1.0 - self.b2 ** c
        hyper = dict(b1=self.b1, b2=self.b2, eps=self.eps,
                     wd=self.weight_decay)
        if fused:
            one = torch.ones((), dtype=torch.float32, device=gnorm.device)
            scalars = torch.stack([_local(x).float() for x in (
                one if scale is None else scale, lr, bc1, bc2)])
            kernel.update_cuda(local_g, [_local(p) for p in flat_p],
                               [_local(m) for m in flat_m],
                               [_local(v) for v in flat_v], scalars, **hyper)
        else:
            kernel.update_plain(flat_g, flat_p, flat_m, flat_v, scale, lr,
                                bc1, bc2, **hyper)
        return params, OptState(state.m, state.v, count), {
            "grad_norm": gnorm, "lr": lr}

"""Logical-axis partitioning on a torch ``DeviceMesh``.

Port of the JAX package's ``partition.py``.  Model code annotates every
parameter and key activation with *logical* axis names ("embed", "heads",
"ff", "vocab", "batch", ...).  A launcher binds a :class:`Rules` context
that maps logical names onto the mesh's dimensions; with no context bound
(unit tests, one-device runs) every annotation is a no-op and costs
nothing.

XLA partitions the reference's programs from its constraints; torch has no
such partitioner, so the port makes the layout explicit:

* **Weights are stored sharded**: ``DTensor`` leaves with the rules'
  placements (``embed`` over the data axis, FSDP; ``heads``/``ff``/
  ``vocab``/``expert``/``inner`` over the model axis).  Each weight is
  gathered where it is used by :func:`wcast`, which casts the local shard
  first, so an FSDP gather moves bfloat16 (the reference's §Perf H5);
  autograd sends each rank's gradient of the gathered weight back through
  a reduce-scatter to the weight's own placement.
* **Activations are plain local tensors**: each rank holds its shard of the
  batch on the batch axes (:func:`shard_batch`) and the whole of every
  other dimension, so :func:`constrain` on a plain tensor only checks its
  rank.
* **Only the decode cache is compute-sharded**: its ``cache_seq`` dimension
  is split over the model axis, and ``models/attention.py`` combines the
  shards' partial softmaxes with explicit collectives (flash-decode).

The results are the same numbers as one device.  GSPMD's compute sharding
on the model axis (heads and ff split across ranks inside the matmuls) has
no counterpart here.

Default rule tables:

* ``fsdp``  - parameter ``embed`` dims shard over the data axis (ZeRO-3
  style), ``heads``/``ff``/``vocab``/``expert``/``inner`` over the model
  axis, decode caches shard their sequence dim over the model axis.
* ``replicated`` - parameters replicated, only batch sharded (pure DP).
* ``serve`` - ``fsdp`` with ``embed`` replicated and ``kv`` on the model
  axis.

``torch.distributed.tensor`` is imported where a mesh is first used, not
with this module, so a run without rules never loads it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import sys
from typing import Any, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.utils import _pytree as pytree

MeshAxes = Union[None, str, Tuple[str, ...]]

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("partition_rules",
                                                         default=None)


def _dtensor_type():
    """``DTensor`` if ``torch.distributed.tensor`` is loaded, else None (no
    DTensor can exist then)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor


def is_dtensor(x: Any) -> bool:
    cls = _dtensor_type()
    return cls is not None and isinstance(x, cls)


def _names(axes: MeshAxes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Sharding(NamedTuple):
    """Where a tensor lives on a mesh: the twin of ``NamedSharding``, for
    ``distribute_tensor`` and ``redistribute``."""
    mesh: Any
    placements: tuple


@dataclasses.dataclass(frozen=True)
class Rules:
    """A binding of logical axis names to mesh dimensions for one mesh."""

    mesh: Any                      # torch DeviceMesh (or a duck-typed one)
    table: Mapping[str, MeshAxes]

    def axis(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        return self.table.get(name)

    def spec(self, axes: Sequence[Optional[str]]) -> tuple:
        """One entry per tensor dim: a mesh-dim name, a tuple of them, or
        None; entry for entry the reference's ``PartitionSpec``."""
        return tuple(self.axis(a) for a in axes)

    def placements(self, axes: Sequence[Optional[str]]) -> tuple:
        """One ``Shard(dim)`` / ``Replicate()`` per mesh dim: mesh dim ``i``
        shards the tensor dim whose logical axis maps to it."""
        from torch.distributed.tensor import Replicate, Shard
        names = self.mesh.mesh_dim_names
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec(axes)):
            for name in _names(entry):
                i = names.index(name)
                if out[i] != Replicate():
                    raise ValueError(f"mesh dim {name!r} shards two dims of "
                                     f"a tensor annotated {tuple(axes)}")
                out[i] = Shard(dim)
        return tuple(out)

    def sharding(self, axes: Sequence[Optional[str]]) -> Sharding:
        return Sharding(self.mesh, self.placements(axes))

    def size(self, name: Optional[str]) -> int:
        """How many shards the logical axis ``name`` is split into."""
        n = 1
        for mesh_name in _names(self.axis(name)):
            n *= _mesh_size(self.mesh, mesh_name)
        return n

    def index(self, name: Optional[str]) -> int:
        """This rank's shard of the logical axis ``name`` (row-major over
        its mesh dims)."""
        i = 0
        for mesh_name in _names(self.axis(name)):
            i = (i * _mesh_size(self.mesh, mesh_name)
                 + self.mesh.get_local_rank(mesh_name))
        return i


def _mesh_size(mesh, name: str) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(name))


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    token = _ACTIVE.set(rules)
    try:
        yield rules
    finally:
        _ACTIVE.reset(token)


def current_rules() -> Optional[Rules]:
    return _ACTIVE.get()


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """The layout of ``x`` by logical axes; ``x`` itself without rules.
    Under rules a DTensor is redistributed to the rules' placements and a
    plain tensor (an activation: this rank's shard of the batch) is
    returned as it is, once its rank is checked."""
    rules = current_rules()
    if rules is None:
        return x
    if x.ndim != len(axes):
        raise ValueError(f"rank {x.ndim} tensor annotated with {tuple(axes)}")
    if is_dtensor(x):
        return x.redistribute(rules.mesh, rules.placements(axes))
    return x


def gather(x: torch.Tensor) -> torch.Tensor:
    """The whole of ``x`` on this rank, as a plain tensor: a DTensor is
    all-gathered, and its gradient flows back as each rank's partial sum,
    reduce-scattered to the DTensor's placements; anything else is
    returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate
    n = x.device_mesh.ndim
    return x.redistribute(x.device_mesh, [Replicate()] * n).to_local(
        grad_placements=[Partial()] * n)


def wcast(x: torch.Tensor, dtype,
          axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Cast a weight to the compute dtype, then gather it for use (§Perf
    H5): on a DTensor the cast runs on each rank's local shard, so the
    gather moves ``dtype`` and not float32.  Without rules, the cast."""
    if current_rules() is not None and x.ndim != len(axes):
        raise ValueError(f"rank {x.ndim} tensor annotated with {tuple(axes)}")
    return gather(x.to(dtype))


# ---------------------------------------------------------------------------
# Standard rule tables.
# ---------------------------------------------------------------------------


def batch_axes_for(mesh, global_batch: int) -> MeshAxes:
    """The largest prefix of the mesh's batch axes that divides the batch.

    ``long_500k`` runs at global batch 1 - its batch stays replicated; every
    other assigned shape divides the full ("pod", "data") product.
    """
    names = list(mesh.mesh_dim_names)
    candidates = [a for a in ("pod", "data") if a in names]
    chosen = []
    size = 1
    for a in candidates:
        nxt = size * mesh.size(names.index(a))
        if global_batch % nxt == 0:
            chosen.append(a)
            size = nxt
        else:
            break
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


def fsdp_rules(mesh, global_batch: int, *,
               shard_cache_seq: bool = True) -> Rules:
    """The production table: DP/FSDP over data (and pod), storage sharding
    and the decode cache over model."""
    batch = batch_axes_for(mesh, global_batch)
    table = {
        # activations
        "batch": batch,
        "seq": None,
        "act_embed": None,
        "cache_seq": "model" if shard_cache_seq else None,
        # parameters
        "embed": "data",
        "heads": "model",   # fused q-heads dim (H * head_dim)
        "kv": None,         # kv-heads replicated across model (GQA kv < 16)
        "ff": "model",
        "vocab": "model",
        "expert": "model",     # MoE expert dim (EP)
        "expert_ff": None,     # per-expert ff (expert dim already on model)
        "inner": "model",      # SSM / RG-LRU inner width
        "layers": None,
    }
    return Rules(mesh=mesh, table=table)


def replicated_rules(mesh, global_batch: int) -> Rules:
    """Pure data parallelism: parameters replicated, batch sharded."""
    batch = batch_axes_for(mesh, global_batch)
    table = {k: None for k in fsdp_rules(mesh, global_batch).table}
    table["batch"] = batch
    return Rules(mesh=mesh, table=table)


def serve_rules(mesh, global_batch: int) -> Rules:
    """Serving table (§Perf H3): the ``embed`` dim replicated across data
    instead of FSDP-sharded, and the kv projections sharded over model as
    a tensor dim."""
    rules = fsdp_rules(mesh, global_batch)
    table = dict(rules.table)
    table["embed"] = None
    table["kv"] = "model"
    return Rules(mesh=mesh, table=table)


def is_axes(x: Any) -> bool:
    """True for a logical-axes tuple leaf: a plain tuple of str/None entries
    (empty tuple = scalar).  NamedTuples (TrainState etc.) are containers."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(a is None or isinstance(a, str) for a in x))


def param_shardings(rules: Optional[Rules], axes_tree: Any):
    """Map a tree of logical-axes tuples to :class:`Sharding`s (or None)."""
    if rules is None:
        return pytree.tree_map(lambda _: None, axes_tree, is_leaf=is_axes)
    return pytree.tree_map(rules.sharding, axes_tree, is_leaf=is_axes)


def place(tree: Any, shardings: Any, *, local: bool = False):
    """``tree`` with each tensor leaf distributed to its :class:`Sharding`
    in the congruent tree ``shardings`` (matched by key; a None leaf keeps
    its tensor); every rank passes the whole tensor, and rank 0's values
    are sent to every rank.  With ``local`` each rank cuts its shard from
    its own tensor and nothing is sent (a trace's fake tensors)."""
    from torch.distributed.tensor import distribute_tensor
    src = None if local else 0

    def one(t, s):
        if s is None:
            return t
        return distribute_tensor(t, s.mesh, list(s.placements),
                                 src_data_rank=src)

    return pytree.tree_map(one, tree, shardings)


def shard_batch(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch ``x`` under the current rules
    (contiguous blocks over the ``batch`` axis's mesh dims); ``x`` itself
    without rules or with the batch replicated."""
    rules = current_rules()
    if rules is None:
        return x
    n = rules.size("batch")
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} rows over {n} shards")
    rows = x.shape[0] // n
    i = rules.index("batch")
    return x[i * rows:(i + 1) * rows]


class _GroupSum(torch.autograd.Function):
    """The sum over process groups, whose gradient is the same sum of the
    ranks' gradients."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed as dist
        ctx.groups = groups
        x = x.clone()
        for group in groups:
            dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _GroupSum.apply(grad, ctx.groups), None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the shards of the batch, where each rank's
    ``x`` is a mean over its own rows (as many on every rank), with its
    gradient: what a mean over the whole batch is on one device.  ``x``
    without rules or with the batch whole."""
    rules = current_rules()
    if rules is None or rules.size("batch") == 1:
        return x
    groups = [rules.mesh.get_group(name)
              for name in _names(rules.axis("batch"))]
    return _GroupSum.apply(x, groups) / rules.size("batch")


def mesh_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over every rank of the current rules' mesh, in
    place (a plain tensor); ``x`` without rules."""
    import torch.distributed as dist
    rules = current_rules()
    if rules is None:
        return x
    for i in range(rules.mesh.ndim):
        if rules.mesh.size(i) > 1:
            dist.all_reduce(x, group=rules.mesh.get_group(i))
    return x

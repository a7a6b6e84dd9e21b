"""Logical-axis partitioning on a torch ``DeviceMesh``.

Port of the JAX package's ``partition.py``.  Model code annotates every
parameter and key activation with *logical* axis names ("embed", "heads",
"ff", "vocab", "batch", ...).  A launcher binds a :class:`Rules` context
that maps logical names onto the mesh's dimensions; with no context bound
(unit tests, one-device runs) every annotation is a no-op and costs
nothing.

XLA partitions the reference's programs from its constraints (GSPMD); torch
has no such partitioner, so the port writes the layout out, as Megatron-LM
does it (Shoeybi et al., arXiv:1909.08053, section 3):

* **Weights are stored sharded**: ``DTensor`` leaves with the rules'
  placements (``embed`` over the data axis, FSDP; ``heads``/``ff``/
  ``vocab``/``expert``/``inner`` over the model axis).  :func:`wcast`
  casts a weight (the local shard first, so an FSDP gather moves bfloat16,
  the reference's §Perf H5) and gathers it whole; :func:`wshard`, its
  sibling for sharded compute, gathers only the mesh dims that do not
  split the block's axis and keeps this rank's model-axis shard local.
  Autograd sends each rank's gradient back to the weight's own placement
  (a reduce-scatter over the data axis).
* **Each model-axis rank computes its share**: its query heads, ff
  columns, vocab slice, experts and SSM / RG-LRU inner channels
  (:func:`shard_of`'s :class:`Share`: whole heads and experts), between
  the two conjugate functions :func:`copy_to_model` (identity forward,
  all-reduce backward; in front of a column-parallel product) and
  :func:`reduce_from_model` (all-reduce forward, identity backward), whose
  :func:`row_parallel` sums a row-parallel product's float32 partials and
  rounds once.  The residual stream stays whole on every model rank (no
  sequence parallelism).  A block whose dim the model axis does not
  divide repeats the whole compute on every rank with gathered weights,
  as GSPMD pads or replicates; each such call is counted in
  ``Rules.repeats``.  Each block has one body: on a whole share every
  function that takes it is the one-device operation.
* **Activations are plain local tensors**: each rank holds its shard of the
  batch on the batch axes (:func:`shard_batch`), so :func:`constrain` on
  a plain tensor only checks its rank.
* **The decode cache is sharded on its positions**: ``cache_seq`` over the
  model axis, and ``models/attention.py`` combines the shards' partial
  softmaxes with explicit collectives (flash-decode).

Gradients are partial sums over the mesh dims that split the batch (and
over every dim without a model-axis split); on the model axis a weight that
every rank uses whole has the same gradient on each rank, and a shard its
own.  The loss is one value shared by the model-axis ranks.  Without rules,
or with a model axis of one rank, every function here returns its input
and the numbers are one device's, bit for bit.

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
from typing import (Any, Dict, Mapping, NamedTuple, Optional, Sequence,
                    Tuple, Union)

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
    #: Calls of a block that repeated its whole compute on every model-axis
    #: rank because the axis does not divide its dim, by block
    #: (:func:`shard_of`); the dry-run reads it.
    repeats: Dict[str, int] = dataclasses.field(default_factory=dict,
                                                compare=False)

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

    def local_slice(self, name: Optional[str], n: int,
                    unit: int = 1) -> Optional[Tuple[int, int]]:
        """(start, stop) of this rank's share of a dim of ``n`` elements
        split over the logical axis ``name``, in whole ``unit``-element
        groups (heads, experts); None when those groups do not split
        evenly."""
        k = self.size(name)
        if n % unit or (n // unit) % k:
            return None
        step = n // k
        i = self.index(name)
        return i * step, (i + 1) * step


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


def recompute_context():
    """``torch.utils.checkpoint``'s ``context_fn``: the recompute of a
    checkpointed block runs under the rules bound at its forward.  The
    autograd engine runs a CUDA backward, and so the recompute, on its own
    device thread, which does not see the caller's context."""
    return contextlib.nullcontext(), use_rules(current_rules())


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


#: The logical axes whose shards a model-axis rank computes on its own.
MODEL_AXES = ("heads", "kv", "ff", "vocab", "expert", "inner")


def _split_dims(rules: Rules, names: Sequence[str]) -> Tuple[str, ...]:
    """The mesh dims of more than one rank that the logical axes ``names``
    map to, in mesh order."""
    dims = {d for a in names for d in _names(rules.axis(a))
            if _mesh_size(rules.mesh, d) > 1}
    return tuple(d for d in rules.mesh.mesh_dim_names if d in dims)


def grad_dims() -> Tuple[str, ...]:
    """The mesh dims over which gradients are partial sums: every dim of
    more than one rank but those the model axis's split maps to (there
    each rank's gradient is whole or its own shard's).  () without
    rules."""
    rules = current_rules()
    if rules is None:
        return ()
    model = _split_dims(rules, MODEL_AXES)
    return tuple(d for d in rules.mesh.mesh_dim_names
                 if d not in model and _mesh_size(rules.mesh, d) > 1)


def grad_ranks() -> int:
    """How many ranks' gradients of one weight sum to the batch's: the
    size of :func:`grad_dims`."""
    rules = current_rules()
    n = 1
    for d in grad_dims():
        n *= _mesh_size(rules.mesh, d)
    return n


class Share(NamedTuple):
    """This rank's part ``[lo, hi)`` of a dim annotated with the logical
    axis ``name`` (:func:`shard_of`), and the process groups of the mesh
    dims that split it, last mesh dim first (the row-major order of
    :meth:`Rules.index`).  ``groups`` is empty where every rank computes
    the whole dim: without rules, with ``name`` whole, or where the split
    does not divide it (a repeat).  Every function here that takes a share
    is then the one-device operation, so each block has one body."""
    name: str
    lo: int
    hi: int
    groups: tuple = ()

    @property
    def split(self) -> bool:
        return bool(self.groups)


def shard_of(name: str, n: int, block: Optional[str] = None,
             unit: int = 1) -> Share:
    """This rank's :class:`Share` of the ``n`` elements of a dim annotated
    ``name``: split where the current rules split ``name`` over more than
    one rank evenly in whole ``unit``-element groups (heads, experts),
    else whole; a split that does not divide counts a repeat of ``block``
    (if given) in ``Rules.repeats``."""
    rules = current_rules()
    dims = () if rules is None else _split_dims(rules, (name,))
    if dims:
        part = rules.local_slice(name, n, unit)
        if part is not None:
            return Share(name, *part, tuple(rules.mesh.get_group(d)
                                            for d in reversed(dims)))
        if block is not None:
            count_repeat(block)
    return Share(name, 0, n)


def count_repeat(block: str) -> None:
    """Count one call of ``block`` that repeats its whole compute on every
    model-axis rank in the current rules' ``repeats`` (a split
    :func:`shard_of` cannot see is uneven, such as query heads that would
    straddle kv groups)."""
    rules = current_rules()
    rules.repeats[block] = rules.repeats.get(block, 0) + 1


def gather(x: torch.Tensor, *, sliced: bool = False) -> torch.Tensor:
    """The whole of ``x`` on this rank, as a plain tensor: a DTensor is
    all-gathered, and anything else returned as it is.  The gradient flows
    back to the DTensor's placements as a partial sum over the
    :func:`grad_dims`; over the model axis's dims it is the same on every
    rank (each computes the same with ``x``), unless ``sliced`` says that
    each rank uses its own part of ``x`` (then a partial sum there too)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate
    mesh = x.device_mesh
    rules = current_rules()
    same = () if rules is None or sliced else _split_dims(rules, MODEL_AXES)
    grads = [Replicate() if d in same else Partial()
             for d in mesh.mesh_dim_names]
    return x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grads)


def wcast(x: torch.Tensor, dtype, axes: Sequence[Optional[str]], *,
          sliced: bool = False) -> torch.Tensor:
    """Cast a weight to the compute dtype, then gather it whole for use
    (§Perf H5): on a DTensor the cast runs on each rank's local shard, so
    the gather moves ``dtype`` and not float32.  ``sliced``: each rank
    uses its own columns of the whole (:func:`gather`).  Without rules,
    the cast."""
    if current_rules() is not None and x.ndim != len(axes):
        raise ValueError(f"rank {x.ndim} tensor annotated with {tuple(axes)}")
    return gather(x.to(dtype), sliced=sliced)


def wshard(x: torch.Tensor, dtype, axes: Sequence[Optional[str]],
           share: Share) -> torch.Tensor:
    """The sibling of :func:`wcast` for sharded compute: cast, then gather
    only the mesh dims that do not split the logical axis ``share.name``
    (the FSDP gather over data), keeping this rank's shard of the tensor
    dim annotated so local, as a plain tensor.  Its gradient is that
    shard's, a partial sum over the other dims.  A plain tensor under
    rules is sliced to the shard.  :func:`wcast` where ``share`` is
    whole."""
    if not share.split:
        return wcast(x, dtype, axes)
    if x.ndim != len(axes):
        raise ValueError(f"rank {x.ndim} tensor annotated with {tuple(axes)}")
    rules = current_rules()
    name = share.name
    dims = _split_dims(rules, (name,))
    dim = list(axes).index(name)
    x = x.to(dtype)
    if not is_dtensor(x):
        lo, hi = rules.local_slice(name, x.shape[dim])
        return x.narrow(dim, lo, hi - lo)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    return x.redistribute(
        mesh, [Shard(dim) if d in dims else Replicate() for d in names]
    ).to_local(grad_placements=[Shard(dim) if d in dims else Partial()
                                for d in names])


def _all_reduce(x: torch.Tensor, groups, op=None) -> torch.Tensor:
    """The reduction of ``x`` over ``groups`` (a sum by default), a new
    tensor; a bfloat16 sum is taken in float32 and rounded once (which
    moves twice GSPMD's bytes; on two ranks it is bfloat16's own sum, bit
    for bit)."""
    import torch.distributed as dist
    dtype = x.dtype
    x = x.float() if op is None and dtype == torch.bfloat16 else x.clone()
    for group in groups:
        if op is None:
            dist.all_reduce(x, group=group)
        else:
            dist.all_reduce(x, op=op, group=group)
    return x.to(dtype)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model axis."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.groups), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model axis forward; identity backward."""

    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherModel(torch.autograd.Function):
    """The shards of the model axis concatenated along ``dim``; the
    gradient of this rank's shard is its part of the ranks' summed
    gradients."""

    @staticmethod
    def forward(ctx, x, dim, groups):
        import torch.distributed as dist
        ctx.dim, ctx.groups, ctx.n = dim, groups, x.shape[dim]
        for group in groups:
            parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
                group))]
            dist.all_gather(parts, x.contiguous(), group=group)
            x = torch.cat(parts, dim=dim)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = _all_reduce(grad, ctx.groups)
        i = _group_index(ctx.groups)
        return grad.narrow(ctx.dim, i * ctx.n, ctx.n), None, None


def _group_index(groups) -> int:
    """This rank's place in the product of ``groups`` (the row-major order
    in which :class:`_GatherModel` concatenates)."""
    import torch.distributed as dist
    i, scale = 0, 1
    for group in groups:           # last mesh dim first
        i += dist.get_rank(group) * scale
        scale *= dist.get_world_size(group)
    return i


def copy_to_model(x: torch.Tensor, share: Share) -> torch.Tensor:
    """``x`` (whole on every rank of the model axis that splits
    ``share``) in front of a column-parallel product: identity forward,
    the gradient all-reduced over that axis backward."""
    return _CopyToModel.apply(x, share.groups) if share.split else x


def reduce_from_model(x: torch.Tensor, share: Share) -> torch.Tensor:
    """The sum of each rank's ``x`` over the model axis that splits
    ``share``, after a row-parallel product: all-reduce forward, identity
    backward (every rank then computes the same with the sum)."""
    return _ReduceFromModel.apply(x, share.groups) if share.split else x


def model_max(x: torch.Tensor, share: Share) -> torch.Tensor:
    """The largest of each rank's ``x`` over the model axis that splits
    ``share``, without a gradient (a softmax's shift)."""
    import torch.distributed as dist
    x = x.detach()
    return _all_reduce(x, share.groups, dist.ReduceOp.MAX) if share.split \
        else x


def _product_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with a float32 result: on the card one ``torch.mm`` of
    the operands' own dtype into a float32 output (the tensor cores'
    accumulator, unrounded) where ``w`` is a matrix, else the operands
    cast to float32 (exact for bfloat16)."""
    if x.device.type == "cuda" and w.ndim == 2:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


class _RowParallel(torch.autograd.Function):
    """``x @ w`` of this rank's rows of ``w`` (its columns of ``x``),
    summed over the model axis in float32 and rounded once to ``x``'s
    dtype, as one device's product rounds its accumulator once; the
    backward is the product's own, in ``x``'s dtype.  Partials rounded to
    bfloat16 before they meet, as GSPMD's are, move the residual stream
    by a bfloat16 step: a reduced moonshot's two steps on (2, 2) then put
    its layer-1 router's AdamW change at cosine 0.981 with one device's
    (0.997 with float32 partials), its first-step gradient at 0.9987."""

    @staticmethod
    def forward(ctx, x, w, groups):
        ctx.save_for_backward(x, w)
        return _all_reduce(_product_f32(x, w), groups).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = dy @ w.transpose(-1, -2)
        if w.ndim == 2:
            dw = (x.reshape(-1, x.shape[-1]).T
                  @ dy.reshape(-1, dy.shape[-1]))
        else:
            dw = x.transpose(-1, -2) @ dy
        return dx, dw.to(w.dtype), None


def row_parallel(x: torch.Tensor, w: torch.Tensor,
                 share: Share) -> torch.Tensor:
    """The row-parallel product ``x @ w`` of this rank's part of
    ``share`` (``x``'s last dim, ``w``'s rows; ``w`` a matrix, or a batch
    of them beside a batched ``x``), summed over the model axis: the
    partial products meet in float32 and are rounded once (the all-reduce
    moves float32).  ``x @ w`` where ``share`` is whole."""
    if not share.split:
        return x @ w
    return _RowParallel.apply(x, w, share.groups)


def model_sum(x: torch.Tensor, share: Share) -> torch.Tensor:
    """The sum of each rank's ``x`` over the model axis that splits
    ``share``, where each rank goes on with its own part's compute: an
    all-reduce both ways (a gated norm's sum of squares)."""
    return _GroupSum.apply(x, share.groups) if share.split else x


def gather_model(x: torch.Tensor, dim: int, share: Share) -> torch.Tensor:
    """This rank's part ``x`` of ``share`` and the other model-axis
    ranks', concatenated along ``dim`` (an all-gather; its gradient is
    reduce-scattered back)."""
    if not share.split:
        return x
    return _GatherModel.apply(x, dim % x.ndim, share.groups)


def columns(t: torch.Tensor, cols: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The last dim's (start, stop) ranges ``cols`` side by side; ``t``
    itself where they tile it in order."""
    ends = [0] + [b for _, b in cols]
    if all(a == e for (a, _), e in zip(cols, ends)) \
            and ends[-1] == t.shape[-1]:
        return t
    return torch.cat([t[..., a:b] for a, b in cols], dim=-1)


def fused_product(x: torch.Tensor, w: torch.Tensor, dtype,
                  axes: Sequence[Optional[str]], share: Share,
                  cols: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """This rank's column ranges ``cols`` (start, stop) of ``x @ w``, side
    by side, where ``w``'s last dim, annotated ``share.name``, is a fused
    one (the MLP's ``[gate | up]``, mamba2's ``in_proj``) stored split
    over the model axis in blocks that do not follow its parts, so a
    rank's columns lie in other ranks' blocks.  Without a gradient and
    with fewer rows in ``x`` than ``w`` has (a decode step), each rank
    multiplies by its own stored block and the products are gathered over
    the axis: activations move.  Else ``w`` is gathered whole and the
    columns taken: the weight moves, and its gradient is reduce-scattered
    back (the products' gradient would be all-reduced whole).  The caller
    puts ``x`` through :func:`copy_to_model`.  ``x @ w`` where ``share``
    is whole (``cols`` tile ``w``)."""
    if not share.split:
        return x @ columns(wcast(w, dtype, axes), cols)
    rows = x.numel() // x.shape[-1]
    stored = shard_of(share.name, w.shape[-1])
    if not x.requires_grad and rows < w.shape[0] and stored.split:
        y = gather_model(x @ wshard(w, dtype, axes, stored), -1, stored)
        return columns(y, cols)
    return x @ columns(wcast(w, dtype, axes, sliced=True), cols)


def argmax_sharded(x: torch.Tensor, share: Share) -> torch.Tensor:
    """``torch.argmax(whole, -1)`` of the rows whose columns ``share``
    this rank holds as ``x``: the largest value over the shards, then the
    smallest global index that holds it, so that ties break as
    ``torch.argmax`` on the whole row does."""
    import torch.distributed as dist
    idx = torch.argmax(x, dim=-1)
    if not share.split:
        return idx + share.lo
    val = torch.gather(x, -1, idx[..., None])[..., 0]
    best = _all_reduce(val, share.groups, dist.ReduceOp.MAX)
    cand = torch.where(val == best, idx + share.lo,
                       torch.full_like(idx, torch.iinfo(idx.dtype).max))
    return _all_reduce(cand, share.groups, dist.ReduceOp.MIN)


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


def mesh_sum(x: torch.Tensor,
             dims: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The sum of ``x`` over every rank of the current rules' mesh (or
    over its mesh dims ``dims``), in place (a plain tensor); ``x`` without
    rules."""
    import torch.distributed as dist
    rules = current_rules()
    if rules is None:
        return x
    names = rules.mesh.mesh_dim_names
    for i in range(rules.mesh.ndim):
        if rules.mesh.size(i) > 1 and (dims is None or names[i] in dims):
            dist.all_reduce(x, group=rules.mesh.get_group(i))
    return x
